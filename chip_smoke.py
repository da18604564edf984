#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line of numbers; any failure exits non-zero):
  1. device   - requires CUDA; prints the card's name and power limit
  2. build    - compiles both hand-written kernels with nvcc (sm_90a)
  3. K1       - bilateral kernel vs its plain PyTorch version on a
                480x640 depth image with holes and a depth step
  4. K2       - TSDF voxel-update kernel vs its plain version at
                S = 16384 slots, U = 1024 lanes: +1 from an empty volume,
                -1 on a pre-integrated volume, and depth only
  5. slice    - the ground-truth-pose main path at the bench's size
                (after a 10-frame warm-up through a throwaway volume):
                120 VGA frames of the 360-degree loop in the bench room,
                2 cm voxels, rendered on the GPU with sensor noise, packed,
                preprocessed (K1), integrated into TSDFVolume (K2),
                meshed every 10 frames and exported as PLY; map error
                against the analytic scene and launch counts
  6. small    - the same path on a 160x120 input, GPU kernels against
                the CPU's plain versions
  7. profile  - 20 slice frames under torch.profiler: device busy share
                and the device ops that take most of the time
The line before the last is a JSON object with each kernel's launches
in phase 5, its error against the plain version and both times; the last
line is {"ok": true, "device": {...}}.

Imports nothing of jax. Builds into texturefusion_torch/_build/.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K1_TOL = 1e-5
# test_pallas_voxel.py tolerances: (rtol, atol) per row array
K2_ROW_TOL = {"sdf": (1e-5, 1e-5), "weight": (1e-6, 1e-6),
              "color": (1e-4, 1e-3), "color_count": (1e-6, 1e-6)}
K2_Q_TOL = (1e-4, 1e-2)
MAP_MEDIAN_MM = 20.0      # below the 2 cm voxel (examples/demo_synthetic.py rule)
MAP_RMS_MM = 32.0         # the frozen map gate of tests/test_bench_regression.py


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int = 20, warm: int = 5) -> float:
    """Median of n CUDA-event timings of fn(), after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs CUDA: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"clocks.sm,clocks.max.sm,temperature.gpu={nvidia_smi('clocks.sm,clocks.max.sm,temperature.gpu')}")
    return smi


def nvidia_smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def phase_build():
    from texturefusion_torch.ops import cuda_kernels
    t0 = time.perf_counter()
    cuda_kernels.build(verbose=True)
    log(f"[build] nvcc {' '.join(cuda_kernels.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.2f} s")


def phase_k1():
    from texturefusion_torch.ops import cuda_kernels, preprocess
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)
    d[:, 320:] += 1.0                                  # a 1 m depth step
    d[rng.random(d.shape) < 0.05] = 0.0                # ~5% holes
    dev = torch.as_tensor(d, device="cuda")
    got = cuda_kernels.bilateral_cuda(dev)
    ref = preprocess.bilateral_filter_plain(dev)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    same_invalid = bool(((got == 0) == (ref == 0)).all())
    ms = cuda_ms(lambda: cuda_kernels.bilateral_cuda(dev))
    plain_ms = cuda_ms(lambda: preprocess.bilateral_filter_plain(dev))
    log(f"[k1] bilateral 480x640: max_abs_err={err:.3e} (tol {K1_TOL}) "
        f"invalid_match={same_invalid} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if not (err <= K1_TOL and same_invalid):
        raise AssertionError("K1 disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _k2_inputs(pre_integrated: bool, seed: int):
    """A noisy wall at z = 2 m before a VGA camera; 1008 listed chunks of
    2 cm voxels around it at random slots of S = 16384, 16 padding lanes."""
    from texturefusion_torch.config import CameraConfig, TSDFConfig
    from texturefusion_torch.core import camera as cam
    cfg = TSDFConfig(voxel_resolution=0.02, capacity=16384, max_update_chunks=1024)
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    s1, v, u = cfg.capacity + 1, 512, cfg.max_update_chunks
    rng = np.random.default_rng(seed)
    d = np.full((intr.height, intr.width), 2.0, np.float32)
    d += rng.normal(0, 0.02, d.shape).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    rgb = rng.random((intr.height, intr.width, 3)).astype(np.float32)
    quality = rng.random((intr.height, intr.width)).astype(np.float32)
    if pre_integrated:
        w = rng.integers(0, 4, (s1, v)).astype(np.float32)
        rows = [rng.normal(0, 0.05, (s1, v)).astype(np.float32), w,
                (rng.random((s1, v, 3)) * 90).astype(np.float32), w.copy()]
    else:
        rows = [np.full((s1, v), 999.0, np.float32), np.zeros((s1, v), np.float32),
                np.zeros((s1, v, 3), np.float32), np.zeros((s1, v), np.float32)]
    ids = np.asarray([(x, y, z) for x in range(-8, 8) for y in range(-5, 4)
                      for z in range(10, 17)], np.int32)
    n = len(ids)
    slots = rng.permutation(cfg.capacity)[:n]
    idx = np.concatenate([slots, np.full(u - n, cfg.capacity)]).astype(np.int64)
    origins = np.zeros((s1, 3), np.float32)
    origins[slots] = ids * (cfg.chunk_size * cfg.voxel_resolution)
    active = np.arange(u) < n
    c = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return (cfg, intr, [c(a) for a in rows], c(origins), c(idx), c(active), c(d),
            c(rgb), c(quality), torch.eye(4, device="cuda"), n)


def phase_k2():
    from texturefusion_torch.ops import tsdf
    worst = 0.0
    times = {}
    for name, sign, pre, with_color in (("plus_fresh", 1.0, False, True),
                                        ("minus_pre", -1.0, True, True),
                                        ("depth_only", 1.0, True, False)):
        cfg, intr, rows, origins, idx, active, d, rgb, q, pose, n = _k2_inputs(pre, 1)
        kb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        pb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        args = (origins, idx, active, d, rgb, q, pose, sign, intr, cfg)
        kq, ku = tsdf.integrate_frame_fused(kb, *args, with_color=with_color)
        pq, pu = tsdf.integrate_frame_fused_plain(pb, *args, with_color=with_color)
        torch.cuda.synchronize()
        errs = {}
        cap = cfg.capacity
        for (field, (rtol, atol)), a, b in zip(K2_ROW_TOL.items(), kb, pb):
            diff = (a[:cap] - b[:cap]).abs()
            errs[field] = float(diff.max())
            if not bool((diff <= atol + rtol * b[:cap].abs()).all()):
                raise AssertionError(f"K2 {name}: {field} disagrees (max {errs[field]:.3e})")
        q_err = float((kq[:n] - pq[:n]).abs().max())
        if with_color and not bool(((kq[:n] - pq[:n]).abs()
                                    <= K2_Q_TOL[1] + K2_Q_TOL[0] * pq[:n].abs()).all()):
            raise AssertionError(f"K2 {name}: quality disagrees (max {q_err:.3e})")
        if not bool((ku[:n] == pu[:n]).all()):
            raise AssertionError(f"K2 {name}: updated flags disagree")
        n_upd = int(ku[:n].sum())
        worst = max(worst, *errs.values())
        if name == "plus_fresh":
            times["ms"] = cuda_ms(lambda: tsdf.integrate_frame_fused(
                kb, *args, with_color=with_color))
            times["plain_ms"] = cuda_ms(lambda: tsdf.integrate_frame_fused_plain(
                pb, *args, with_color=with_color))
        log(f"[k2] {name} S={cfg.capacity} U={idx.numel()} active={n} updated={n_upd}: "
            + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
            + f" quality_err={q_err:.3e}")
        del kb, pb, rows
    log(f"[k2] timing plus_fresh: kernel_ms={times['ms']:.4f} plain_ms={times['plain_ms']:.4f}")
    return {"max_abs_err": worst, **times}


def _slice_config(small: bool):
    from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig
    if small:
        camera = CameraConfig(width=160, height=120, fx=131.25, fy=131.25, cx=79.5,
                              cy=59.5, far_plane=6.0, d0=-0.03, d1=0.005)
        return PipelineConfig(camera=camera, tsdf=TSDFConfig(
            voxel_resolution=0.05, capacity=2048, max_update_chunks=512))
    # bench.py's camera (mild Brown-Conrady distortion) and TSDF sizes
    return PipelineConfig(camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005),
                          tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                                          max_update_chunks=1024))


def _frames(config, n_frames, device):
    """bench.py's room and loop, rendered with depth noise
    N(0, 0.016)·max(d, 0.5) from default_rng(3), packed to uint8."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops.preprocess import pack_frame
    intr = cam.Intrinsics.from_config(config.camera)
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))
    poses = synthetic.loop_trajectory(n_frames, radius=1.5)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses, device=device)
    rng = np.random.default_rng(3)
    packed = []
    for d, c in zip(depths, rgbs):
        noise = rng.normal(0.0, 0.016, d.shape).astype(np.float32) * np.maximum(d, 0.5)
        dn = np.where(d > 0, d + noise, 0.0)
        packed.append(pack_frame((dn * config.camera.depth_scale).astype(np.uint16),
                                 (c * 255).astype(np.uint8)))
    return scene, poses, packed


def run_slice(config, scene, poses, packed, device, mesh_every=10):
    """The main path: preprocess → TSDFVolume.integrate_frame →
    IncrementalMesher.update_meshes → full_mesh. Returns (volume,
    mesh, stage seconds)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.fusion.mesher import IncrementalMesher
    from texturefusion_torch.ops import preprocess
    intr = cam.Intrinsics.from_config(config.camera)
    vol = TSDFVolume(config, device=device)
    mesher = IncrementalMesher(vol)
    stages = {"upload": 0.0, "preprocess": 0.0, "integrate": 0.0, "mesh": 0.0}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        stages[name] += time.perf_counter() - t0
        return out

    for i, (p, frame) in enumerate(zip(poses, packed)):
        fr = timed("upload", lambda: torch.as_tensor(frame).to(device))
        dep, _, qual, _, _, rgb = timed("preprocess", lambda: preprocess.preprocess_bundle(
            fr, None, intr, depth_scale=config.camera.depth_scale))
        timed("integrate", lambda: vol.integrate_frame(dep, rgb, qual, p, keyframe_id=i))
        if (i + 1) % mesh_every == 0 or i == len(poses) - 1:
            timed("mesh", mesher.update_meshes)
    mesh = timed("mesh", mesher.full_mesh)
    return vol, mesh, stages


def phase_slice(n_frames=120):
    from texturefusion_torch.io import ply
    from texturefusion_torch.ops import cuda_kernels
    config = _slice_config(small=False)
    t0 = time.perf_counter()
    scene, poses, packed = _frames(config, n_frames, "cuda")
    log(f"[slice] rendered {n_frames} frames {config.camera.width}x{config.camera.height} "
        f"on the GPU in {time.perf_counter() - t0:.2f} s")

    # the first pass through the path loads torch's CUDA kernels lazily and
    # sets up its libraries (seconds); it is set-up, not per-frame cost
    t0 = time.perf_counter()
    run_slice(config, scene, poses[:10], packed[:10], "cuda")
    torch.cuda.synchronize()
    log(f"[slice] warm-up: 10 frames through a throwaway volume in "
        f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vol, (verts, faces, colors, normals), stages = run_slice(config, scene, poses, packed,
                                                             "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fused.ply")
        ply.save_ply(path, verts, faces, colors, normals)
        v2, f2, _, _ = ply.load_ply(path)
        ply_bytes = os.path.getsize(path)
    err = scene.sdf(torch.as_tensor(verts, device="cuda")).abs().cpu().numpy().astype(
        np.float64)
    rms_mm = float(np.sqrt(np.mean(err ** 2)) * 1e3)
    med_mm = float(np.median(err) * 1e3)
    log(f"[slice] {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} frames/s "
        f"(clocks.sm,power.draw after: {nvidia_smi('clocks.sm,power.draw')}) "
        f"(upload {stages['upload']:.3f} s, preprocess {stages['preprocess']:.3f} s, "
        f"integrate {stages['integrate']:.3f} s, mesh {stages['mesh']:.3f} s)")
    log(f"[slice] chunks={vol.n_active()} verts={len(verts)} faces={len(faces)} "
        f"ply_bytes={ply_bytes} map_rms_mm={rms_mm:.3f} map_median_mm={med_mm:.3f} "
        f"launches={json.dumps(launches)} peak_mem_bytes={peak} "
        f"allocator={vol.alloc.kind}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if not (len(verts) > 0 and len(v2) == len(verts) and len(f2) == len(faces)):
        raise AssertionError("empty mesh or PLY round trip failed")
    if not (np.isfinite(verts).all() and med_mm < MAP_MEDIAN_MM and rms_mm <= MAP_RMS_MM):
        raise AssertionError(f"map gates failed: median {med_mm} mm, rms {rms_mm} mm")
    return launches, (config, scene, poses, packed)


def phase_profile(frames, first=60, n=20):
    """torch.profiler over n frames of the slice (a fresh volume): device
    time against wall time, and the device ops that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    config, scene, poses, packed = frames
    sel = slice(first, first + n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(config, scene, poses[sel], packed[sel], "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ops = [e for e in prof.events()     # kernels, memcpys and memsets
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device_ops) * 1e-6
    by_name = {}
    for e in device_ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {n} frames wall={wall:.4f} s device_ops={len(device_ops)} "
        f"device_busy={busy:.4f} s busy_share={busy / wall:.3f} "
        f"top_ms={json.dumps({k[:60]: round(v, 3) for k, v in top})}")


def phase_small():
    """The slice on a small input, GPU kernels against the CPU's plain
    versions. exp differs by an ulp between the two libraries, so a voxel
    may rarely round to another pixel: at most 0.1% of the observed voxels
    of the common chunks may differ by more than 1e-4 in sdf, and chunk
    sets and vertex counts may differ by 1%."""
    config = _slice_config(small=True)
    scene, poses, packed = _frames(config, 4, "cpu")
    gvol, gmesh, _ = run_slice(config, scene, poses, packed, "cuda", mesh_every=2)
    cvol, cmesh, _ = run_slice(config, scene, poses, packed, "cpu", mesh_every=2)
    g_of = {tuple(r): s for s, r in zip(gvol.active_slots(), gvol.ids[gvol.used].tolist())}
    c_of = {tuple(r): s for s, r in zip(cvol.active_slots(), cvol.ids[cvol.used].tolist())}
    common = sorted(set(g_of) & set(c_of))
    n_diff = len(set(g_of) ^ set(c_of))
    gs = gvol.batch.sdf[[g_of[c] for c in common]].cpu()
    cs = cvol.batch.sdf[[c_of[c] for c in common]]
    seen = (gvol.batch.weight[[g_of[c] for c in common]].cpu() > 0) | (
        cvol.batch.weight[[c_of[c] for c in common]] > 0)
    diff = (gs - cs).abs()[seen]
    frac = float((diff > 1e-4).float().mean())
    nv_g, nv_c = len(gmesh[0]), len(cmesh[0])
    log(f"[small] 160x120 x4 frames: chunks gpu={len(g_of)} cpu={len(c_of)} "
        f"differing={n_diff} observed_voxels={int(seen.sum())} sdf_max_err={float(diff.max()):.3e} "
        f"sdf_frac_over_1e-4={frac:.2e} verts gpu={nv_g} cpu={nv_c}")
    if not (n_diff <= len(c_of) // 100 and frac <= 1e-3 and nv_c > 0
            and abs(nv_g - nv_c) <= nv_c // 100):
        raise AssertionError("GPU slice disagrees with the CPU slice on a small input")


def main() -> int:
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    launches, frames = phase_slice()
    phase_small()
    phase_profile(frames)
    kernels = [
        {"name": "bilateral", "route": "cuda",
         "source": "texturefusion_torch/csrc/bilateral.cu",
         "replaces": "texturefusion_tpu/ops/pallas_kernels.py:71",
         "launches": launches["bilateral"], **k1},
        {"name": "tsdf_integrate", "route": "cuda",
         "source": "texturefusion_torch/csrc/tsdf_integrate.cu",
         "replaces": "examples/pallas_voxel_kernel.py:230",
         "launches": launches["tsdf_integrate"], **k2},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
