#!/usr/bin/env python3
"""Speed-of-light report of the PyTorch port: each hot device program of
the pipeline alone, against its bound on this card.

The port's counterpart of examples/sol_report.py: the same inputs, drawn
from numpy.random.default_rng(0) in the same order (the VGA camera with
far_plane 6.0, blur_threshold 0.0, TSDFConfig(0.02, capacity 16384,
max_update_chunks 1024); depth N(2.0, 0.3) clipped to [0.3, 5], rgb,
quality; S+1 = 16385 rows of 512 voxels; origins; 400 real lanes of 1024,
padded with the trash slot S), and its programs in its order:

  integrate_frame_fused = integrate_rows_pallas (K2)
      the JAX script's first two rows: both are one K2 launch in the port
  reintegrate_frame_fused          2 x K2
  integrate_depths_batched(6)      K2's F-frame mode
  candidate_chunks_unique (host read), candidate_chunks_unique_dev
      the discovery with its count read on the host, and the device-only
      one the pipeline dispatches
  mesh_chunks_pooled(512)          on make_mesh_pool(S, 256, 384)
  frame_step_tracked2              K1 inside; draws from tracked_draws
  promote_probe(5 cand)            over an 8-keyframe KeypointDB

Columns: the JAX script's `kernel`, `ms` (median host clock of n calls,
each ending in a synchronize), `bytes_mb` (its byte formulas, unchanged;
for the probe, which it leaves at 0, the DB rows and keypoints it reads),
`sol_ms` (those bytes at 3.35 TB/s) and `calls_per_cycle` (null here;
chip_smoke.py writes K1's, K2's and the F-frame mode's launches a frame of
its [pipeline]); and the port's `device_ms`, `span_ms`, `device_ops`
(utils/devtime), `needed_mb` (what this run's data needs: for the K2
rows the rows of the voxels that change and the pixels they sample, as
chip_smoke.py counts them; elsewhere the JAX bytes), `bound_ms` and
`bound_by` (the needed bytes at 3.35 TB/s against the operations that an
`ops_fn` counts, if given) and `frac_of_roofline`, bound_ms over
device_ms and over ms. A share over 1.0 raises: a count is at fault. The
JAX bytes of the K2 rows count every listed row read and written; the
card's K2 writes only the voxels in the band, so they are no bound for it.

The rows are updated in place, where the JAX script adopts donated
buffers: repeated calls into the same rows change the values, not the
work. The 201 MB rows are made once.

    python3 tools/sol_report.py [--out chiprun_out/sol_report_h100.json]
                                [--n 10] [--small] [--no-scaling]
                                [--device cuda|cpu]

--small runs the tiny test camera with 1024 rows, U = 256 and 100 real
lanes. The scaling block (tools/bench_multichip.py) gives one card's
rates and the overhead of 4 shards on it. The report goes to --out, never
to SOL_REPORT.json (the TPU's). --device cuda without CUDA raises; off
CUDA the device columns are null. Imports no jax and no image library.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA's data sheet, at the 700 W limit)
OUT = os.path.join("chiprun_out", "sol_report_h100.json")
ROWS = ("integrate_frame_fused = integrate_rows_pallas (K2)", "reintegrate_frame_fused",
        "integrate_depths_batched(6)", "candidate_chunks_unique (host read)",
        "candidate_chunks_unique_dev", "mesh_chunks_pooled(512)", "frame_step_tracked2",
        "promote_probe(5 cand)")
# each row's name in the JAX script (its byte formula)
JAX_NAME = dict(zip(ROWS, ("integrate_frame_fused", "reintegrate_frame_fused",
                           "integrate_depths_batched(6)", "candidate_chunks_unique",
                           "candidate_chunks_unique", "mesh_chunks_pooled(512)",
                           "frame_step_tracked2", "promote_probe(5 cand)")))
KEYS = ("kernel", "ms", "bytes_mb", "sol_ms", "frac_of_roofline", "calls_per_cycle",
        "device_ms", "span_ms", "device_ops", "needed_mb", "bound_ms", "bound_by")
N_CAND = 5
KF_ROWS = 8
MESH_LANES = 512
LOCAL_FRAMES = 6
# one keypoint's bytes: uv 8, response 4, angle 4, level 4, descriptor 32,
# valid 1, points3d 12, has_depth 1
KEYPOINT_BYTES = 66
LANE_BYTES = 8 + 1 + 12       # a lane's slot, flag and origin


def sol_config(small: bool = False):
    from texturefusion_torch.config import (CameraConfig, PipelineConfig, TrackingConfig,
                                            TSDFConfig, tiny_test_config)
    if small:
        tiny = tiny_test_config()
        return tiny.replace(tracking=dataclasses.replace(tiny.tracking, blur_threshold=0.0),
                            tsdf=TSDFConfig(voxel_resolution=0.02, capacity=1024,
                                            max_update_chunks=256))
    return PipelineConfig(camera=CameraConfig(far_plane=6.0),
                          tracking=TrackingConfig(blur_threshold=0.0),
                          tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                                          max_update_chunks=1024))


def draws(h: int, w: int, capacity: int, n_update: int, n_real: int, seed: int = 0) -> dict:
    """examples/sol_report.py:64-77's draws, in its order, as numpy."""
    rng = np.random.default_rng(seed)
    depth = np.clip(rng.normal(2.0, 0.3, (h, w)), 0.3, 5.0).astype(np.float32)
    rgb = rng.random((h, w, 3), np.float32)
    quality = rng.random((h, w), np.float32)
    origins = rng.integers(-20, 20, (capacity + 1, 3)).astype(np.float32) * 0.16
    idx = np.concatenate([rng.choice(capacity, n_real, replace=False),
                          np.full(n_update - n_real, capacity)]).astype(np.int64)
    return {"depth": depth, "rgb": rgb, "quality": quality, "origins": origins, "idx": idx,
            "active": np.arange(n_update) < n_real}


def jax_bytes(h: int, w: int, n_real: int, v: int = 512, f: int = LOCAL_FRAMES) -> dict:
    """The JAX script's bytes of each of its rows (integrate_rows_pallas
    included), unchanged: a count of rows and pixels touched."""
    row = n_real * v * 6 * 4 * 2
    img = h * w * 5 * 4
    gather = n_real * v * 5 * 4
    return {"integrate_frame_fused": row + img + gather,
            "integrate_rows_pallas": row + img,
            "reintegrate_frame_fused": row + 2 * (img + gather),
            "integrate_depths_batched(6)": n_real * v * 2 * 4 * 2 + f * (h * w * 4 + n_real * v * 4),
            "candidate_chunks_unique": (h // 2) * (w // 2) * 5 * 4 * 2 * 4,
            "mesh_chunks_pooled(512)": n_real * (9 ** 3) * 8 * 4 + n_real * (256 * 3 + 384 * 3) * 4,
            "frame_step_tracked2": h * w * 5 * 4 * 6,
            "promote_probe(5 cand)": 0}


def probe_bytes(n_rows: int, pad: int, words: int, n_cand: int = N_CAND) -> int:
    """What promote_probe reads: the descriptor rows and flags of the n_rows
    DB rows (similarity), the keypoints of its candidates and of the new
    frame."""
    return n_rows * pad * (words * 4 + 1) + (n_cand + 1) * pad * KEYPOINT_BYTES


def make_inputs(config, device, n_real: int = 400, seed: int = 0) -> dict:
    """The report's inputs on `device`: the draws, the S+1 rows, the frame
    packed for the tracked step, its keypoints and the RANSAC draws of the
    tracked step and of the probe (explicit generators)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.models.reconstruction import frame_generator, tracked_draws
    from texturefusion_torch.ops import tsdf
    from texturefusion_torch.ops.preprocess import pack_frame
    from texturefusion_torch.slam.features import extract_features
    from texturefusion_torch.slam.matching import ransac_draws
    intr = cam.Intrinsics.from_config(config.camera)
    cfg, tcfg = config.tsdf, config.tracking
    x = draws(intr.height, intr.width, cfg.capacity, cfg.max_update_chunks, n_real, seed)
    t = {k: torch.as_tensor(a, device=device) for k, a in x.items()}
    t["pose"] = torch.eye(4, device=device)
    t["batch"] = tsdf.make_empty_batch(cfg.capacity + 1, cfg.chunk_size ** 3, device)
    t["packed"] = torch.as_tensor(pack_frame((x["depth"] * 5000).astype(np.uint16),
                                             (x["rgb"] * 255).astype(np.uint8)), device=device)
    t["kp"] = extract_features(t["rgb"].mean(-1), t["depth"], tcfg, intr)
    t["tracked_draws"] = tracked_draws(seed, 0, tcfg, device)
    gen = frame_generator(seed, 1, device)
    t["probe_draws"] = torch.stack([ransac_draws(tcfg, tcfg.max_features_pad, gen)
                                    for _ in range(N_CAND)])
    return {"config": config, "intr": intr, "n_real": n_real, "seed": seed, **t}


def programs(inp: dict) -> dict:
    """The report's programs in its order: name -> fn() on `inp` (the TSDF
    ones update inp["batch"] in place), and "mesh_pool": the pool that
    mesh_chunks_pooled writes."""
    from texturefusion_torch.models.reconstruction import frame_step_tracked2
    from texturefusion_torch.ops import hamming, tsdf
    from texturefusion_torch.ops import marching_cubes as mc
    from texturefusion_torch.slam.promote import KeypointDB, promote_probe
    config, intr = inp["config"], inp["intr"]
    cfg, tcfg = config.tsdf, config.tracking
    dev = inp["depth"].device
    b, o, idx, act = inp["batch"], inp["origins"], inp["idx"], inp["active"]
    d, rgb, q, pose = inp["depth"], inp["rgb"], inp["quality"], inp["pose"]
    depths = torch.stack([d] * LOCAL_FRAMES)
    poses = torch.stack([pose] * LOCAL_FRAMES)
    pool = mc.make_mesh_pool(cfg.capacity, 256, 384, dev)
    m_idx = idx[:MESH_LANES]
    nbr = m_idx[:, None].repeat(1, 8)
    m_act = torch.arange(m_idx.shape[0], device=dev) < inp["n_real"]
    kp = inp["kp"]
    kf_w = (d > 0).to(torch.float32)
    db = KeypointDB(config.ba.max_keyframes, tcfg.max_features_pad, dev)
    for s in range(KF_ROWS):
        db.add(s, kp)
    desc = torch.zeros((config.ba.max_keyframes, tcfg.max_features_pad, hamming.WORDS),
                       dtype=torch.int32, device=dev)
    dvalid = torch.zeros((config.ba.max_keyframes, tcfg.max_features_pad), dtype=torch.bool,
                         device=dev)
    r2s = torch.arange(config.ba.max_keyframes, device=dev)
    return {
        ROWS[0]: lambda: tsdf.integrate_frame_fused(b, o, idx, act, d, rgb, q, pose, 1.0, intr,
                                                    cfg, with_color=True),
        ROWS[1]: lambda: tsdf.reintegrate_frame_fused(b, o, idx, act, d, rgb, q, pose, pose,
                                                      intr, cfg),
        ROWS[2]: lambda: tsdf.integrate_depths_batched(b, o, idx, act, depths, poses, 1.0, intr,
                                                       cfg),
        ROWS[3]: lambda: tsdf.candidate_chunks_unique(d, pose, intr, cfg, stride=2,
                                                      max_out=cfg.max_update_chunks * 4),
        ROWS[4]: lambda: tsdf.candidate_chunks_unique_dev(d, pose, intr, cfg, stride=2,
                                                          max_out=cfg.max_update_chunks * 4),
        ROWS[5]: lambda: mc.mesh_chunks_pooled(pool, *b, m_idx, nbr, o[m_idx], m_act,
                                               cfg.chunk_size, cfg.voxel_resolution),
        ROWS[6]: lambda: frame_step_tracked2(inp["packed"], None, kp, kp, d, kf_w, inp["seed"], 0,
                                             intr, tcfg, config.camera.depth_scale,
                                             draws=inp["tracked_draws"]),
        ROWS[7]: lambda: promote_probe(db.kp, desc, dvalid, r2s, KF_ROWS, KF_ROWS - 1, kp,
                                       torch.zeros(21, device=dev), False, inp["probe_draws"],
                                       tcfg.salient_score_threshold, config.ba.huber_delta, tcfg,
                                       intr, N_CAND),
        "mesh_pool": pool,
    }


def _pixels(world, origins, pose, intr, cfg, mask=None) -> int:
    """Distinct in-image pixels the voxels `world` [n, 512, 3] sample at
    `pose` (where `mask` [n, 512] holds, if given)."""
    from texturefusion_torch.ops import tsdf
    _, in_img, flat, _ = tsdf._project_voxels(world, origins, pose, intr, cfg)
    keep = in_img if mask is None else in_img & mask
    return int(flat[keep].unique().numel())


def k2_work(inp: dict, passes) -> tuple:
    """What K2 passes [(pose, sign)] over the listed rows need, from the
    plain version on copies of those rows: (bytes, work). Bytes: the
    voxels any pass changes, read and written (sdf and weight 16 B; colour
    and count 32 B where the colour changes), each pass's distinct depth
    pixels (4 B) and colour pixels (rgb and quality, 16 B), and per lane
    its slot, flag and origin. Work: {"k2": [(lanes, threads with a
    changed colour voxel)] a pass}."""
    from texturefusion_torch.ops import tsdf
    cfg, intr, n = inp["config"].tsdf, inp["intr"], inp["n_real"]
    rows = inp["idx"][:n]
    sub = inp["batch"].rows(rows)
    orig = inp["origins"][rows]
    world = tsdf._voxel_world(orig, cfg)
    ones = torch.ones(n, dtype=torch.bool, device=rows.device)
    touched = torch.zeros(sub.sdf.shape, dtype=torch.bool, device=rows.device)
    ctouched = torch.zeros_like(touched)
    n_bytes, launches = n * LANE_BYTES, []
    for pose, sign in passes:
        new, _, _ = tsdf.integrate_chunks(sub, orig, ones, inp["depth"], inp["rgb"],
                                          inp["quality"], pose, sign, intr, cfg, with_color=True)
        upd = (new.sdf != sub.sdf) | (new.weight != sub.weight)
        cupd = (new.color != sub.color).any(-1) | (new.color_count != sub.color_count)
        n_bytes += 4 * _pixels(world, orig, pose, intr, cfg) + 16 * _pixels(
            world, orig, pose, intr, cfg, cupd)
        touched |= upd
        ctouched |= cupd
        launches.append((n, int(cupd.reshape(n, -1, 4).any(-1).sum())))
        sub = new
    n_bytes += 16 * int(touched.sum()) + 32 * int(ctouched.sum())
    return n_bytes, {"k2": launches}


def frames_work(inp: dict, depths, poses) -> tuple:
    """What the F-frame mode over the listed rows needs: the voxels that
    change, read and written (sdf and weight, 16 B), each frame's distinct
    depth pixels (4 B), the poses, and per lane its slot, flag and origin;
    work {"frames": (F, lanes)}."""
    from texturefusion_torch.ops import tsdf
    cfg, intr, n = inp["config"].tsdf, inp["intr"], inp["n_real"]
    rows = inp["idx"][:n]
    sub = inp["batch"].rows(rows)
    before = (sub.sdf.clone(), sub.weight.clone())
    orig = inp["origins"][rows]
    lanes = torch.arange(n, device=rows.device)
    tsdf.integrate_depths_batched_plain(sub, orig, lanes, None, depths, poses, 1.0, intr, cfg)
    changed = (sub.sdf != before[0]) | (sub.weight != before[1])
    world = tsdf._voxel_world(orig, cfg)
    n_pix = sum(_pixels(world, orig, p, intr, cfg) for p in poses)
    n_bytes = 16 * int(changed.sum()) + 4 * n_pix + poses.numel() * 4 + n * LANE_BYTES
    return n_bytes, {"frames": (depths.shape[0], n)}


def k1_taps(inp: dict) -> int:
    """K1's taps in the tracked step: valid 9x9 taps inside the image
    around valid centres of the clamped raw depth."""
    from texturefusion_torch.ops import preprocess
    intr = inp["intr"]
    p = inp["packed"]
    raw = (p[..., 0].to(torch.float32) + p[..., 1].to(torch.float32) * 256.0) / (
        inp["config"].camera.depth_scale)
    valid = (preprocess.depth_clamp(raw, intr.near, intr.far) > 0).to(torch.float32)[None, None]
    ones = torch.ones(1, 1, 9, 9, device=valid.device)
    return int((torch.nn.functional.conv2d(valid, ones, padding=4) * valid).sum())


def row_bytes(inp: dict, name: str) -> int:
    """The row's bytes_mb count: the JAX formula, or the probe's reads."""
    from texturefusion_torch.ops import hamming
    intr, cfg = inp["intr"], inp["config"].tsdf
    if name == ROWS[7]:
        return probe_bytes(KF_ROWS, inp["config"].tracking.max_features_pad, hamming.WORDS)
    return jax_bytes(intr.height, intr.width, inp["n_real"], cfg.chunk_size ** 3)[JAX_NAME[name]]


def needs(inp: dict, name: str) -> tuple:
    """(needed bytes, work) of one row at the state of inp's rows now: the
    K2 rows' from their data, elsewhere the row's bytes."""
    pose = inp["pose"]
    if name == ROWS[0]:
        return k2_work(inp, [(pose, 1.0)])
    if name == ROWS[1]:
        return k2_work(inp, [(pose, -1.0), (pose, 1.0)])
    if name == ROWS[2]:
        return frames_work(inp, torch.stack([inp["depth"]] * LOCAL_FRAMES),
                           torch.stack([pose] * LOCAL_FRAMES))
    return row_bytes(inp, name), ({"k1_taps": k1_taps(inp)} if name == ROWS[6] else {})


def bound(needed_bytes: int, ops: dict) -> tuple:
    """(ms, "bytes" or "operations: UNIT"): the larger of the needed bytes
    at 3.35 TB/s and each operation count over its peak ({unit: (count,
    peak a second)})."""
    times = {"bytes": needed_bytes / HBM_BYTES_PER_S, **{u: c / r for u, (c, r) in ops.items()}}
    unit = max(times, key=times.get)
    return times[unit] * 1e3, ("bytes" if unit == "bytes" else f"operations: {unit}")


def run(config, device, n: int = 10, ops_fn=None, n_real: int = 400, inp=None,
        log=print) -> list:
    """Every row of the report, in order (KEYS), on `device`; `ops_fn(work)`
    gives a row's operations ({unit: (count, peak a second)}) from its work
    (the tool alone counts none). Raises where a share exceeds 1.0."""
    from texturefusion_torch.utils import devtime
    on_card = torch.device(device).type == "cuda"
    inp = make_inputs(config, device, n_real) if inp is None else inp
    progs = programs(inp)
    rows = []
    for name in ROWS:
        needed, work = needs(inp, name)
        m = devtime.measure(progs[name], device, n)
        n_bytes = row_bytes(inp, name)
        bound_ms, by = bound(needed, ops_fn(work) if ops_fn else {})
        frac = None
        if on_card:
            if not m["device_ms"] > 0:
                raise AssertionError(f"{name}: torch.profiler traced no device op: {m}")
            frac = {"device_ms": bound_ms / m["device_ms"], "ms": bound_ms / m["ms"]}
        row = {"kernel": name, "ms": m["ms"], "bytes_mb": round(n_bytes / 2 ** 20, 2),
               "sol_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "frac_of_roofline": frac,
               "calls_per_cycle": None, "device_ms": m["device_ms"], "span_ms": m["span_ms"],
               "device_ops": m["device_ops"], "needed_mb": needed / 2 ** 20,
               "bound_ms": bound_ms, "bound_by": by}
        rows.append(row)
        log(f"{name:52s} {m['ms']:9.4f} ms  span {_f(m['span_ms'])} device {_f(m['device_ms'])} "
            f"ms in {_f(m['device_ops'], 1)} ops  {row['bytes_mb']:.2f} MB  SoL {row['sol_ms']:.4f}  "
            f"bound {bound_ms:.4f} ms ({by})  share "
            + (json.dumps({k: round(v, 4) for k, v in frac.items()}) if frac else "n/a"))
        if frac and max(frac.values()) > 1.0:
            raise AssertionError(f"{name}: {frac} of its bound: a count is at fault")
    return rows


def _f(x, digits: int = 4) -> str:
    return "n/a" if x is None else f"{x:.{digits}f}"


def scaling(device) -> dict:
    """One card's rates (tools/bench_multichip.py) and the overhead of 4
    shards on it; with --device cpu, the CPU's."""
    from chip_smoke import load_tool
    bm = load_tool("bench_multichip")
    one = bm.make_bench_mesh(device, devices=1)
    four = bm.make_bench_mesh(device, shards_on_one_card=4)
    f1 = bm.bench_sharded_tsdf(one, 4096, n_iters=10)["steps_s"]
    b1 = bm.bench_distributed_ba(one, n_iters=5)
    out = {"1card_sharded_tsdf_steps_s": f1, "1card_distributed_ba_gn_iters_s": b1,
           "1card_ba_scale": bm.bench_ba_scale(one)}
    f4 = bm.bench_sharded_tsdf(four, 4096, n_iters=10)["steps_s"]
    b4 = bm.bench_distributed_ba(four, n_iters=5)
    out["4shards_one_card"] = {
        "tsdf_ratio": f4 / f1, "ba_ratio": b4 / b1,
        "ba_scale": bm.bench_ba_scale(four, ks=(256, 512), n_iters=2),
        "note": "4 shards of one device share its stream: the sharding's overhead, not a "
                "speedup; scaling needs several cards (tools/bench_multichip.py --devices N)"}
    return out


def write_report(path: str, rows: list, scaling_block: dict, device) -> None:
    from texturefusion_torch.utils import devtime
    on_card = torch.device(device).type == "cuda"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device": devtime.card() if on_card else str(device),
                   "peak_hbm_gbs": HBM_BYTES_PER_S / 1e9, "kernels": rows,
                   "scaling": scaling_block}, f, indent=1)
    print(f"wrote {os.path.abspath(path)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--no-scaling", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from texturefusion_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    config = sol_config(args.small)
    rows = run(config, device, args.n, n_real=100 if args.small else 400)
    block = {} if args.no_scaling else scaling(device)
    write_report(args.out, rows, block, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
