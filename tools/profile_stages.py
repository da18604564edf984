#!/usr/bin/env python3
"""Device timing of every stage of the PyTorch port's frame path, apart.

The port's counterpart of examples/profile_stages.py: the same config
(VGA, far_plane 6.0, blur_threshold 0.0, TSDFConfig(0.02, capacity 16384,
max_update_chunks 1024)), the same two ground-truth orbit frames of the
box room, and its stages, labels and order: preprocess_bundle (K1),
extract_features, register_frames, fuse_depth_into_keyframe,
frame_step_tracked (full); the chunks discovered; integrate_frame_fused
(K2, over the discovered slots padded to the update budget); the dirty
set; IncrementalMesher.update_meshes on its first call and on a steady
one; the vertex and triangle totals; the pooled meshing at 512 lanes:
the device call, the counts fetch and the pool row fetch
(IncrementalMesher._fetch_rows).

Each stage prints `ms` (the median host clock of n calls, each ending in
a synchronize) beside `device_ms`, `span_ms` and `device_ops`
(utils/devtime: one traced call, CUDA events). update_meshes is timed
once a call on the host clock, as the JAX script times it; both its lines
carry the device columns of traced calls that restore the dirty set
each time: the same device work, which the first call adds nothing to. The rows are updated
in place where the JAX script adopts donated buffers, so the repeated
integrations change the values, not the work. Where the dirty set is
under 512 chunks the pooled meshing pads with the trash slot (the JAX
script looks the trash slot up in `ids` there and fails).

    python3 tools/profile_stages.py [--n 10] [--small] [--device cuda|cpu]

--small runs the tiny test camera (160x120) with 2048 rows. --device cuda
without CUDA raises; off CUDA the device columns are n/a. Imports no jax
and no image library.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MESH_LANES = 512
WIDTH = 40       # the JAX script's label column


def stages_config(small: bool = False):
    from texturefusion_torch.config import (CameraConfig, PipelineConfig, TrackingConfig,
                                            TSDFConfig, tiny_test_config)
    config = PipelineConfig(camera=CameraConfig(far_plane=6.0),
                            tracking=TrackingConfig(blur_threshold=0.0),
                            tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                                            max_update_chunks=1024))
    if small:
        config = config.replace(camera=tiny_test_config().camera,
                                tsdf=dataclasses.replace(config.tsdf, capacity=2048))
    return config


def render(config, n_frames: int, device):
    """The JAX script's frames: n ground-truth orbit poses of the box room,
    rendered on `device` (numpy depths, rgbs and poses)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    poses = synthetic.orbit_trajectory(n_frames)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(),
                                             cam.Intrinsics.from_config(config.camera), poses,
                                             device=device)
    return depths, rgbs, poses


def fmt(name: str, m: dict, width: int = WIDTH) -> str:
    """A stage's line: its label right-aligned as the JAX script prints it,
    ms, and the device columns."""
    def ms(key):
        return "n/a" if m[key] is None else f"{m[key]:.4f} ms"

    dev = ("device n/a" if m["device_ms"] is None else
           f"span {ms('span_ms')}, device {ms('device_ms')} in {m['device_ops']:.1f} ops")
    return f"{name:>{width}s}: {m['ms']:8.3f} ms   ({dev})"


def padded(slots: np.ndarray, budget: int, trash: int):
    """The JAX volume's _padded: the slots padded to the update budget with
    the trash slot, and the mask of the real ones."""
    slots = np.asarray(slots, np.int64)[:budget]
    pad = budget - len(slots)
    return (np.concatenate([slots, np.full(pad, trash, np.int64)]),
            np.arange(budget) < len(slots))


def run(device="cuda", small: bool = False, n: int = 10, frames=None, log=print) -> dict:
    """Every stage, printed in the JAX script's order. `frames` = (depths,
    rgbs, poses) of two frames replaces the render. Returns {"stages":
    {label: measure dict}, "chunks", "dirty", "verts", "tris"}."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.fusion.mesher import IncrementalMesher
    from texturefusion_torch.models.reconstruction import frame_generator, frame_step_tracked
    from texturefusion_torch.ops import marching_cubes as mc
    from texturefusion_torch.ops import preprocess
    from texturefusion_torch.ops import tsdf as T
    from texturefusion_torch.slam.features import extract_features
    from texturefusion_torch.slam.matching import ransac_draws, register_frames
    from texturefusion_torch.utils import devtime
    config = stages_config(small)
    intr = cam.Intrinsics.from_config(config.camera)
    tcfg, scale = config.tracking, config.camera.depth_scale
    depths, rgbs, poses = render(config, 2, device) if frames is None else frames
    p0, p1 = (torch.as_tensor(preprocess.pack_frame((d * scale).astype(np.uint16),
                                                    (c * 255).astype(np.uint8)), device=device)
              for d, c in zip(depths, rgbs))
    stages = {}

    def timeit(name, fn, reps=n):
        out = fn()
        stages[name] = devtime.measure(fn, device, reps, warm=0)
        log(fmt(name, stages[name]))
        return out

    def bundle(p):
        return preprocess.preprocess_bundle(p, None, intr, depth_scale=scale)

    depth0, normals0, quality0, gray0, blur0, rgb0 = timeit("preprocess_bundle",
                                                            lambda: bundle(p0))
    bundle1 = bundle(p1)
    depth1, gray1 = bundle1[0], bundle1[3]
    kp0 = timeit("extract_features", lambda: extract_features(gray0, depth0, tcfg, intr))
    kp1 = extract_features(gray1, depth1, tcfg, intr)
    draws = ransac_draws(tcfg, tcfg.max_features_pad, frame_generator(0, 0, device))
    res = timeit("register_frames", lambda: register_frames(kp0, kp1, draws, tcfg, intr))
    w0 = (depth0 > 0).to(torch.float32)
    timeit("fuse_depth_into_keyframe",
           lambda: preprocess.fuse_depth_into_keyframe(depth0, w0, depth1, res.pose, intr))
    timeit("frame_step_tracked (full)",
           lambda: frame_step_tracked(p1, None, kp0, depth0, w0, 0, 1, intr, tcfg, scale))

    vol = TSDFVolume(config, device=device)
    cfg = vol.cfg
    pose = torch.as_tensor(poses[0], dtype=torch.float32, device=device)
    d0 = torch.as_tensor(np.ascontiguousarray(depths[0], np.float32), device=device)
    r0 = torch.as_tensor(np.ascontiguousarray(rgbs[0], np.float32), device=device)
    slots = vol.discover_chunks(d0, pose)
    log(f"{'n chunks discovered':>{WIDTH}s}: {len(slots)}")
    idx, active = (torch.as_tensor(a, device=device)
                   for a in padded(slots, cfg.max_update_chunks, cfg.capacity))
    timeit("integrate_frame_fused",
           lambda: T.integrate_frame_fused(vol.batch, vol.origins, idx, active, d0, r0, quality0,
                                           pose, 1.0, intr, cfg))
    # integrate so there is surface to mesh
    vol.integrate_frame(d0, r0, quality0, pose, keyframe_id=0, sign=1.0)

    mesher = IncrementalMesher(vol)
    dirty = sorted(vol.dirty_mesh)
    log(f"{'n dirty chunks':>{WIDTH}s}: {len(dirty)}")
    def remesh():
        vol.dirty_mesh = set(dirty)
        mesher.update_meshes()

    for name in ("mesher.update_meshes (compile)", "mesher.update_meshes (steady)"):
        t0 = time.perf_counter()
        remesh()
        devtime.sync(device)
        stages[name] = {"ms": (time.perf_counter() - t0) * 1e3, "span_ms": None,
                        "device_ms": None, "device_ops": None}
    if torch.device(device).type == "cuda":
        device_cols = devtime.traced(remesh, device)
        for name in ("mesher.update_meshes (compile)", "mesher.update_meshes (steady)"):
            stages[name]["device_ms"], stages[name]["device_ops"] = device_cols
    for name in ("mesher.update_meshes (compile)", "mesher.update_meshes (steady)"):
        log(fmt(name, stages[name]))
    meshes = mesher.meshes
    n_verts = sum(len(v[0]) for v in meshes.values())
    n_tris = sum(len(v[1]) for v in meshes.values())
    log(f"{'total verts / tris':>{WIDTH}s}: {n_verts} / {n_tris}")

    # the pooled meshing path at 512 lanes
    n_part = min(len(dirty), MESH_LANES)
    part = np.asarray(dirty[:n_part], np.int64)
    nbr = np.full((MESH_LANES, 8), cfg.capacity, np.int64)
    nbr[:n_part] = mesher._neighbor_slots(part)
    sl = torch.as_tensor(np.concatenate([part, np.full(MESH_LANES - n_part, cfg.capacity)]),
                         device=device)
    og = torch.as_tensor(np.concatenate([vol.ids[part], np.zeros((MESH_LANES - n_part, 3))])
                         .astype(np.float32) * vol.extent, device=device)
    nb = torch.as_tensor(nbr, device=device)
    act = torch.arange(MESH_LANES, device=device) < n_part

    def pooled_mc():
        return mc.mesh_chunks_pooled(mesher.pool, *vol.batch, sl, nb, og, act, cfg.chunk_size,
                                     cfg.voxel_resolution)

    counts = timeit("  mesh_chunks_pooled[512] device", pooled_mc, reps=5)
    timeit("  counts fetch", lambda: tuple(c.cpu() for c in counts), reps=5)
    timeit("  pool row fetch", lambda: mesher._fetch_rows(part), reps=5)
    return {"stages": stages, "chunks": len(slots), "dirty": len(dirty), "verts": n_verts,
            "tris": n_tris}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from texturefusion_torch.utils.device import resolve_device
    run(resolve_device(args.device), args.small, args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
