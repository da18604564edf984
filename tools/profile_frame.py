#!/usr/bin/env python3
"""Per-stage timing of the PyTorch port's fusion frame path on one card.

The port's counterpart of examples/profile_frame.py: the same config
(VGA, far_plane 6.0, TSDFConfig(0.02, capacity 16384, max_update_chunks
1024); tools/profile_stages.stages_config, whose tracking settings this
script does not read), one ground-truth orbit frame of the box room, and its labels in
its order: the dispatch latency of a tiny op; host-to-device copies of the
depth and rgb (pageable as the JAX script's, then from pinned memory with
a non-blocking copy, as io/prefetch.upload makes them); a device-to-host
read of 1024 floats; preprocess_bundle (K1); candidate_chunks_unique and
its unique count; the allocator's touch of those ids (native.py's C++
allocator where it builds, else its Python twin; the line names which);
integrate_frame_fused (K2); discover+touch+integrate+sync.

Each line prints `ms` (the median host clock of n calls, each ending in a
synchronize) beside `device_ms`, `span_ms` and `device_ops`
(utils/devtime). The touch is host work and is timed on the host clock
alone. The JAX script unpacks preprocess_bundle's six outputs into five
names and fails there; here the six are taken.

    python3 tools/profile_frame.py [--n 5] [--small] [--device cuda|cpu]

--small runs the tiny test camera (160x120) with 2048 rows. --device cuda
without CUDA raises; off CUDA the pinned copies and the device columns
are n/a. Imports no jax and no image library.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH = 32       # the JAX script's label column


def run(device="cuda", small: bool = False, n: int = 5, frame=None, log=print) -> dict:
    """Every line, printed in the JAX script's order. `frame` = (depth,
    rgb, pose) replaces the render. Returns {"lines": {label: measure
    dict}, "unique": the unique chunk count, "allocator": its class}."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.ops import preprocess
    from texturefusion_torch.ops import tsdf as T
    from texturefusion_torch.utils import devtime
    from chip_smoke import load_tool
    ps = load_tool("profile_stages")
    config = ps.stages_config(small)
    intr = cam.Intrinsics.from_config(config.camera)
    on_card = torch.device(device).type == "cuda"
    if frame is None:
        depths, rgbs, poses = ps.render(config, 1, device)
        frame = depths[0], rgbs[0], poses[0]
    depth_np, rgb_np = (np.ascontiguousarray(a, np.float32) for a in frame[:2])
    pose = torch.as_tensor(frame[2], dtype=torch.float32, device=device)
    lines = {}

    def timeit(name, fn):
        out = fn()
        lines[name] = devtime.measure(fn, device, n, warm=0)
        log(ps.fmt(name, lines[name], WIDTH))
        return out

    tiny = torch.zeros(8, device=device)
    timeit("tiny op (dispatch latency)", lambda: tiny + 1.0)
    for name, a in (("h2d depth 1.2MB", depth_np), ("h2d rgb 3.7MB", rgb_np)):
        timeit(name, lambda a=a: torch.as_tensor(a).to(device, copy=True))
        if on_card:
            pinned = torch.as_tensor(a).pin_memory()
            timeit(name + " (pinned)", lambda p=pinned: p.to(device, non_blocking=True))
        else:
            log(f"{name + ' (pinned)':>{WIDTH}s}: n/a (no CUDA)")
    depth = torch.as_tensor(depth_np, device=device)
    rgb = torch.as_tensor(rgb_np, device=device)
    big = torch.zeros((config.tsdf.capacity + 1, 512), device=device)
    timeit("d2h 1024 floats", lambda: big.view(-1)[:1024].cpu())

    timeit("preprocess_bundle", lambda: preprocess.preprocess_bundle(depth, rgb, intr))
    dpre, normals, quality, gray, blur, _ = preprocess.preprocess_bundle(depth, rgb, intr)

    ids, n_unique = timeit("candidate_chunks_unique",
                           lambda: T.candidate_chunks_unique(depth, pose, intr, config.tsdf,
                                                             max_out=4096))
    log(f"{'n unique chunks':>{WIDTH}s}: {n_unique}")

    vol = TSDFVolume(config, device=device)
    ids_np = ids[:n_unique].cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(n):
        vol.alloc.touch(ids_np)
    allocator = type(vol.alloc).__name__
    lines["native touch"] = {"ms": (time.perf_counter() - t0) / n * 1e3, "span_ms": None,
                             "device_ms": None, "device_ops": None}
    log(f"{'native touch':>{WIDTH}s}: {lines['native touch']['ms']:8.3f} ms   ({allocator}, "
        f"host only)")

    slots = vol.discover_chunks(depth, pose)
    idx, active = (torch.as_tensor(a, device=device)
                   for a in ps.padded(slots, config.tsdf.max_update_chunks, config.tsdf.capacity))
    timeit("integrate_frame_fused",
           lambda: T.integrate_frame_fused(vol.batch, vol.origins, idx, active, depth, rgb,
                                           quality, pose, 1.0, intr, config.tsdf))

    def full():
        i2, a2 = (torch.as_tensor(a, device=device)
                  for a in ps.padded(vol.discover_chunks(depth, pose),
                                     config.tsdf.max_update_chunks, config.tsdf.capacity))
        q, _ = T.integrate_frame_fused(vol.batch, vol.origins, i2, a2, depth, rgb, quality, pose,
                                       1.0, intr, config.tsdf)
        return q.cpu().numpy()
    timeit("discover+touch+integrate+sync", full)
    return {"lines": lines, "unique": n_unique, "allocator": allocator}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from texturefusion_torch.utils.device import resolve_device
    run(resolve_device(args.device), args.small, args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
