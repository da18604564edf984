#!/usr/bin/env python3
"""Offline turntable renderer on the PyTorch port: fuse the synthetic
scene, then raycast a 360-degree orbit of novel views straight off the
TSDF on the device, shaded with the fused voxel colours and a headlight
diffuse term.

The port's counterpart of examples/turntable.py (the offline stand-in
for the reference's viewer, GCFusion/MobileGUI.hpp:17-198 and
Shaders/draw_mesh.vert:29-70): every frame is one
`ops/raycast.raycast_volume` call over the live volume. It imports no
jax and no image library: its PNGs go through io/png.

    python3 tools/turntable.py [--frames 24] [--fuse 24] [--out DIR] [--voxel 0.03]
                               [--device cuda|cpu]

Writes OUT/turn_###.png and a summary line; PASS (exit 0) if every frame
hits more than 50% of its pixels (the orbit stays inside the fused room).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def orbit_pose(k: int, n: int) -> np.ndarray:
    """Camera-to-world pose k of n on a 0.9 m yaw orbit, looking outward."""
    a = 2.0 * np.pi * k / n
    eye = np.asarray([0.9 * np.sin(a), 0.0, 0.9 * np.cos(a)])
    fwd = np.asarray([np.sin(a), 0.0, np.cos(a)])
    up = np.asarray([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1] = right, np.cross(fwd, right)
    pose[:3, 2], pose[:3, 3] = fwd, eye
    return pose


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24, help="orbit render frames")
    ap.add_argument("--fuse", type=int, default=24, help="synthetic frames fused first")
    ap.add_argument("--out", default="turntable_out")
    ap.add_argument("--voxel", type=float, default=0.03)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.io import png, synthetic
    from texturefusion_torch.ops import preprocess, raycast
    from texturefusion_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    camera = CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
                          far_plane=6.0)
    config = PipelineConfig(camera=camera, tsdf=TSDFConfig(
        voxel_resolution=args.voxel, capacity=8192, max_update_chunks=1024))
    intr = cam.Intrinsics.from_config(camera)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    poses = synthetic.loop_trajectory(args.fuse, radius=1.2)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses,
                                             device=device)
    vol = TSDFVolume(config, device=device)
    t0 = time.perf_counter()
    for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
        d, c = torch.as_tensor(d, device=device), torch.as_tensor(c, device=device)
        dpre = preprocess.frame_preprocess(d, intr)
        normals = preprocess.extract_normal_map(dpre, intr)
        quality = preprocess.observation_quality_map(c, dpre, normals, intr)
        vol.integrate_frame(dpre, c, quality, p, keyframe_id=i)
    sync()
    print(f"fused {args.fuse} frames in {time.perf_counter() - t0:.3f} s")

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    hit_fracs = []
    for k in range(args.frames):
        pose = orbit_pose(k, args.frames)
        res = raycast.raycast_volume(vol, pose)
        hit, col, nrm = (t.cpu().numpy() for t in (res.hit, res.color, res.normals))
        # headlight diffuse |n · view|: the viewer's shader lighting, offline
        shade = np.clip(np.abs(nrm @ pose[:3, 2]), 0.25, 1.0)[..., None]
        img = np.where(hit[..., None], col * shade, 0.08)
        png.write_png(os.path.join(args.out, f"turn_{k:03d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
        hit_fracs.append(float(hit.mean()))
    dt = time.perf_counter() - t0
    print(f"rendered {args.frames} novel views in {dt:.3f} s ({args.frames / dt:.2f} views/s), "
          f"hit fraction min {min(hit_fracs):.3f} mean {np.mean(hit_fracs):.3f}")
    ok = min(hit_fracs) > 0.5
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
