#!/usr/bin/env python3
"""End-to-end demo on the PyTorch port: fuse a synthetic RGB-D sequence
into a mesh, with ground-truth poses or the full SLAM pipeline.

The port's counterpart of examples/demo_synthetic.py, with its arguments
and pass rules, plus --device:

    python3 tools/demo_synthetic.py [--frames 8] [--size small|vga] [--out DIR]
                                    [--voxel 0.03] [--slam [--texture]]
                                    [--device cuda|cpu]

Ground-truth mode: each frame through preprocess.frame_preprocess (the
bilateral kernel), TSDFVolume.integrate_frame (the TSDF kernel), then
IncrementalMesher and OUT/fused.ply. --slam: ReconstructionPipeline (with
--texture TexturedPipeline) and finish(), then OUT/slam_fused.ply,
OUT/trajectory.txt and, with --texture, the textured OBJ / MTL / PNG. The
JAX script runs one more texture cycle (its private `_texture_cycle`)
before the export; here finish()'s texture catch-up stands for it, which
patches every meshed chunk again at the final poses.

RESULT: PASS (exit 0) when the median |SDF| of the mesh vertices against
the analytic scene is below a voxel, and with --slam also the ATE
against the ground-truth poses is below 20 mm; else FAIL (exit 1). It
runs on the GPU unless --device names another device; --device cuda
without CUDA raises. Imports no jax and no image library.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ATE_LIMIT_M = 0.02


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="small", choices=["small", "vga"])
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--voxel", type=float, default=0.03)
    ap.add_argument("--slam", action="store_true",
                    help="full pipeline with tracking instead of GT poses")
    ap.add_argument("--texture", action="store_true",
                    help="with --slam: online texturing + OBJ export")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _median_sdf(scene, verts: np.ndarray) -> np.ndarray:
    """|SDF| of world-frame vertices against the analytic scene."""
    return np.abs(scene.sdf(torch.as_tensor(np.asarray(verts, np.float32))).numpy())


def run_slam_pipeline(config, scene, poses, depths, rgbs, args, device, sync) -> dict:
    """Full pipeline: tracking, loop closure, BA, fusion and meshing."""
    from texturefusion_torch.fusion.pipeline import ReconstructionPipeline, TexturedPipeline
    from texturefusion_torch.io import ply, tum
    from texturefusion_torch.texture.manager import NoTexturedChunks
    from texturefusion_torch.utils.stopwatch import STOPWATCH

    pipe = (TexturedPipeline if args.texture else ReconstructionPipeline)(config,
                                                                           device=device)
    try:
        t0 = time.perf_counter()
        for i, (d, c) in enumerate(zip(depths, rgbs)):
            pipe.process_frame(d, c, timestamp=float(i))
        pipe.finish()
        sync()
        dt = time.perf_counter() - t0
        print(f"pipeline: {len(depths)} frames in {dt:.3f}s "
              f"({len(depths) / dt:.3f} fps), stats={pipe.stats}")
        print(STOPWATCH.report())

        rmse = tum.ate_rmse(pipe.trajectory(), np.stack(poses))
        verts, faces, colors, normals = pipe.mesher.full_mesh()
        os.makedirs(args.out, exist_ok=True)
        ply.save_ply(os.path.join(args.out, "slam_fused.ply"), verts, faces, colors, normals)
        pipe.save_trajectory(os.path.join(args.out, "trajectory.txt"))
        if args.texture:
            try:
                print("textured model:", pipe.export_textured(args.out))
            except NoTexturedChunks as e:
                print("texture export skipped:", e)
        stats = dict(pipe.stats)
        lost = [f.index for f in pipe.slam.frames if not f.tracking_success]
    finally:
        pipe.close()
    # the pipeline's world is the first camera's frame
    verts_w = verts @ poses[0][:3, :3].T + poses[0][:3, 3]
    err = _median_sdf(scene, verts_w)
    median = float(np.median(err))
    print(f"ATE RMSE: {rmse * 1000:.3f}mm | mesh: {len(verts)} verts, "
          f"median surf err {median * 1000:.3f}mm")
    ok = rmse < ATE_LIMIT_M and median < config.tsdf.voxel_resolution
    print("RESULT:", "PASS" if ok else "FAIL")
    return {"rc": 0 if ok else 1, "verts": len(verts), "median_mm": median * 1e3,
            "ate_mm": rmse * 1e3, "fps": len(depths) / dt, "keyframes": stats["keyframes"],
            "lost_frames": lost}


def run(argv=None, frames=None) -> dict:
    """The demo on `frames` ((depths, rgbs) numpy arrays of the orbit), or
    on frames it renders; returns {rc, verts, median_mm, ate_mm, fps,
    keyframes, lost_frames (the frames whose tracking failed)} after
    printing the JAX script's lines; without --slam ate_mm, keyframes and
    lost_frames are None."""
    args = _parse(argv)
    from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.fusion.mesher import IncrementalMesher
    from texturefusion_torch.io import ply, synthetic
    from texturefusion_torch.ops import preprocess
    from texturefusion_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    if args.size == "small":
        camera = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                              cx=159.5, cy=119.5, far_plane=6.0)
    else:
        camera = CameraConfig(far_plane=6.0)
    config = PipelineConfig(
        camera=camera,
        tsdf=TSDFConfig(voxel_resolution=args.voxel, capacity=8192, max_update_chunks=1024),
    )
    intr = cam.Intrinsics.from_config(camera)
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else device)

    scene = synthetic.BoxRoomScene()
    poses = synthetic.orbit_trajectory(args.frames)
    if frames is None:
        t0 = time.perf_counter()
        frames = synthetic.render_sequence(scene, intr, poses, device=device)
        print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.3f}s")
    depths, rgbs = frames

    if args.slam:
        return run_slam_pipeline(config, scene, poses, depths, rgbs, args, device, sync)

    vol = TSDFVolume(config, device=device)
    mesher = IncrementalMesher(vol)
    t0 = time.perf_counter()
    for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
        d, c = torch.as_tensor(d, device=device), torch.as_tensor(c, device=device)
        dpre = preprocess.frame_preprocess(d, intr)
        normals = preprocess.extract_normal_map(dpre, intr)
        quality = preprocess.observation_quality_map(c, dpre, normals, intr)
        vol.integrate_frame(dpre, c, quality, p, keyframe_id=i)
    sync()
    dt = time.perf_counter() - t0
    print(f"fused {args.frames} frames in {dt:.3f}s "
          f"({args.frames / dt:.3f} fps), {vol.n_active()} chunks")

    t0 = time.perf_counter()
    n = mesher.update_meshes()
    verts, faces, colors, normals = mesher.full_mesh()
    print(f"meshed {n} chunks in {time.perf_counter() - t0:.3f}s: "
          f"{len(verts)} verts, {len(faces)} faces")

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "fused.ply")
    ply.save_ply(out_path, verts, faces, colors, normals)
    print("wrote", out_path)

    # geometric sanity: mesh vertices near the analytic surface
    err = _median_sdf(scene, verts)
    median = float(np.median(err))
    print(f"mesh-to-surface error: median {median * 1000:.3f}mm, "
          f"mean {err.mean() * 1000:.3f}mm "
          f"(voxel {config.tsdf.voxel_resolution * 1000:.0f}mm)")
    ok = median < config.tsdf.voxel_resolution
    print("RESULT:", "PASS" if ok else "FAIL")
    return {"rc": 0 if ok else 1, "verts": len(verts), "median_mm": median * 1e3,
            "ate_mm": None, "fps": args.frames / dt, "keyframes": None, "lost_frames": None}


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
