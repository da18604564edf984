"""Command-line entry point.

Port of texturefusion_tpu/__main__.py, with the reference binary's
interface (ref: README.md:102-131 `./FlashFusion $DataFolder $ParamsFile
Resolution InputMode`; argument parsing BasicAPI.cpp:1169-1205; final
exports main.cpp:213-317):

    python -m texturefusion_torch DATA_FOLDER PARAMS_FILE RESOLUTION INPUT_MODE
           [--out OUT_DIR] [--max-frames N] [--no-texture] [--device cuda|cpu]

Writes trajectory.txt (TUM format), stat.txt and chunk.txt, keyframes/
(%06d.cam + %06d.png), fused.ply and the textured model.obj / .mtl / .png
into OUT_DIR, and prints the ATE in dataset mode (InputMode 0) when the
dataset has a groundtruth.txt. It runs on the GPU unless --device names
another device; --device cuda on a machine without CUDA raises. Its
config's tracker is the JAX CLI's default: pipelined tracking at
pipeline_depth 2, deferred promotion and the stale-frame refinement.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def load_params_yaml(path: str) -> dict:
    """Parse the reference's OpenCV-YAML settings file
    (ref: BasicAPI.cpp:41-72 loadGlobalParameters; settings.yaml)."""
    out = {}
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        line = line.split("#")[0].strip()
        if ":" in line and not line.startswith("%"):
            k, _, v = line.partition(":")
            v = v.strip()
            if not v:
                continue
            try:
                out[k.strip()] = float(v) if "." in v or "e" in v else int(v)
            except ValueError:
                out[k.strip()] = v
    return out


def apply_params(config, params: dict):
    """Map GlobalParameters names onto the typed config."""
    t = config.tracking
    mapping = {
        "max_feature_num": "max_features",
        "ransac_maximum_iterations": "ransac_iterations",
        "maximum_keyframe_match_num": "max_candidates",
        "minimum_disparity": "minimum_disparity",
        "reprojection_error_3d_threshold": "reproj_3d_threshold",
        "reprojection_error_2d_threshold": "reproj_2d_threshold",
        "keyframe_minimum_distance": "keyframe_min_distance",
        "hamming_distance_threshold": "hamming_threshold",
        "salient_score_threshold": "salient_score_threshold",
        "use_fine_search": "use_fine_search",
    }
    kw = {dst: type(getattr(t, dst))(params[src]) for src, dst in mapping.items()
          if src in params}
    if kw:
        t = dataclasses.replace(t, **kw)
    far = params.get("far_plane_distance")
    camera = config.camera
    if far:
        camera = dataclasses.replace(camera, far_plane=float(far))
    return config.replace(tracking=t, camera=camera)


def make_config(resolution: float, params_file: str):
    """The CLI's configuration: the defaults at `resolution` metres a
    voxel, then the settings file's values."""
    from texturefusion_torch.config import PipelineConfig, TSDFConfig
    config = PipelineConfig(tsdf=TSDFConfig(voxel_resolution=resolution))
    return apply_params(config, load_params_yaml(params_file))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="texturefusion_torch")
    ap.add_argument("data_folder")
    ap.add_argument("params_file")
    ap.add_argument("resolution", type=float,
                    help="voxel resolution in meters (0.005-0.04)")
    ap.add_argument("input_mode", type=int,
                    help="0 dataset, 1 OpenNI2, 2 RealSense, 4 synthetic")
    ap.add_argument("--out", default="./output")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-texture", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from texturefusion_torch.fusion.pipeline import ReconstructionPipeline, TexturedPipeline
    from texturefusion_torch.io import sensors, tum
    from texturefusion_torch.io.prefetch import prefetch_frames
    from texturefusion_torch.texture.manager import NoTexturedChunks
    from texturefusion_torch.utils.stopwatch import STOPWATCH

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available on this machine "
                           f"(pass --device cpu to run on the CPU)")

    config = make_config(args.resolution, args.params_file)
    sensor = sensors.open_sensor(args.input_mode, args.data_folder, config.camera,
                                 device=device)
    config = config.replace(camera=sensor.camera)

    cls = ReconstructionPipeline if args.no_texture else TexturedPipeline
    pipe = cls(config, device=device)
    try:
        t0 = time.perf_counter()
        n = 0
        for ts, depth, rgb, host in prefetch_frames(sensor.frames(), device, keep_host=True):
            # process_frame takes the host copy only for a packed [H, W, 5] frame
            pipe.process_frame(depth, rgb, timestamp=ts, host_packed=host[1])
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
        pipe.finish()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"processed {n} frames in {dt:.3f}s ({n / dt:.3f} fps), stats={pipe.stats}")
        print(STOPWATCH.report())

        os.makedirs(args.out, exist_ok=True)
        pipe.save_trajectory(os.path.join(args.out, "trajectory.txt"))
        pipe.save_stats(args.out)
        pipe.save_keyframe_textures(os.path.join(args.out, "keyframes"))
        n_verts = pipe.export_mesh(os.path.join(args.out, "fused.ply"))
        print(f"fused.ply: {n_verts} vertices")
        if not args.no_texture:
            pipe._texture_cycle()
            try:
                obj = pipe.export_textured(args.out)
                print("textured model:", obj)
            except NoTexturedChunks as e:
                print("texture export skipped:", e)

        if args.input_mode == 0:
            seq = sensor.seq
            if seq.gt_poses is not None and len(seq.gt_poses):
                pairs = tum.associate_timestamps(
                    np.asarray([f.timestamp for f in pipe.slam.frames]),
                    seq.gt_timestamps, max_dt=0.05)
                if len(pairs) > 2:
                    est = pipe.trajectory()[[i for i, _ in pairs]]
                    gt = seq.gt_poses[[j for _, j in pairs]]
                    print(f"ATE RMSE: {tum.ate_rmse(est, gt) * 1000:.1f} mm "
                          f"({len(pairs)} poses)")
    finally:
        pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
