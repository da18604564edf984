#!/usr/bin/env python3
"""Accuracy reference for chip_smoke.py's [pipeline] phase: the JAX
package's own synchronous ReconstructionPipeline on the same frames, on
the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_pipeline_reference.py [--frames 120]

The frames are chip_smoke.py's `[tracked]` frames (bench.py's hardened
loop: 120 VGA frames, depth noise, exposure step, blur burst), rendered
by the port on the CPU. The configuration is `[pipeline]`'s (bench.py's
camera and blur gate, TSDFConfig(0.02, 16384, 1024), default BAConfig)
with the JAX package's synchronous settings: defer_promote=False and
ParallelConfig(async_fusion=False, pipelined_tracking=False,
async_cycle_results=False). It prints one JSON line: ATE, keyframes,
loop-closure edges, reintegrations, and the map error after bench.py's
Umeyama alignment (bench.py map_error_mm). Needs jax and scipy; takes
minutes and a few GB of memory at VGA.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import chip_smoke
    from texturefusion_tpu.config import (CameraConfig, ParallelConfig, PipelineConfig,
                                          TrackingConfig, TSDFConfig)
    from texturefusion_tpu.eval import loop_closure
    from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
    from texturefusion_tpu.io import synthetic, tum

    config = PipelineConfig(
        camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005),
        tracking=dataclasses.replace(TrackingConfig(blur_threshold=3.0), defer_promote=False),
        tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384, max_update_chunks=1024),
        parallel=ParallelConfig(async_fusion=False, pipelined_tracking=False,
                                async_cycle_results=False))
    t0 = time.perf_counter()
    _, poses, packed = chip_smoke._frames(config, args.frames, "cpu", harden=True)
    gt = np.stack(poses)
    print(f"rendered {args.frames} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    pipe = ReconstructionPipeline(config)
    t0 = time.perf_counter()
    for i, frame in enumerate(packed):
        pipe.process_frame(jnp.asarray(frame), timestamp=float(i), host_packed=frame)
    pipe.finish()
    wall = time.perf_counter() - t0
    est = pipe.trajectory()
    verts = pipe.mesher.full_mesh()[0]
    rot, t = tum.align_umeyama(est, gt)
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))
    err = np.abs(np.asarray(scene.sdf(jnp.asarray(verts @ rot.T + t)))).astype(np.float64)
    det = loop_closure.detected_pairs_from_slam(pipe.slam)
    print(json.dumps({
        "package": "texturefusion_tpu", "device": jax.devices()[0].platform,
        "frames": args.frames, "ate_mm": tum.ate_rmse(est, gt) * 1e3,
        "map_rms_mm": float(np.sqrt(np.mean(err ** 2)) * 1e3),
        "map_median_mm": float(np.median(err) * 1e3), "verts": int(len(verts)),
        "keyframes": len(pipe.slam.keyframes), "loop_edges": len(det),
        "reintegrations": pipe.stats["reintegrations"],
        "active_chunks": int(pipe.volume.n_active()), "seconds": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
