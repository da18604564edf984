#!/usr/bin/env python3
"""Which part of the default tracker moves the map: the pipelined
tracker's settings one at a time, on one NVIDIA GPU.

    python3 tools/tracker_variants.py            # bench.py's loop, VGA
    python3 tools/tracker_variants.py --small    # tiny config, GPU against CPU
    python3 tools/tracker_variants.py --threads  # tracker against fusion thread, textured

Default: chip_smoke.py's 120 hardened bench frames through
ReconstructionPipeline (no fusion thread, no texture) under five
trackers: bench.py's (pipelined at depth 2, deferred promotion,
stale-frame refinement), that without deferred promotion, the
synchronous one with deferred promotion, bench.py's without the
refinement, and the synchronous one. Prints one JSON line each: frames/s,
ATE, map RMS and median (bench.py's Umeyama alignment), keyframes,
edges, stale frames, adopted refinements.

--small: the tiny config's orbit at 12, 14, 16 and 20 frames, each
tracker (synchronous, pipelined) on the GPU and on the CPU with the same
draws and every fetch landed at once (chip_smoke.LandedFetch): per-frame
position differences, keyframe pose differences and the share of
observed voxels whose sdf differs by more than 1e-4 m.

--threads: the same 120 frames through TexturedPipeline (as
chip_smoke.py's [pipeline-textured] and [pipeline-bench]) under the
synchronous and bench.py's tracker, each without and with the fusion
thread, in the order A B C D D C B A: frames/s of each run, and the
STOPWATCH stages (seconds) that the tracker and the thread move.

Run it from the repository root; it builds the kernels as chip_smoke.py
does and exits non-zero without CUDA.
"""

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def variants():
    cfg0 = c._tracked_config(False)
    _, poses, packed = c._frames(cfg0, 120, "cuda", harden=True)
    c.run_pipeline(c._pipeline_config(pipelined=True), packed[:10], "cuda")[0].close()
    scene = c._bench_scene()
    bench = c._pipeline_config(pipelined=True)
    runs = {
        "bench": bench,
        "bench, defer_promote off": bench.replace(
            tracking=dataclasses.replace(bench.tracking, defer_promote=False)),
        "synchronous, defer_promote on": bench.replace(
            parallel=dataclasses.replace(bench.parallel, pipelined_tracking=False)),
        "bench, refine_stale off": bench.replace(
            tracking=dataclasses.replace(bench.tracking, refine_stale=False)),
        "synchronous": c._pipeline_config(),
    }
    for name, cfg in runs.items():
        pipe, loop, _ = c.run_pipeline(cfg, packed, "cuda")
        m, _ = c._tracking_metrics(pipe.slam, poses)
        rms, med, n = c._map_error_mm(pipe, scene, np.stack(poses))
        print(json.dumps({"tracker": name, "fps": len(packed) / loop, "ate_mm": m["ate_mm"],
                          "map_rms_mm": rms, "map_median_mm": med, "verts": n,
                          "keyframes": m["keyframes"], "edges": m["edges"],
                          "loop_edges": m["loop_edges"], "stale": len(pipe.slam.stale_frames),
                          "refine_adopted": pipe.slam.refine_adopted,
                          "active_chunks": pipe.volume.n_active()}), flush=True)
        pipe.close()


def small():
    from texturefusion_torch.utils import async_fetch
    async_fetch.fetch_async = c.LandedFetch
    for pipelined in (False, True):
        for n in (12, 14, 16, 20):
            config = c._pipeline_config(small=True, pipelined=pipelined)
            _, packed = c._orbit_frames(config, n)
            g, cpu = (c.run_pipeline(config, packed, dev, c.cpu_draw_fn(config.tracking),
                                     textured=True)[0] for dev in ("cuda", "cpu"))
            diff = np.abs(g.trajectory()[:, :3, 3] - cpu.trajectory()[:, :3, 3]).max(-1) * 1e3
            nk = min(len(g.slam.keyframes), len(cpu.slam.keyframes))
            kdiff = np.abs(g.slam.poses[:nk, :3, 3] - cpu.slam.poses[:nk, :3, 3]).max(-1) * 1e3
            g_of = {tuple(r): s for s, r in zip(g.volume.active_slots(),
                                                g.volume.ids[g.volume.used].tolist())}
            c_of = {tuple(r): s for s, r in zip(cpu.volume.active_slots(),
                                                cpu.volume.ids[cpu.volume.used].tolist())}
            common = sorted(set(g_of) & set(c_of))
            gi, ci = [g_of[k] for k in common], [c_of[k] for k in common]
            seen = (g.volume.batch.weight[gi].cpu() > 0) | (cpu.volume.batch.weight[ci] > 0)
            frac = float(((g.volume.batch.sdf[gi].cpu() - cpu.volume.batch.sdf[ci]).abs()
                          > 1e-4)[seen].float().mean())
            print(json.dumps({"pipelined": pipelined, "frames": n,
                              "keyframe_frames": {d: [k.frame_index for k in p.slam.keyframes]
                                                  for d, p in (("gpu", g), ("cpu", cpu))},
                              "stale_equal": g.slam.stale_frames == cpu.slam.stale_frames,
                              "position_diff_mm_max": float(diff.max()),
                              "frames_over_0.01_mm": int((diff > 0.01).sum()),
                              "keyframe_diff_mm_max": float(kdiff.max()),
                              "sdf_frac_over_1e-4": frac}), flush=True)


def threads():
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    cfg0 = c._tracked_config(False)
    _, poses, packed = c._frames(cfg0, 120, "cuda", harden=True)
    c.run_pipeline(c._pipeline_config(pipelined=True), packed[:10], "cuda",
                   textured=True)[0].close()
    runs = {(tracker, thread): c._pipeline_config(async_fusion=thread,
                                                   pipelined=tracker == "bench")
            for tracker in ("synchronous", "bench") for thread in (False, True)}
    order = list(runs) + list(runs)[::-1]
    for key in order:
        STOPWATCH.reset()
        pipe, loop, _ = c.run_pipeline(runs[key], packed, "cuda", textured=True)
        t = STOPWATCH.totals
        print(json.dumps({"tracker": key[0], "fusion_thread": key[1],
                          "fps": len(packed) / loop, "loop_s": loop,
                          **{k: t[k] for k in ("preprocess", "tracking", "promotion",
                                               "t_stats_sync", "texture")}}), flush=True)
        pipe.close()


def main() -> int:
    c.phase_device()
    c.phase_build()
    args = sys.argv[1:]
    (small if "--small" in args else threads if "--threads" in args else variants)()
    return 0


if __name__ == "__main__":
    sys.exit(main())
