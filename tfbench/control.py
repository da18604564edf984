"""The readings the limits of tfbench/limits/<cell>.json are set from.

    python3 tfbench/control.py --workload <cell> --seeds 1,2,3 [--control <name>]
                               [--patch JSON]

For each seed, one session of the cell's traffic (the harness's set-up,
then a window of one session), judged by the harness's comparison; one
JSON line a seed on standard output with every number the comparison
computes (those the cell's limits name decide `correct`), the
session's time and its counts, and a last line with the largest of each
number over the seeds. With --control <name> the pipeline is given
tfbench/controls/<name>.json's patch of the configuration's "pipeline"
entry: what the program is told differs from what the frames were taken
with, so one guarantee the configuration states is broken (the control
of the comparison: it has to come out not correct). --patch applies an
inline patch the same way (sizing a configuration). The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfbench import harness  # noqa: E402
from tfbench.reference import check  # noqa: E402


def patched(base: dict, patch: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in patch.items():
        out[k] = patched(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", default=None)
    ap.add_argument("--patch", default=None)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), args.workload)
    patch = {}
    if args.control:
        patch = harness.load_json(harness.HERE, "controls", f"{args.control}.json")
        patch = {k: v for k, v in patch.items() if k != "why"}
    if args.patch:
        patch = patched(patch, json.loads(args.patch))
    cell.config = patched(cell.config, patch)
    harness.set_cache_dirs()
    harness.require_cards(1)
    import torch

    from texturefusion_torch.ops import cuda_kernels
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, gt, peak = harness.measure(cell, seed, 0.0, False, "cuda:0", t0)
        nums = harness.numbers(cell, run, gt)
        judged = check.judge(nums, cell.limits)
        s = run.sessions[0]
        shapes = cuda_kernels.FRAME_SHAPES
        line = {"seed": seed, "control": args.control, "patch": patch,
                "numbers": nums,
                "correct": all(j["ok"] for j in judged.values()),
                "session_s": s.timing.seconds, "finish_s": s.timing.finish_s,
                "setup_s": run.setup_s, "keyframes": s.outputs.keyframes,
                "active_chunks": s.outputs.active_chunks, "verts": len(s.outputs.verts),
                "textured_verts": len(s.outputs.tex_verts),
                "meshed_verts": s.outputs.meshed_verts,
                "export_verts": len(s.outputs.export_verts), "memory_peak_bytes": peak,
                "k2_launches": dict(cuda_kernels.LAUNCHES), "k2_lanes": dict(cuda_kernels.LANES),
                "frame_launch_max_lanes": max((u for _, u, _ in shapes), default=0),
                "stopwatch_s": {k: round(v, 4) for k, v in sorted(run.stopwatch_totals.items())},
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        for k, v in line["numbers"].items():
            worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"control": args.control, "largest": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
