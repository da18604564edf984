"""The benchmark of texturefusion_torch: whole textured scans on one card.

    python3 tfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name. BENCHMARK.json, at the checkout's root,
names each cell's configuration and traffic mix and the metrics; the
configuration is tfbench/configs/<config>.json, the traffic mix
tfbench/traffic/<traffic>.json, each metric's reader
tfbench/metrics/<metric>.py (UNIT and read(run)), and the limits of the
comparison that decides `correct` tfbench/limits/<cell>.json. A new
cell, mix, configuration or metric is a new file; no file here changes.

A run: set-up (the kernels built on a checkout's first run, the
session's clean frames rendered on the card, one warm session of
`warm_frames` frames and finish() through a throwaway pipeline), then
the measured window: sessions (tfbench/session.py) back to back, each
with its own sensor noise drawn on the card from (seed, session), a new
one started only while `--seconds` has time left, the last one run to
its end. With --trace 1 the first session's frames `trace_frames` are
traced (tfbench/trace.py); the program's STOPWATCH spans of that stretch
are taken out of the window's, so the per-layer spans come from frames
run without the profiler. After the window: the memory peak, the
program's state freed, the comparison (tfbench/reference/check.py)
against the ground truth the benchmark made. The last line on standard
output is the result; the numbers compared, each beside its limit, are
the last lines on standard error and the result's last key, "checks".
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "tfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "texturefusion_tpu")
CACHE = os.path.join(ROOT, ".tfbench_cache")


def log(msg: str) -> None:
    print(f"[tfbench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(name: str, here: str = HERE):
    """tfbench/metrics/<name>.py as a module (UNIT, read)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: Dict, workload: str, here: str = HERE) -> Cell:
    """The cell `workload` of BENCHMARK.json `bench`, with the files its
    names lead to under `here`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = load_json(here, "configs", f"{w['config']}.json")
    mix = load_json(here, "traffic", f"{w['traffic']}.json")
    limits = load_json(here, "limits", f"{workload}.json")
    return Cell(workload, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)])


@dataclasses.dataclass
class SessionRecord:
    timing: object                  # session.Timing
    outputs: object                 # session.Outputs


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    seed: int
    setup_s: float
    window_s: float
    sessions: List[SessionRecord]
    stopwatch_totals: Dict[str, float]
    stopwatch_counts: Dict[str, int]
    trace: Optional[Dict] = None
    k2: Optional[Dict] = None
    peak: Optional[Dict] = None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the port's own nvcc output is texturefusion_torch/_build/)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"tfbench: needs {n} CUDA device(s), found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def graph_programs() -> int:
    from texturefusion_torch.models.reconstruction import FRAME_STEP_PROGRAMS
    from texturefusion_torch.slam.promote import PROBE_PROGRAMS
    return len(FRAME_STEP_PROGRAMS.programs) + len(PROBE_PROGRAMS.programs)


def k2_counters() -> Dict:
    from texturefusion_torch.ops import cuda_kernels as ck
    return {"launches": ck.LAUNCHES["tsdf_integrate"] + ck.LAUNCHES["tsdf_integrate_frames"],
            "single_lanes": ck.LANES["tsdf_integrate"], "frame_shapes": dict(ck.FRAME_SHAPES)}


def k2_rows(pipe) -> Dict:
    """Host copies of the volume's weight and colour-count rows, the
    state K2 writes back."""
    batch = pipe.volume.dense_batch()[0]
    return {"weight": batch.weight.cpu().numpy(), "ccnt": batch.color_count.cpu().numpy()}


def k2_delta(a: Dict, b: Dict) -> Dict:
    """K2's work between two snapshots: launches, one-frame lanes, F-frame
    shapes, and the voxels it wrote back (weight changed to non-zero) and
    whose colour it wrote (colour count changed)."""
    shapes = {k: v - a["frame_shapes"].get(k, 0) for k, v in b["frame_shapes"].items()}
    wa, wb = a["rows"]["weight"], b["rows"]["weight"]
    return {"launches": b["launches"] - a["launches"],
            "single_lanes": b["single_lanes"] - a["single_lanes"],
            "frame_shapes": {k: v for k, v in shapes.items() if v},
            "written": int(np.count_nonzero((wa != wb) & (wb != 0))),
            "coloured": int(np.count_nonzero(a["rows"]["ccnt"] != b["rows"]["ccnt"]))}


def stopwatch_state():
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    return dict(STOPWATCH.totals), dict(STOPWATCH.counts)


def stopwatch_minus(after, during_a, during_b):
    """The STOPWATCH totals and counts `after` less what accrued between
    the snapshots during_a and during_b."""
    out = []
    for i in (0, 1):
        d = {k: v - during_a[i].get(k, 0) for k, v in during_b[i].items()}
        out.append({k: v - d.get(k, 0) for k, v in after[i].items()})
    return out


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float):
    """Set-up and the window of one run on `device`. Returns (Run, the
    ground-truth poses of a session, memory peak bytes or None)."""
    import torch

    from tfbench import session
    from tfbench.traffic.generator import Traffic
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH

    dev = torch.device(device)
    config = session.pipeline_config(cell.config["pipeline"])
    cls = session.pipeline_class(cell.config["pipeline_class"])
    mix = cell.mix
    if dev.type == "cuda":
        cuda_kernels.build()
    traffic = Traffic(mix, cell.config, dev)
    traffic.render()
    # the warm session: the kernels' first launches, the two captured
    # programs, cuSOLVER, the texture stage's first cycle
    warm = traffic.session(seed, -1, n=int(mix["warm_frames"]))
    pipe, _ = session.run(cls, config, warm, dev)
    pipe.close()
    del pipe, warm
    programs = graph_programs() if dev.type == "cuda" else 0
    STOPWATCH.reset()
    cuda_kernels.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({programs} captured programs)")

    rng = np.random.default_rng([seed % (1 << 64), 7])
    records, k2 = [], {}
    stretch = None
    t0 = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t0 < seconds:
        frames = traffic.session(seed, k)
        hook = None
        if trace and k == 0:
            from tfbench.trace import Stretch
            first, last = mix["trace_frames"]
            stretch = hook = Stretch(
                first, min(last, traffic.n),
                on_start=lambda p: k2.update(a=dict(k2_counters(), rows=k2_rows(p)),
                                             sw_a=stopwatch_state()),
                on_stop=lambda p: k2.update(b=dict(k2_counters(), rows=k2_rows(p)),
                                            sw_b=stopwatch_state()))
        sw0 = stopwatch_state()
        pipe, timing = session.run(cls, config, frames, dev, hook=hook)
        out = session.extract(pipe, rng)
        pipe.close()
        del pipe, frames
        records.append(SessionRecord(timing, out))
        log(f"session {k}: {len(timing.frame_s)} frames in {timing.seconds:.3f} s, finish "
            f"{timing.finish_s:.3f} s, {out.keyframes} keyframes, {out.active_chunks} chunks, "
            f"{len(out.verts)} vertices")
        sw1 = stopwatch_state()
        log(f"session {k} stopwatch s: " + json.dumps(
            {n: round(v - sw0[0].get(n, 0.0), 4) for n, v in sorted(sw1[0].items())}))
        k += 1
    window_s = time.perf_counter() - t0
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        if graph_programs() != programs:
            log(f"{graph_programs() - programs} programs were captured inside the window")
    totals, counts = stopwatch_state()
    if stretch is not None and stretch.done is not None:
        totals, counts = stopwatch_minus((totals, counts), k2["sw_a"], k2["sw_b"])
    run = Run(seed=seed, setup_s=setup_s, window_s=window_s, sessions=records,
              stopwatch_totals=totals, stopwatch_counts=counts)
    if stretch is not None and stretch.done is not None:
        run.trace = stretch.result()
        run.k2 = k2_delta(k2["a"], k2["b"])
    return run, traffic.poses, peak


def numbers(cell: Cell, run: Run, gt) -> Dict[str, float]:
    """Every compared number of the run: each session's, the worst over
    them."""
    from tfbench.reference import check
    from tfbench.reference.scene import Scene
    scene = Scene(cell.config["scene"])
    voxel = cell.config["pipeline"]["tsdf"]["voxel_resolution"]
    samples = check.surface(scene, cell.config, gt, run.seed)
    per = [check.session_numbers(s.outputs, gt, scene, voxel, samples) for s in run.sessions]
    for i, p in enumerate(per):
        log(f"session {i} numbers: " + " ".join(f"{k}={v:.4f}" for k, v in p.items()))
    return check.run_numbers(per)


def compare(cell: Cell, run: Run, gt) -> Dict[str, dict]:
    """The comparison: the run's numbers judged against the cell's
    limits."""
    from tfbench.reference import check
    return check.judge(numbers(cell, run, gt), cell.limits)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    readers = {m["name"]: load_reader(m["name"])
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    set_cache_dirs()
    require_cards(cell.chips)
    import torch

    name = torch.cuda.get_device_name(0)
    card_peak = load_json(HERE, "peaks.json").get(name)
    if args.trace and card_peak is None:
        raise RuntimeError(f"tfbench/peaks.json has no entry for {name!r}")
    run, gt, peak = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    run.peak = card_peak
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 4
    judged = compare(cell, run, gt)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": name, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(j["ok"] for j in judged.values()),
              "attempted": sum(len(s.timing.frame_s) for s in run.sessions), "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        from tfbench.trace import top_ops
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": top_ops(run.trace["by_name"]),
                               "idle_gaps": [list(g) for g in run.trace["idle_gaps"]]}
    log(f"window {run.window_s:.3f} s, {len(run.sessions)} sessions; metrics "
        + json.dumps(metrics))
    result["checks"] = {k: {"value": j["value"] if math.isfinite(j["value"]) else None,
                            "limit": j["limit"]} for k, j in judged.items()}
    for k, j in judged.items():
        print(f"check {k} {j['value']} limit {j['limit']} {'ok' if j['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def entry(t_start: float) -> int:
    try:
        return main(t_start=t_start)
    except SystemExit:
        raise
    except Exception:           # noqa: BLE001 - the run's boundary: report, no result line
        traceback.print_exc()
        return 1
