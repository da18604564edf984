"""The program's span log on the device trace's clock: where the card's
idle time goes, thread by thread, and BA's CUDA launches a round.

    python3 -m tfbench.spanlog --workload <cell> --seed <n>

run from the root of a checkout, sets a cell up as `tfbench/run.py`
does (the kernels built, the frames rendered, the warm session) and runs
one session with its frames `trace_frames` traced as a `--trace 1` run
traces them (tfbench/trace.py), with the program's STOPWATCH recording
its span log over the stretch (texturefusion_torch/utils/stopwatch.py).
Standard error gets the clock fit, the device's idle time split by the
innermost span open on each thread, and the named idle gaps; the last
line on standard output is a JSON summary. The benchmark's own runs do
not record the span log; this is a diagnosis beside them.

torch.profiler records no host op of a thread that existed before the
profile started, so the fusion thread's spans are not in the trace: the
tracking thread's spans, which are in it as "tf." ranges too, fit the
offset between the log's clock (perf_counter_ns) and the profile's, and
every span is put on the profile's clock with it. The CUDA runtime's
calls are traced for the whole process (CUPTI) and carry their thread:
kineto's resource id, a thread's system id (the tracking thread's ranges
and runtime calls alike) or, for runtime calls of a thread the profiler
does not record, the low 32 bits of its pthread id (as a signed number).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tfbench import harness, trace

SPAN_PREFIX = "tf."
JOIN = "tfbench.closing_join"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")
NO_SPAN = "(no span)"
SHOWN = 12


def host_rows(prof) -> List[Tuple[str, int, float, float]]:
    """The profile's host events (ops, ranges, CUDA runtime calls) as
    (name, thread id, start, end): kineto's resource id, times in us on
    the clock of prof.events()."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), int(e.device_resource_id()), (e.start_ns() - t0) * 1e-3,
             (e.end_ns() - t0) * 1e-3)
            for e in results.events() if e.device_type() == cpu]


def idle_gaps(prof, ops) -> List[Tuple[float, float]]:
    """The device's idle intervals (us) inside the traced window of
    `prof`, given the window's device ops (trace.reduce's `ops`)."""
    win = [e for e in prof.events() if e.name == trace.WINDOW][0]
    w0, w1 = win.time_range.start, win.time_range.end
    gaps, prev = [], w0
    for a, b in trace._union([(a, b) for _, a, b in ops if b > a]) + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return gaps


def fit_clock(rows, spans) -> Dict:
    """The offset (ns) from the span log's clock (perf_counter_ns) to the
    profile's: the median, over the spans of the thread that recorded
    them as "tf." ranges (the anchors), of each range's end less its
    span's end (a range ends right after its span's clock is read; its
    start follows more variable work), and the largest residual (us).
    Spans and ranges are paired in order, name by name. Also returns the
    pairs (log index, (start, end) of its range)."""
    ranges = sorted((r for r in rows if r[0].startswith(SPAN_PREFIX)), key=lambda r: r[2])
    tids = {r[1] for r in ranges}
    by_name: Dict[str, List[int]] = {}
    for i, s in enumerate(spans):
        if s.tid in tids and s.t1 is not None:
            by_name.setdefault(s.name, []).append(i)
    taken: Dict[str, int] = {}
    pairs = []
    for name, tid, a, b in ranges:
        name = name[len(SPAN_PREFIX):]
        k = taken.get(name, 0)
        mine = by_name.get(name, [])
        if k < len(mine) and spans[mine[k]].tid == tid:
            pairs.append((mine[k], (a, b)))
        taken[name] = k + 1
    if not pairs:
        raise RuntimeError("the trace holds none of the program's spans as ranges")
    offsets = np.asarray([b * 1e3 - spans[i].t1 for i, (_, b) in pairs], np.float64)
    offset = float(np.median(offsets))
    return {"offset_ns": offset, "residual_us": float(np.max(np.abs(offsets - offset))) * 1e-3,
            "anchors": len(pairs), "pairs": pairs}


def innermost(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """One thread's spans (dicts with name, start, end; nested) as the
    intervals over which the innermost open span stays the same: (start,
    end, its name), sorted and disjoint. A child is cut at its parent's
    end."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []         # (end, name) of the open spans
    cur = -np.inf

    def close_until(t: float) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for s in sorted(spans, key=lambda s: (s["start"], -s["end"])):
        a, b = s["start"], s["end"]
        close_until(a)
        if stack:
            if a > cur:
                out.append((cur, a, stack[-1][1]))
            b = min(b, stack[-1][0])
        cur = max(cur, a)
        stack.append((b, s["name"]))
    close_until(np.inf)
    return out


def overlap(gaps: List[Tuple[float, float]], segments) -> Dict[str, float]:
    """Seconds of the sorted, disjoint intervals `gaps` (us) that each
    label of the sorted, disjoint (start, end, label) `segments` covers."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
            if hi > lo:
                out[segments[k][2]] = out.get(segments[k][2], 0.0) + (hi - lo) * 1e-6
            k += 1
    return out


def span_keys(rows, spans, gaps: List[Tuple[float, float]]) -> Dict:
    """The span log on the profile's clock. `rows`: host_rows; `spans`:
    the STOPWATCH's log; `gaps`: the device's idle intervals in the
    window (us). Keys: `clock` (the fit's offset, largest residual and
    anchor count); `spans` (each finished span as a dict: name, thread,
    tid, ident, start and end in us on the profile's clock (an anchor's
    own range), parent, ids); `launches` (the runtime's launch, copy and
    fill calls: (name, thread id as an unsigned 32-bit number, start,
    end)); `threads` (thread name: [system id, low 32 bits of its pthread
    id], the ids its events may carry); `idle_s`; `idle_by_span` (thread
    name: [innermost span open, idle seconds], NO_SPAN where it has none
    open) and `idle_unspanned_s` (idle seconds where no thread has a span
    open)."""
    clock = fit_clock(rows, spans)
    exact = dict(clock.pop("pairs"))
    off = clock["offset_ns"]
    out = []
    for i, s in enumerate(spans):
        if s.t1 is None:
            continue
        a, b = exact.get(i, ((s.t0 + off) * 1e-3, (s.t1 + off) * 1e-3))
        out.append({"name": s.name, "thread": s.thread, "tid": s.tid, "ident": s.ident,
                    "start": a, "end": b, "parent": s.parent, "ids": s.ids})
    threads = {s["thread"]: [s["tid"], s["ident"] & 0xFFFFFFFF] for s in out}
    idle_s = sum(b - a for a, b in gaps) * 1e-6
    by_thread = {}
    for name in threads:
        got = overlap(gaps, innermost([s for s in out if s["thread"] == name]))
        got[NO_SPAN] = max(0.0, idle_s - sum(got.values()))
        by_thread[name] = sorted(([k, v] for k, v in got.items()), key=lambda kv: -kv[1])
    covered = overlap(gaps, [(a, b, "") for a, b in
                             trace._union([(s["start"], s["end"]) for s in out])])
    launches = [(n, tid & 0xFFFFFFFF, a, b) for n, tid, a, b in rows if n in LAUNCHES]
    return {"clock": clock, "spans": out, "launches": launches, "threads": threads,
            "idle_s": idle_s, "idle_by_span": by_thread,
            "idle_unspanned_s": max(0.0, idle_s - covered.get("", 0.0))}


def launches_per_round(keys: Dict, name: str = "ba_gn_round") -> Optional[float]:
    """The runtime launches (LAUNCHES) that start inside the spans `name`
    on the spans' own thread, by the profile's thread id, per span: the
    fusion thread's calls made meanwhile carry its own id and are not
    counted. None without such spans."""
    rounds = [s for s in keys["spans"] if s["name"] == name]
    if not rounds:
        return None
    starts: Dict[int, List[float]] = {}
    for _, tid, a, _ in keys["launches"]:
        starts.setdefault(tid, []).append(a)
    for v in starts.values():
        v.sort()
    n = 0
    for r in rounds:
        mine = starts.get(r["tid"], [])
        n += bisect.bisect_right(mine, r["end"]) - bisect.bisect_left(mine, r["start"])
    return n / len(rounds)


def reduce(prof, spans) -> Dict:
    """trace.reduce(prof), and with the span log `spans` what span_keys
    adds."""
    out = trace.reduce(prof)
    if spans:
        out.update(span_keys(host_rows(prof), spans, idle_gaps(prof, out["ops"])))
    return out


class RecordingStretch(trace.Stretch):
    """trace.Stretch with the program's STOPWATCH recording its span log
    from the profile's start to its stop (`spans`), and its closing join
    of the fusion thread a range of its own (JOIN), which names the idle
    time it waits."""

    def __init__(self, first: int, last: int):
        super().__init__(first, last)
        self.spans = None

    def __call__(self, pipe, i: int) -> None:
        from texturefusion_torch.utils.stopwatch import STOPWATCH
        idle = self.prof is None and self.done is None
        if self.prof is not None and i >= self.last:
            with torch.profiler.record_function(JOIN):
                pipe._drain_fusion()
                torch.cuda.synchronize()
        super().__call__(pipe, i)
        if idle and self.prof is not None:
            STOPWATCH.start_recording()
        elif self.done is not None and self.spans is None:
            self.spans = STOPWATCH.stop_recording()

    def result(self) -> Optional[Dict]:
        return None if self.done is None else reduce(self.done, self.spans)


def summary(tr: Dict) -> Dict:
    """What the command prints of a reduced trace with its span log."""
    rounds = [s for s in tr["spans"] if s["name"] == "ba_gn_round"]
    return {"clock": tr["clock"], "spans": len(tr["spans"]), "threads": tr["threads"],
            "window_s": tr["window_s"], "idle_s": tr["idle_s"],
            "device_idle_share": 1.0 - tr["busy_s"] / tr["window_s"],
            "idle_unspanned_s": tr["idle_unspanned_s"],
            "idle_by_span": {k: v[:SHOWN] for k, v in tr["idle_by_span"].items()},
            "idle_gaps": [list(g) for g in tr["idle_gaps"]],
            "ba_rounds": len(rounds), "ba_launches_per_round": launches_per_round(tr),
            "ba_round_ms_traced": (sum(s["end"] - s["start"] for s in rounds) / len(rounds) * 1e-3
                                   if rounds else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), args.workload)
    harness.set_cache_dirs()
    harness.require_cards(cell.chips)
    from tfbench import session
    from tfbench.traffic.generator import Traffic
    from texturefusion_torch.ops import cuda_kernels

    dev = torch.device("cuda:0")
    config = session.pipeline_config(cell.config["pipeline"])
    cls = session.pipeline_class(cell.config["pipeline_class"])
    cuda_kernels.build()
    traffic = Traffic(cell.mix, cell.config, dev)
    traffic.render()
    pipe, _ = session.run(cls, config, traffic.session(args.seed, -1,
                                                       n=int(cell.mix["warm_frames"])), dev)
    pipe.close()
    first, last = cell.mix["trace_frames"]
    stretch = RecordingStretch(first, min(last, traffic.n))
    pipe, timing = session.run(cls, config, traffic.session(args.seed, 0), dev, hook=stretch)
    pipe.close()
    tr = stretch.result()
    if tr is None or "clock" not in tr:
        harness.log("the stretch was not traced, or the program recorded no span")
        return 1
    out = summary(tr)
    c = out["clock"]
    harness.log(f"span clock: offset {c['offset_ns']:.0f} ns, largest residual "
                f"{c['residual_us']:.3f} us over {c['anchors']} anchors; {out['spans']} spans, "
                f"threads {sorted(out['threads'])}")
    harness.log(f"device idle {out['idle_s']:.6f} s of a {out['window_s']:.6f} s window, "
                f"{out['idle_unspanned_s']:.6f} s under no thread's span")
    for thread, split in sorted(out["idle_by_span"].items()):
        harness.log(f"device idle under {thread}'s innermost span: " + json.dumps(split))
    harness.log(f"session: {len(timing.frame_s)} frames in {timing.seconds:.3f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
