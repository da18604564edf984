"""The traced stretch of a `--trace 1` run: torch.profiler over a steady
run of frames, reduced to what the per-layer readers and the result's
`device` and `breakdown` take.

The stretch starts and ends with the fusion thread joined and the device
synchronized, so every device op of the work launched inside it lies in
the trace, and no other. torch.profiler loses the first device events of
a session (texturefusion_torch/utils/devtime.py measured it on an H100):
the stretch is fenced by MARKERS launches of ATen's spin kernel on each
side, which take the loss and are left out, as there. The traced window
is the host span of the stretch (a record_function range), in the
profiler's clock, which its device events share.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MARKERS = 256
MARKER_KERNEL = "spin_kernel"
WINDOW = "tfbench.traced_stretch"
TOP = 10
GAPS_NAMED = 200
NAME_CHARS = 120


def fence() -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(0.02)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(prof) -> Dict:
    """From a finished profile: the window (us), the device ops in it
    (name, start, end; markers left out), the union of their intervals,
    busy and window seconds, time by op name, and the idle gaps named by
    the innermost host op under each gap's midpoint. Raises when the
    trace lost the head fence (its first device op is not a marker) or
    holds no window."""
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    if not win:
        raise RuntimeError("the traced stretch's range is missing from the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    # device ops: kernels, copies and fills (record_function ranges also
    # show on the device's timeline, as user annotations: not ops)
    dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and e.name != WINDOW),
                 key=lambda e: e.time_range.start)
    if not dev or MARKER_KERNEL not in dev[0].name:
        raise RuntimeError("torch.profiler lost the head fence of the traced stretch")
    ops = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev
           if MARKER_KERNEL not in e.name and e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union([(a, b) for _, a, b in ops if b > a])
    by_name: Dict[str, float] = {}
    for name, a, b in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.name != WINDOW]
    h0 = np.asarray([e.time_range.start for e in host], np.float64)
    h1 = np.asarray([e.time_range.end for e in host], np.float64)

    def host_at(t: float) -> str:
        """The innermost (shortest) host op running at time t."""
        hit = np.nonzero((h0 <= t) & (t <= h1))[0]
        if not len(hit):
            return "python (no op)"
        return host[int(hit[np.argmin((h1 - h0)[hit])])].name

    # the longest gaps, named and summed by name
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    for a, b in gaps[:GAPS_NAMED]:
        n = host_at((a + b) / 2)
        named[n] = named.get(n, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "by_name": by_name, "ops": ops,
            "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:TOP]}


def top_ops(by_name: Dict[str, float]) -> List[list]:
    return [[n[:NAME_CHARS], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


class Stretch:
    """A session hook that traces frames [first, last) of its session:
    at frame `first` it joins the fusion thread, synchronizes, fences
    and starts the profiler; at frame `last` (or the session's end) it
    joins, synchronizes, fences and stops. The trace is reduced by
    `result()`, after the session. `on_start(pipe)` / `on_stop(pipe)`
    run right after the first fence and right before the last one, with
    the device idle and outside the traced window, to snapshot the
    program's counters and state."""

    def __init__(self, first: int, last: int, on_start=None, on_stop=None):
        self.first, self.last = first, last
        self.on_start, self.on_stop = on_start, on_stop
        self.prof = None
        self.range = None
        self.done = None                # the finished profile, reduced after the session

    def __call__(self, pipe, i: int) -> None:
        if i == self.first and self.prof is None and self.done is None:
            from torch.profiler import ProfilerActivity, profile
            pipe._drain_fusion()
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            fence()
            if self.on_start is not None:
                self.on_start(pipe)
            self.range = torch.profiler.record_function(WINDOW)
            self.range.__enter__()
        elif self.prof is not None and i >= self.last:
            pipe._drain_fusion()
            torch.cuda.synchronize()
            self.range.__exit__(None, None, None)
            if self.on_stop is not None:
                self.on_stop(pipe)
            fence()
            self.prof.__exit__(None, None, None)
            self.done, self.prof, self.range = self.prof, None, None

    def result(self) -> Optional[Dict]:
        """The reduced trace, or None when the stretch was not traced."""
        return None if self.done is None else reduce(self.done)
