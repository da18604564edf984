"""Named-timer registry and span recorder for per-stage instrumentation.

A copy of texturefusion_tpu/utils/stopwatch.py (ref:
3rd_party/open_chisel/Stopwatch.h:48-110, printed per map cycle at
MobileFusion.cpp:108, aggregated into stat.txt at main.cpp:223-235).
CUDA work is asynchronous, so a timed block measures host-side dispatch
plus whatever the block waits on (a host read of a device value
synchronises; the wait spins on the CPU under CUDA's default schedule).

`STOPWATCH.time(name, **ids)` always adds to the aggregates (`totals`,
`counts`, `totals_cpu`: wall seconds, calls, thread CPU seconds) under a
lock, as `count(name, n)` does for pure event counters; both threads of
the pipeline write them. `STOPWATCH.time(name, offcpu=True, **ids)` also
adds the span's time off the CPU (wall less thread CPU time: waits for
the interpreter lock, preemption) to an aggregate of its own, named
name + OFFCPU, so that whatever reads `totals` and `counts` reads it. Between `start_recording()` and
`stop_recording()` each span is also kept as a `Span` in a bounded log
in memory: its thread, start and end (`time.perf_counter_ns`), thread
CPU time, the enclosing span on its thread and its ids (a child inherits
its parent's ids). On the thread that started the recording, and only
there, a span also opens a profiler range named "tf." + name, so that
a profile running meanwhile holds those spans (a profile records no host
op of a thread that existed before it started; these ranges are what
maps the other threads' spans onto the profile's clock:
tfbench/spans.py). The range is torch's RecordFunctionFast, the
RecordFunction that torch.profiler.record_function opens, without its
Python wrapper: ~0.3 us a span instead of ~10, and its end is read right
after the span's. While no recording is on, a span costs one flag test
more than the aggregates alone.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

SPAN_PREFIX = "tf."
OFFCPU = "_offcpu"
LOG_CAPACITY = 1 << 18
_wall = time.perf_counter_ns
_cpu = time.thread_time_ns


class Span:
    """One timed block of a recording. `t1` and `cpu` stay None for a
    span still open when the recording stopped; `parent` is the log index
    of the enclosing span on the same thread, -1 for a root; `tid` is the
    thread's native id and `ident` its Python ident."""

    __slots__ = ("name", "thread", "tid", "ident", "t0", "t1", "cpu", "parent", "ids")

    def __init__(self, name, thread, tid, ident, parent, ids):
        self.name, self.thread, self.tid, self.ident = name, thread, tid, ident
        self.t0 = self.t1 = self.cpu = None
        self.parent, self.ids = parent, ids


class _Timed:
    """The context manager `Stopwatch.time` returns. `aggregate` names the
    aggregate the span adds to at its exit (the span's name unless the
    block sets it: a name known only after the block ran); `offcpu`,
    whether its time off the CPU adds to aggregate + OFFCPU too."""

    __slots__ = ("sw", "name", "ids", "aggregate", "offcpu", "t0", "c0", "span", "rf", "gen")

    def __init__(self, sw: "Stopwatch", name: str, ids: dict, offcpu: bool):
        self.sw, self.name, self.ids, self.aggregate = sw, name, ids, name
        self.offcpu = offcpu
        self.span = self.rf = None

    def __enter__(self) -> "_Timed":
        if self.sw._recording:
            self.sw._open(self)
        self.t0 = _wall()
        self.c0 = _cpu()
        if self.span is not None:
            self.span.t0 = self.t0
        return self

    def __exit__(self, *exc) -> None:
        t1 = _wall()
        if self.rf is not None:         # the range ends next to the span's clock
            self.rf.__exit__(None, None, None)
        c1 = _cpu()
        sw, key = self.sw, self.aggregate
        with sw._lock:
            sw.totals[key] += (t1 - self.t0) * 1e-9
            sw.totals_cpu[key] += (c1 - self.c0) * 1e-9
            sw.counts[key] += 1
            if self.offcpu:
                sw.totals[key + OFFCPU] += ((t1 - self.t0) - (c1 - self.c0)) * 1e-9
                sw.counts[key + OFFCPU] += 1
        if self.span is not None:
            sw._close(self, t1, c1)


class Stopwatch:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # per-thread CPU time alongside wall time: separates host compute
        # from time off the CPU (interpreter-lock waits, preemption)
        self.totals_cpu: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self._recording = False
        self._owner: Optional[int] = None
        self._record_function = None
        self._log: List[Span] = []
        self._capacity = LOG_CAPACITY
        self._generation = 0
        self._local = threading.local()
        self.dropped = 0

    def time(self, name: str, offcpu: bool = False, **ids) -> _Timed:
        """A context manager timing its block under `name`; `ids` (frame,
        kf, cause, ...) go into the span log while a recording is on; with
        `offcpu`, the block's time off the CPU adds to name + OFFCPU."""
        return _Timed(self, name, ids, offcpu)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the pure event counter `name`."""
        with self._lock:
            self.counts[name] += n

    # ------------------------------------------------------------ recording

    def start_recording(self, capacity: int = LOG_CAPACITY) -> None:
        """Start a new span log, of at most `capacity` spans (spans past it
        are counted in `dropped`). The calling thread's spans also open
        profiler ranges named SPAN_PREFIX + name."""
        from torch._C._profiler import _RecordFunctionFast
        with self._lock:
            self._record_function = _RecordFunctionFast
            self._log, self._capacity, self.dropped = [], capacity, 0
            self._generation += 1
            self._owner = threading.get_ident()
            self._recording = True

    def stop_recording(self) -> List[Span]:
        """End the recording; returns its spans in the order they opened."""
        with self._lock:
            self._recording = False
            self._owner = None
            log, self._log = self._log, []
        return log

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, timed: _Timed) -> None:
        thread = threading.current_thread()
        stack = self._stack()
        with self._lock:
            if not self._recording:
                return
            gen = self._generation
            parent, ids = -1, timed.ids
            if stack and stack[-1][0] == gen:
                parent = stack[-1][1]
                ids = {**self._log[parent].ids, **ids}
            if len(self._log) >= self._capacity:
                self.dropped += 1
                return
            span = Span(timed.name, thread.name, thread.native_id, thread.ident, parent, ids)
            index = len(self._log)
            self._log.append(span)
            owner = thread.ident == self._owner
        stack.append((gen, index))
        timed.span, timed.gen = span, gen
        if owner:
            timed.rf = self._record_function(SPAN_PREFIX + timed.name)
            timed.rf.__enter__()

    def _close(self, timed: _Timed, t1: int, c1: int) -> None:
        if self._recording and timed.gen == self._generation:
            timed.span.t1, timed.span.cpu = t1, c1 - timed.c0
        self._stack().pop()

    # ------------------------------------------------------------ aggregates

    def averages_ms(self) -> Dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1) for k in list(self.totals)}

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.averages_ms().items()):
            cpu = 1000.0 * self.totals_cpu.get(k, 0.0) / max(self.counts[k], 1)
            lines.append(f"{k:>16s}: {v:8.2f} ms avg "
                         f"(cpu {cpu:7.2f}) ({self.counts[k]}x)")
        for k in sorted(self.counts):
            if k not in self.totals:    # pure event counters
                lines.append(f"{k:>16s}: {self.counts[k]} events")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.totals_cpu.clear()
            self.counts.clear()


STOPWATCH = Stopwatch()
