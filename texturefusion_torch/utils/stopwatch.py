"""Named-timer registry for per-stage instrumentation.

A copy of texturefusion_tpu/utils/stopwatch.py (ref:
3rd_party/open_chisel/Stopwatch.h:48-110, printed per map cycle at
MobileFusion.cpp:108, aggregated into stat.txt at main.cpp:223-235).
CUDA work is asynchronous, so a timed block measures host-side dispatch
plus whatever the block waits on (a host read of a device value
synchronises); use torch.profiler for device timelines.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

# TF_SLOW_LOG=1: print every timed block over 50 ms with its thread
_SLOW_LOG = bool(os.environ.get("TF_SLOW_LOG"))


class Stopwatch:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # per-thread CPU time alongside wall time: separates host compute
        # from waits on the device in the report
        self.totals_cpu: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.totals_cpu[name] += time.thread_time() - c0
            self.counts[name] += 1
            if _SLOW_LOG and dt > 0.05:
                import sys
                import threading
                print(f"[slow] {name} {dt * 1e3:.1f} ms "
                      f"on {threading.current_thread().name}",
                      file=sys.stderr)

    def add(self, name: str, seconds: float) -> None:
        """Count a block timed by the caller (one whose name is known
        only after it ran)."""
        self.totals[name] += seconds
        self.counts[name] += 1

    def tick(self, name: str) -> None:
        self.totals[f"_tick_{name}"] = time.perf_counter()

    def tock(self, name: str) -> None:
        t0 = self.totals.pop(f"_tick_{name}", None)
        if t0 is not None:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def averages_ms(self) -> Dict[str, float]:
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals if not k.startswith("_tick_")}

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
        self.totals.clear()
        self.totals_cpu.clear()
        self.counts.clear()


STOPWATCH = Stopwatch()
