"""Timing of one device program: the host clock, CUDA events, and the
device ops that torch.profiler records.

`measure(fn, device, n)` gives
  ms         - the median host clock of n calls, each ending in a
               synchronize (the JAX measurement scripts' clock: a call
               then block_until_ready);
  span_ms    - the median of n CUDA-event pairs, each around one call:
               the device's time from the first op to the last, with the
               host's dispatch gaps between them;
  device_ms  - the summed durations of the device ops (kernels, copies,
               fills) of a call traced by torch.profiler (the mean of 3);
  device_ops - their count a call.
The traced calls are made apart from the timed ones, since the profiler
adds host overhead. Off CUDA the last three are None: a CPU run gives no device
number.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the card's work when `device` is a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn: Callable, device, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def span_ms(fn: Callable, n: int) -> float:
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# torch.profiler loses the first few device events of each session, more
# the more sessions the process has traced (none at first, seven after a
# few sessions of tens of thousands of events, on an H100 with torch 2.11):
# the traced calls are fenced by MARKERS launches of ATen's spin kernel
# (torch.cuda._sleep) on each side, which take the loss and are left out of
# the count. A session that kept no marker before the calls' first event
# may have lost some of them, and is taken again.
MARKERS = 256
MARKER_KERNEL = "spin_kernel"
TRACE_PAD_S = 0.02
TRACE_TRIES = 3


def _fence(device) -> None:
    for _ in range(MARKERS):
        torch.cuda._sleep(1)
    sync(device)
    time.sleep(TRACE_PAD_S)


def traced(fn: Callable, device, calls: int = 3) -> Tuple[float, float]:
    """(device ms, device ops) a call: `calls` fn() calls, each ending in a
    synchronize, under one torch.profiler session fenced by marker
    launches; their device ops summed and divided by `calls`. Raises when
    TRACE_TRIES sessions all lost the head fence or caught no device op
    of the calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _fence(device)
            for _ in range(calls):
                fn()
                sync(device)
            _fence(device)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        ops = [e for e in events if MARKER_KERNEL not in e.name]
        if ops and MARKER_KERNEL in events[0].name:
            return sum(e.time_range.elapsed_us() for e in ops) * 1e-3 / calls, len(ops) / calls
    raise RuntimeError(f"torch.profiler kept no whole trace of {fn} in {TRACE_TRIES} sessions")


def measure(fn: Callable, device, n: int = 10, warm: int = 1) -> dict:
    """ms, span_ms, device_ms and device_ops of fn() (module docstring),
    after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    sync(device)
    out = {"ms": host_ms(fn, device, n), "span_ms": None, "device_ms": None,
           "device_ops": None}
    if torch.device(device).type == "cuda":
        out["span_ms"] = span_ms(fn, n)
        out["device_ms"], out["device_ops"] = traced(fn, device)
    return out


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, or None
    where there is no nvidia-smi."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]
