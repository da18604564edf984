"""Frame prefetcher: the next frame's upload in flight while this one runs.

Port of texturefusion_tpu/io/prefetch.py, which overlaps transfers with
compute through `jax.device_put`. Here each numpy array of a frame is
copied into its own pinned host tensor and sent with
`.to(device, non_blocking=True)`, one frame ahead. A pinned tensor is
never rewritten: each frame gets a new one, and PyTorch's caching host
allocator does not hand its memory out again until the copy's stream
has passed it. On a CPU device the arrays pass through as tensors.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


def upload(x, device: torch.device):
    """One array element on `device`: numpy arrays through a fresh pinned
    buffer and a non-blocking copy when the device is CUDA; tensors moved
    as they are; anything else unchanged."""
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


def prefetch_frames(frames: Iterable[Tuple], device="cuda",
                    keep_host: bool = False) -> Iterator[Tuple]:
    """Wrap an iterable of frame tuples; yields the same tuples with their
    arrays on `device`, uploaded one frame ahead. keep_host=True appends
    the original (host) tuple, so that a consumer reads host bytes (a
    keyframe's rgb for the atlas) from RAM instead of the device."""
    device = torch.device(device)
    it = iter(frames)

    def put(item):
        dev = tuple(upload(x, device) for x in item)
        return dev + (item,) if keep_host else dev

    try:
        pending = put(next(it))
    except StopIteration:
        return
    for item in it:
        nxt = put(item)        # in flight while the caller runs `pending`
        yield pending
        pending = nxt
    yield pending
