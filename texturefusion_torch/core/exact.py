"""Arithmetic that rounds the same on the CPU and on a CUDA device.

The tracker's discrete decisions (FAST corners, descriptor bits, matches,
keyframe promotions) follow from float comparisons, so a last-bit
difference between the two devices can flip a decision and move the
trajectory by millimetres. Two of PyTorch's shortcuts make such
differences on a CUDA device where the CPU rounds otherwise:

- `x / s` by a Python number multiplies by the reciprocal of s on a CUDA
  device and divides on the CPU (`div`);
- a reduction sums in an order of its own on each device (`tree_sum`).

Elementwise +, −, ×, ÷ and sqrt between tensors round correctly on both,
so an expression built of them in a fixed order gives the same bits.
"""

from __future__ import annotations

import torch

_DIVISORS: dict = {}    # 0-dim divisors per (value, dtype, device), made once by a
                        # fill on the device (no copy from the host, which a
                        # captured CUDA graph could not hold)


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded on every device (the CPU's `x / s`)."""
    if x.device.type == "cpu":
        return x / s
    key = (float(s), x.dtype, x.device)
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.full((), float(s), dtype=x.dtype, device=x.device)
    return x / d


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension by pairwise halving, the same adds in the
    same order on every device; its length must be a power of two."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"tree_sum needs a power-of-two length, got {n}")
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]
