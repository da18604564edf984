"""Capacities that grow: arrays indexed by keyframe or edge (the keyframe
stack, GCSLAM's keyframe and edge state, the observation columns),
doubled when a session outgrows them. Upstream holds this state in
growable C++ vectors; the JAX package sizes most of it once, for the
TPU's static shapes."""

from __future__ import annotations

import numpy as np
import torch


def doubled(capacity: int, n: int) -> int:
    """The least capacity·2^k at or above n."""
    while capacity < n:
        capacity *= 2
    return capacity


def grown(a, n: int, fill=0, axis: int = 0):
    """A copy of `a` (a tensor or a numpy array) with `n` entries along
    `axis`, the new ones `fill` (a value, or an entry broadcast to each:
    an identity pose)."""
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape) if isinstance(a, torch.Tensor) else np.empty(shape, a.dtype)
    out[...] = fill
    out[(slice(None),) * axis + (slice(0, a.shape[axis]),)] = a
    return out
