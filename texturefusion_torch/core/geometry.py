"""Chunk-grid indexing helpers.

Port of the parts of texturefusion_tpu/core/geometry.py that the fusion
slice uses (ref: open_chisel/geometry/*, Structure/ChunkManager.h:44-57).
The voxel-centroid table is built in numpy exactly as the JAX package
builds it, so both packages (and the CUDA voxel kernel, which reads the
same table) place every voxel at the same float32 offset.
"""

from __future__ import annotations

import numpy as np
import torch


def world_to_chunk(points: torch.Tensor, chunk_extent: float) -> torch.Tensor:
    """World points (..., 3) -> integer chunk IDs (..., 3)."""
    return torch.floor(points / chunk_extent).to(torch.int32)


def voxel_centroids(chunk_size: int, resolution: float) -> np.ndarray:
    """(chunk_size³, 3) voxel-center offsets from the chunk origin,
    x-fastest: linear index i = x + y·S + z·S² (ref: ChunkManager.cpp:49-159)."""
    s = chunk_size
    idx = np.arange(s * s * s)
    x = idx % s
    y = (idx // s) % s
    z = idx // (s * s)
    return ((np.stack([x, y, z], axis=-1) + 0.5) * resolution).astype(np.float32)


def neighbor_offsets_6() -> np.ndarray:
    """The 6 axis-aligned neighbor offsets (ref: ChunkManager.h:55-57)."""
    return np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=np.int32)


def trilinear_weights(frac: torch.Tensor) -> torch.Tensor:
    """Fractional coords (..., 3) -> (..., 8) trilinear corner weights,
    x fastest (the corner order of the JAX package's aabb_corners)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1 - fx, fx], dim=-1)
    wy = torch.stack([1 - fy, fy], dim=-1)
    wz = torch.stack([1 - fz, fz], dim=-1)
    w = wz[..., :, None, None] * wy[..., None, :, None] * wx[..., None, None, :]
    return w.reshape(frac.shape[:-1] + (8,))
