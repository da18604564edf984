"""Chunk-grid indexing helpers.

Port of texturefusion_tpu/core/geometry.py (ref: open_chisel/geometry/*,
Structure/ChunkManager.h:44-57).
The voxel-centroid table is built in numpy exactly as the JAX package
builds it, so both packages (and the CUDA voxel kernel, which reads the
same table) place every voxel at the same float32 offset.
"""

from __future__ import annotations

import numpy as np
import torch


# Spatial hash mixing primes (the role of ChunkHasher, ref: ChunkManager.h:44-53).
_HASH_P1 = np.int64(73856093)
_HASH_P2 = np.int64(19349663)
_HASH_P3 = np.int64(83492791)


def chunk_id_hash(ids: np.ndarray, table_size: int) -> np.ndarray:
    """Host-side spatial hash of integer chunk IDs (N, 3) -> (N,)."""
    ids = ids.astype(np.int64)
    h = (ids[..., 0] * _HASH_P1) ^ (ids[..., 1] * _HASH_P2) ^ (ids[..., 2] * _HASH_P3)
    return (h % table_size + table_size) % table_size


def world_to_chunk(points: torch.Tensor, chunk_extent: float) -> torch.Tensor:
    """World points (..., 3) -> integer chunk IDs (..., 3)."""
    return torch.floor(points / chunk_extent).to(torch.int32)


def chunk_origin(chunk_ids: torch.Tensor, chunk_extent: float) -> torch.Tensor:
    """Integer chunk IDs (..., 3) -> world origin of the chunk (min corner)."""
    return chunk_ids.to(torch.float32) * chunk_extent


def voxel_centroids(chunk_size: int, resolution: float) -> np.ndarray:
    """(chunk_size³, 3) voxel-center offsets from the chunk origin,
    x-fastest: linear index i = x + y·S + z·S² (ref: ChunkManager.cpp:49-159)."""
    s = chunk_size
    idx = np.arange(s * s * s)
    x = idx % s
    y = (idx // s) % s
    z = idx // (s * s)
    return ((np.stack([x, y, z], axis=-1) + 0.5) * resolution).astype(np.float32)


def voxel_coords_in_chunk(chunk_size: int) -> np.ndarray:
    """(chunk_size³, 3) integer voxel coords, x-fastest linear order."""
    s = chunk_size
    idx = np.arange(s * s * s)
    return np.stack([idx % s, (idx // s) % s, idx // (s * s)], axis=-1).astype(np.int32)


def aabb_corners(min_c: torch.Tensor, max_c: torch.Tensor) -> torch.Tensor:
    """AABB (..., 3) min/max -> (..., 8, 3) corners, x fastest."""
    signs = torch.tensor([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
                         dtype=min_c.dtype, device=min_c.device)
    return min_c[..., None, :] + signs * (max_c - min_c)[..., None, :]


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


def neighbor_offsets_corner7() -> np.ndarray:
    """The 7 positive-corner neighbours a 9³ marching-cubes block spans
    (+x, +y, +z, +xy, +xz, +yz, +xyz; ref: ChunkManager.cpp:608-633)."""
    return np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
        dtype=np.int32)
