"""Mesh simplification by vertex clustering (numpy only).

A copy of texturefusion_tpu/ops/simplify.py (ref: Structure/Chisel.cpp
:112-147 CompressMeshes / SimplifyByClustering). Vertices are snapped to
a grid of `cell` metres; all vertices in one cell merge to their
attribute-averaged centroid; degenerate and duplicate faces are dropped.
The pipeline's welded PLY export runs it at a quarter voxel, which
merges the chunk-boundary vertices each chunk's mesh repeats.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def simplify_by_clustering(
    verts: np.ndarray, faces: np.ndarray, cell: float,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Returns (verts, faces, colors, normals) of the simplified mesh."""
    if len(verts) == 0:
        return verts, faces, colors, normals
    key = np.floor(verts / cell).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n_out = len(uniq)

    counts = np.bincount(inv, minlength=n_out).astype(np.float64)

    def avg(attr):
        out = np.zeros((n_out, attr.shape[1]), np.float64)
        np.add.at(out, inv, attr)
        return (out / counts[:, None]).astype(np.float32)

    new_verts = avg(verts)
    new_colors = avg(colors) if colors is not None else None
    new_normals = None
    if normals is not None:
        new_normals = avg(normals)
        norm = np.linalg.norm(new_normals, axis=-1, keepdims=True)
        new_normals = new_normals / np.maximum(norm, 1e-12)

    f = inv[faces]
    good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[good]
    # drop duplicate faces (same vertex triple in any rotation)
    if len(f):
        canon = np.sort(f, axis=1)
        _, keep = np.unique(canon, axis=0, return_index=True)
        f = f[np.sort(keep)]
    return new_verts, f.astype(np.int32), new_colors, new_normals
