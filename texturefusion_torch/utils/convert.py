"""State carried between the JAX package and the port, as numpy arrays.

The system has no weights: its state is the TSDF volume and the mesh
pool. These build the port's objects from a JAX `TSDFVolume`'s or
`MeshPool`'s arrays (fetched with np.asarray), so both packages can
start from one volume or mesh the same one.
"""

from __future__ import annotations

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.ops import marching_cubes as mc


def volume_state_from_numpy(config: PipelineConfig, sdf: np.ndarray,
                            weight: np.ndarray, color: np.ndarray,
                            color_count: np.ndarray, origins: np.ndarray,
                            ids: np.ndarray, used: np.ndarray,
                            device="cpu") -> TSDFVolume:
    """A port TSDFVolume holding these rows ([cap+1, 512], color
    [cap+1, 512, 3], origins [cap+1, 3]) with the allocated chunk ids
    (ids [cap, 3], used [cap]) registered at the same slots."""
    vol = TSDFVolume(config, device=device)
    for dst, src in zip(vol.batch, (sdf, weight, color, color_count)):
        dst.copy_(torch.tensor(np.asarray(src, np.float32)))
    vol.origins.copy_(torch.tensor(np.asarray(origins, np.float32)))
    slots = np.nonzero(np.asarray(used, bool))[0].astype(np.int64)
    slot_ids = np.asarray(ids, np.int32)[slots]
    vol.alloc.import_state(slots, slot_ids)
    vol.ids[slots] = slot_ids
    vol.used[slots] = True
    vol.slot_of = {tuple(c): int(s) for s, c in zip(slots.tolist(), slot_ids.tolist())}
    vol.chunks_created = len(slots)
    return vol


def mesh_pool_from_numpy(verts: np.ndarray, col_packed: np.ndarray,
                         nrm_packed: np.ndarray, tris: np.ndarray,
                         vcount: np.ndarray, tcount: np.ndarray,
                         device="cpu") -> mc.MeshPool:
    """A port MeshPool from a JAX pool's arrays (packed channels arrive
    as uint32 and are stored as int32 with the same bits)."""
    def i32(a):
        return torch.tensor(np.asarray(a).astype(np.int32), device=device)

    return mc.MeshPool(
        verts=torch.tensor(np.asarray(verts, np.float32), device=device),
        col_packed=i32(col_packed), nrm_packed=i32(nrm_packed), tris=i32(tris),
        vcount=i32(vcount), tcount=i32(tcount))
