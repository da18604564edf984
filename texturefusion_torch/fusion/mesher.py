"""Incremental meshing over the chunked TSDF volume.

Port of texturefusion_tpu/fusion/mesher.py (ref:
Structure/ChunkManager.cpp:232-264 RecomputeMeshes): only chunks that
integration marked dirty are remeshed, into a mesh pool that stays on
the volume's device; the host reads pool rows on demand (export).
Counts are read back synchronously after each remesh.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.ops import marching_cubes as mc


class IncrementalMesher:
    # corner neighbours in block-LUT bit order: 1=+x, 2=+y, 3=+xy, 4=+z, ...
    _CORNER_OFFS = np.asarray([(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1),
                               (1, 0, 1), (0, 1, 1), (1, 1, 1)], np.int32)

    def __init__(self, volume: TSDFVolume):
        self.volume = volume
        cfg = volume.config.mesh
        cap = volume.cfg.capacity
        self.p_cap = cfg.pool_verts_per_chunk
        self.t_cap = cfg.pool_tris_per_chunk
        self.pool = mc.make_mesh_pool(cap, self.p_cap, self.t_cap, volume.device)
        self.vcount = np.zeros(cap + 1, np.int32)   # host mirrors
        self.tcount = np.zeros(cap + 1, np.int32)
        self._host_cache: Dict[int, tuple] = {}
        self._cache_valid = False
        self._warned_overflow = False

    def _neighbor_slots(self, slots: np.ndarray) -> np.ndarray:
        """[U, 8] slots of self + 7 positive-corner neighbours, trash
        where absent (ref: ChunkManager.cpp:608-633)."""
        vol = self.volume
        trash = vol.cfg.capacity
        out = np.full((len(slots), 8), trash, np.int64)
        out[:, 0] = slots
        nb = (vol.ids[slots][:, None, :] + self._CORNER_OFFS[None]).reshape(-1, 3)
        res = vol.lookup(nb).reshape(len(slots), 7)
        out[:, 1:] = np.where(res >= 0, res, trash)
        return out

    def _remesh(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Mesh one batch of slots into the pool; returns host (vcount, tcount)."""
        vol = self.volume
        dev = vol.device
        vcount, tcount = mc.mesh_chunks_pooled(
            self.pool, *vol.batch,
            torch.as_tensor(slots, device=dev),
            torch.as_tensor(self._neighbor_slots(slots), device=dev),
            torch.as_tensor(vol.ids[slots].astype(np.float32) * vol.extent, device=dev),
            torch.ones(len(slots), dtype=torch.bool, device=dev),
            vol.cfg.chunk_size, vol.cfg.voxel_resolution)
        return vcount.cpu().numpy(), tcount.cpu().numpy()

    def update_meshes(self, max_chunks: int = 0) -> int:
        """Remesh all dirty chunks into the pool (ref: Chisel.h:479-481).
        Returns the number remeshed."""
        vol = self.volume
        dirty = sorted(vol.dirty_mesh)
        if max_chunks:
            dirty = dirty[:max_chunks]
        budget = vol.config.mesh.max_mesh_chunks
        for start in range(0, len(dirty), budget):
            slots = np.asarray(dirty[start:start + budget], np.int64)
            vc, tc = self._remesh(slots)
            self.vcount[slots] = vc
            self.tcount[slots] = tc
            if not self._warned_overflow and ((vc >= self.p_cap).any()
                                              or (tc >= self.t_cap).any()):
                self._warned_overflow = True
                warnings.warn("mesh pool per-chunk capacity clamped a chunk; "
                              "raise MeshConfig.pool_verts_per_chunk")
        vol.dirty_mesh.difference_update(dirty)
        if dirty:
            self._cache_valid = False
        return len(dirty)

    def _fetch_rows(self, slots: np.ndarray) -> Dict[int, tuple]:
        """Pool rows of `slots` → {slot: (verts, faces, colors, normals)}."""
        todo = np.asarray([s for s in np.atleast_1d(slots).tolist()
                           if self.tcount[s] > 0], np.int64)
        if len(todo) == 0:
            return {}
        v, cp, npk, tr, vc, tc = (a.cpu().numpy() for a in mc.gather_pool_rows(
            self.pool, torch.as_tensor(todo, device=self.volume.device)))
        out: Dict[int, tuple] = {}
        for i, s in enumerate(todo.tolist()):
            nv, nt = int(vc[i]), int(tc[i])
            if nt == 0:
                continue
            col = mc.unpack_u32_channels(cp[i, :nv]) / 255.0
            nrm = (mc.unpack_u32_channels(npk[i, :nv]) - 127.0) / 127.0
            out[s] = (v[i, :nv], tr[i, :nt].astype(np.int32), col, nrm)
        return out

    @property
    def meshes(self) -> Dict[int, tuple]:
        """Host view of all chunk meshes, cached until the next remesh."""
        if not self._cache_valid:
            self._host_cache = self._fetch_rows(np.nonzero(self.tcount[:-1] > 0)[0])
            self._cache_valid = True
        return self._host_cache

    def drop(self, slots) -> None:
        slots = np.atleast_1d(slots).astype(np.int64)
        if len(slots) == 0:
            return
        self.vcount[slots] = 0
        self.tcount[slots] = 0
        idx = torch.as_tensor(slots, device=self.volume.device)
        self.pool.vcount[idx] = 0
        self.pool.tcount[idx] = 0
        self._cache_valid = False

    def full_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All chunk meshes concatenated in slot order:
        (verts, faces, colors, normals)."""
        vs, fs, cs, ns = [], [], [], []
        base = 0
        meshes = self.meshes
        for slot in sorted(meshes):
            v, f, c, n = meshes[slot]
            vs.append(v)
            fs.append(f + base)
            cs.append(c)
            ns.append(n)
            base += len(v)
        if not vs:
            z = np.zeros((0, 3), np.float32)
            return z, np.zeros((0, 3), np.int32), z, z
        return (np.concatenate(vs), np.concatenate(fs),
                np.concatenate(cs), np.concatenate(ns))
