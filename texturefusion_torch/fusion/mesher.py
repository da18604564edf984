"""Incremental meshing over the chunked TSDF volume.

Port of texturefusion_tpu/fusion/mesher.py (ref:
Structure/ChunkManager.cpp:232-264 RecomputeMeshes): only chunks that
integration marked dirty are remeshed, into a mesh pool that stays on
the volume's device; the host reads pool rows on demand (export).
Counts are read back synchronously after each remesh. Chunks that a
ChunkStreamer offloads keep their meshes on the host (`freeze`), so the
export still holds them. `chunk_adjacency_arrays` gives the texture
stage its chunk graph; `on_drop` hears of every slot whose mesh is
dropped (GC, streaming), so per-slot state kept elsewhere is released
before the slot is recycled.

The pool is sharded like the volume's rows (slot s on shard s % n of its
mesh). A sharded remesh meshes each shard's dirty chunks on that shard's
device, after gathering the rows of the chunks and of their 7 corner
neighbours, from whichever shard holds them, into a halo staging tensor
whose last row is a reset row (RESET_SDF, weight 0) that every absent
neighbour reads, as the unsharded trash row does. The texture stage reads
the pool through `pool_reader`, sharded or not: the two count columns
whole and the rows of the chunks a cycle projects, never the whole pool.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.core import geometry
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.ops import marching_cubes as mc
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.parallel.sharded_tsdf import TSDF_FIELDS, ShardedRows


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
        self.pool_rows = ShardedRows.build(
            volume.mesh, cap + 1,
            lambda rows, dev: tuple(mc.make_mesh_pool(rows - 1, self.p_cap, self.t_cap, dev)))
        self.vcount = np.zeros(cap + 1, np.int32)   # host mirrors
        self.tcount = np.zeros(cap + 1, np.int32)
        # chunk id -> host mesh of an OFFLOADED chunk (streaming): its slot
        # was recycled, but its surface still exports
        self.frozen: Dict[Tuple[int, int, int], tuple] = {}
        self.last_remeshed: set = set()
        self._host_cache: Dict[int, tuple] = {}
        self._cache_valid = False
        self._warned_overflow = False
        # called with the slots (int64 array) of every drop
        self.on_drop: Optional[Callable[[np.ndarray], None]] = None

    @property
    def pool(self) -> mc.MeshPool:
        """The [cap+1, ...] pool of an unsharded volume (updated in place)."""
        if self.volume.sharded:
            raise NotImplementedError(
                "IncrementalMesher.pool is the one-device pool; a sharded pool is read "
                "through mesher.pool_rows")
        return mc.MeshPool(*self.pool_rows.parts[0])

    def pool_reader(self, device=None) -> mc.PoolReader:
        """The texture cycle's view of the pool on `device` (the volume's
        first by default), read through the container: the vcount and
        tcount columns, and a gather of the verts and packed colours of a
        slot tensor with no host read. On one device both index the pool
        itself."""
        rows = self.pool_rows
        return mc.PoolReader(
            rows.column(mc.POOL_VCOUNT, device), rows.column(mc.POOL_TCOUNT, device),
            lambda slots: rows.gather_rows(slots, (mc.POOL_VERTS, mc.POOL_COLORS), device))

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
        origins = vol.ids[slots].astype(np.float32) * vol.extent
        nbr = self._neighbor_slots(slots)
        if not vol.sharded:
            dev = vol.device
            vcount, tcount = mc.mesh_chunks_pooled(
                self.pool, *vol.batch, torch.as_tensor(slots, device=dev),
                torch.as_tensor(nbr, device=dev), torch.as_tensor(origins, device=dev),
                torch.ones(len(slots), dtype=torch.bool, device=dev),
                vol.cfg.chunk_size, vol.cfg.voxel_resolution)
            return vcount.cpu().numpy(), tcount.cpu().numpy()

        trash = vol.cfg.capacity

        def fn(k, pool_part, idx):
            dev = idx.device
            mine = np.nonzero(np.asarray(slots) % vol.mesh.size == k)[0]   # split()'s lanes
            halo, inv = np.unique(nbr[mine], return_inverse=True)
            real = halo[halo != trash]
            # the trash slot is the largest, so it sorts last: staging row
            # len(real), the reset row, is what an absent neighbour reads
            staged = [torch.cat([rows, reset]) for rows, reset in zip(
                vol.rows.gather(real, fields=TSDF_FIELDS, device=dev),
                tsdf_ops.make_empty_batch(1, vol.n_voxels, dev))]
            return mc.mesh_chunks_pooled(
                mc.MeshPool(*pool_part), *staged, idx,
                torch.as_tensor(inv.reshape(-1, 8), device=dev),
                torch.as_tensor(origins[mine], device=dev),
                torch.ones(len(mine), dtype=torch.bool, device=dev),
                vol.cfg.chunk_size, vol.cfg.voxel_resolution)

        vcount, tcount = self.pool_rows.launch(fn, slots, "remesh")
        return vcount.cpu().numpy(), tcount.cpu().numpy()

    def update_meshes(self, max_chunks: int = 0) -> int:
        """Remesh all dirty chunks into the pool (ref: Chisel.h:479-481).
        Returns the number remeshed."""
        vol = self.volume
        dirty = sorted(vol.dirty_mesh)
        if max_chunks:
            dirty = dirty[:max_chunks]
        self.last_remeshed = set(dirty)
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
        v, cp, npk, tr, vc, tc = (a.cpu().numpy() for a in self.pool_rows.gather(todo))
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

    def freeze(self, slots) -> None:
        """Keep the meshes of offloaded chunks under their chunk ids (the
        streamer recycles their slots), then drop the slots' pool rows."""
        for s, m in self._fetch_rows(np.atleast_1d(slots)).items():
            self.frozen[tuple(self.volume.ids[s].tolist())] = m
        self.drop(slots)

    def drop(self, slots) -> None:
        slots = np.atleast_1d(slots).astype(np.int64)
        if len(slots) == 0:
            return
        self.vcount[slots] = 0
        self.tcount[slots] = 0
        self.pool_rows.fill(slots, {mc.POOL_VCOUNT: 0, mc.POOL_TCOUNT: 0})
        self._cache_valid = False
        if self.on_drop is not None:
            self.on_drop(slots)

    def chunk_adjacency_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(meshed_slots [S], nbr_slots [S, 6]): the 6-neighbour slots that
        also have meshes, -1 where absent (the texture MRF's chunk graph,
        ref: TexMap.cpp:50-61 update_chunkgraph), from one lookup of all
        meshed chunks × 6 offsets."""
        vol = self.volume
        cap = vol.cfg.capacity
        meshed = np.nonzero(self.tcount[:-1] > 0)[0]
        if len(meshed) == 0:
            return meshed, np.zeros((0, 6), np.int64)
        nbrs = geometry.neighbor_offsets_6()
        nb = (vol.ids[meshed][:, None, :] + nbrs[None]).reshape(-1, 3)
        res = vol.lookup(nb).reshape(len(meshed), len(nbrs))
        is_meshed = np.zeros(cap + 1, bool)
        is_meshed[meshed] = True
        ok = (res >= 0) & is_meshed[np.clip(res, 0, cap)]
        return meshed, np.where(ok, res, -1)

    def chunk_adjacency(self) -> Dict[int, np.ndarray]:
        """Dict view of chunk_adjacency_arrays: slot → meshed neighbour slots."""
        meshed, nbr = self.chunk_adjacency_arrays()
        return {int(s): row[row >= 0] for s, row in zip(meshed.tolist(), nbr)}

    def full_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All chunk meshes concatenated, the resident ones in slot order,
        then the frozen ones of offloaded chunks in chunk-id order (a
        chunk restored since is exported from its new slot):
        (verts, faces, colors, normals)."""
        vs, fs, cs, ns = [], [], [], []
        base = 0
        meshes = self.meshes
        parts = [meshes[s] for s in sorted(meshes)] + [
            self.frozen[cid] for cid in sorted(self.frozen)
            if self.volume.slot_of.get(cid) is None]
        for v, f, c, n in parts:
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
