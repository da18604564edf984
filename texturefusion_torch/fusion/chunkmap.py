"""Chunked TSDF volume: slot-indexed device rows + host-side allocator.

Port of texturefusion_tpu/fusion/chunkmap.py (ref:
Structure/ChunkManager.h:119-1306 ChunkManager; Structure/Chisel.h:103-249
PrepareIntersectChunks / IntegrateDepthScanColor). The TSDF lives in
dense [capacity + 1, 512] tensors on `device`; the native allocator maps
integer chunk IDs to slots. Slot `capacity` is a trash row that padded
slot lists point at; the volume itself lists only its real slots.

Host reads of device results do not wait where they are made, as in
the JAX package: discovery can be dispatched ahead (`dispatch_discovery`,
its ids and count fetched later by `discover_chunks`); each integration
queues its per-chunk observation quality (`_pending_obs`), applied in
dispatch order when the table is read (`flush_observations`,
`obs_arrays`, a retraction, a release); and the empty-chunk GC can probe
occupancy in one cycle and release in the next (`gc_dispatch`,
`gc_consume`), or do both at once (`gc_new_chunks`). The map's lifecycle
(ref: Chisel.h:184-216 GC of empty chunks; MobileFusion.cpp:114-272
reintegration and observation retraction) is here too: drift
reintegration of a keyframe (`reintegrate_frame`, two K2 passes on its
recorded rows), its depth-only local frames (`integrate_local_depths`,
`reintegrate_local_depths`, K2's F-frame mode), and the hook through
which a ChunkStreamer (fusion/streaming.py) restores offloaded chunks
before discovery assigns slots.

Queries: `sdf_at` samples the TSDF trilinearly at world points through
a dense chunk-ID → slot table over the map's bounding box (`SlotTable`),
which ops/raycast.py reads too.

Rows: the rows live in a ShardedRows container (parallel/sharded_tsdf.py),
one shard on `device` by default. With a DeviceMesh of n > 1 shards, slot
s lives on shard s % n; the capacity grows so that capacity + 1 (the
trash row) divides by n, as in the JAX package, and every row access goes
through the container: each voxel-update launch takes one shard's rows
and local indices, and a query reads the rows gathered onto the mesh's
first device (`dense_batch`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import geometry
from texturefusion_torch.native import make_allocator
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.parallel.mesh import DeviceMesh
from texturefusion_torch.parallel.sharded_tsdf import ORIGIN_FIELD, TSDF_FIELDS, volume_rows
from texturefusion_torch.utils import async_fetch
from texturefusion_torch.utils.capacity import doubled, grown
from texturefusion_torch.utils.stopwatch import STOPWATCH


class TSDFVolume:
    def __init__(self, config: PipelineConfig, device="cuda",
                 mesh: Optional[DeviceMesh] = None):
        self.config = config
        self.cfg = config.tsdf
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.mesh = mesh if mesh is not None else DeviceMesh([device])
        self.device = self.mesh.devices[0]
        n_sh = self.mesh.size
        if n_sh > 1:
            # the slot axis divides evenly over the mesh: grow the capacity so
            # that (capacity + trash row) is a multiple of the shard count
            cap = -(-(self.cfg.capacity + 1) // n_sh) * n_sh - 1
            if cap != self.cfg.capacity:
                self.cfg = dataclasses.replace(self.cfg, capacity=cap)
        cap = self.cfg.capacity
        self.n_voxels = self.cfg.chunk_size ** 3
        self.rows = volume_rows(self.mesh, cap + 1, self.n_voxels)

        self.alloc = make_allocator(cap)
        self.slot_of: dict = {}                      # chunk id -> slot
        self.ids = np.zeros((cap, 3), np.int32)      # slot -> chunk id
        self.used = np.zeros(cap, bool)
        # per-(chunk, keyframe) observation quality (ref: Chunk.h:170-172
        # `observations`), dense [cap+1, keyframe columns]; presence is
        # _obs_mask. The columns start at ba.max_keyframes and double when
        # a keyframe outgrows them (`_obs_columns`)
        self._obs_q = np.zeros((cap + 1, config.ba.max_keyframes), np.float32)
        self._obs_mask = np.zeros((cap + 1, config.ba.max_keyframes), bool)
        # integrations whose quality fetch is not yet applied, in dispatch
        # order: (slots, fetch of (quality, updated), keyframe, sign)
        self._pending_obs: List[tuple] = []
        self.dirty_mesh: Set[int] = set()            # slots needing remesh
        self.chunks_created = 0
        # per-slot integration generation: a deferred GC consume re-probes
        # the candidates integrated again since their probe
        self._gen = 0
        self._touch_gen = np.zeros(cap + 1, np.int64)
        # slots allocated since the last GC pass (ref: Chisel.h:184-216)
        self.new_since_gc: Set[int] = set()
        # optional ChunkStreamer: restores offloaded chunks on revisit
        self.streamer = None
        # freed slots not yet handed out again, in release order: the top of
        # the allocator's LIFO free list, which a checkpoint restores
        self.released: List[int] = []

    @property
    def sharded(self) -> bool:
        return self.mesh.size > 1

    def _unsharded(self, what: str) -> None:
        if self.sharded:
            raise NotImplementedError(
                f"TSDFVolume.{what} is the one-device row tensor; a sharded volume's rows "
                "are read through volume.rows or dense_batch()")

    @property
    def batch(self) -> tsdf_ops.ChunkBatch:
        """The [cap+1, ...] TSDF rows of an unsharded volume (updated in place)."""
        self._unsharded("batch")
        return tsdf_ops.ChunkBatch(*self.rows.parts[0][:4])

    @property
    def origins(self) -> torch.Tensor:
        """The [cap+1, 3] chunk origins of an unsharded volume."""
        self._unsharded("origins")
        return self.rows.parts[0][ORIGIN_FIELD]

    def dense_batch(self) -> Tuple[tsdf_ops.ChunkBatch, torch.Tensor]:
        """(rows, origins) of every slot in slot order on `device`: the row
        tensors themselves when unsharded, else a gathered copy."""
        if not self.sharded:
            return self.batch, self.origins
        *rows, origins = self.rows.gather(np.arange(self.rows.n_rows))
        return tsdf_ops.ChunkBatch(*rows), origins

    @property
    def extent(self) -> float:
        return self.cfg.chunk_size * self.cfg.voxel_resolution

    def n_active(self) -> int:
        return int(self.used.sum())

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.used)[0]

    @property
    def free(self) -> List[int]:
        """Unallocated slots."""
        return np.nonzero(~self.used)[0].tolist()

    # ---------------------------------------------------------- observations

    def _obs_columns(self, kf_id: int) -> None:
        """Double the observation table's keyframe columns until column
        kf_id exists (the STOPWATCH span `kf_grow`)."""
        if kf_id < self._obs_q.shape[1]:
            return
        cols = doubled(self._obs_q.shape[1], kf_id + 1)
        with STOPWATCH.time("kf_grow", kf=kf_id):
            self._obs_q = grown(self._obs_q, cols, axis=1)
            self._obs_mask = grown(self._obs_mask, cols, False, axis=1)

    def obs_arrays(self, flush: bool = True):
        """(quality [cap+1, K] f32, present [cap+1, K] bool) over the
        table's K keyframe columns.
        flush=False reads the table as it stands: the entries of
        integrations whose fetch is still queued are missing, and entries
        a queued de-integration removes are still there (the deferred
        texture cycle reads this view, as the JAX package's does)."""
        if flush:
            self.flush_observations()
        return self._obs_q, self._obs_mask

    def _obs_dict(self) -> Dict[int, Dict[int, float]]:
        out: Dict[int, Dict[int, float]] = {}
        rows, cols = np.nonzero(self._obs_mask[: self.cfg.capacity])
        for s, k in zip(rows.tolist(), cols.tolist()):
            out.setdefault(s, {})[k] = float(self._obs_q[s, k])
        return out

    @property
    def observations(self) -> Dict[int, Dict[int, float]]:
        """Dict-of-dicts snapshot {slot: {keyframe: quality}} of the
        flushed table."""
        self.flush_observations()
        return self._obs_dict()

    @observations.setter
    def observations(self, value: Dict[int, Dict[int, float]]) -> None:
        self._pending_obs = []
        self._obs_q[:] = 0.0
        self._obs_mask[:] = False
        for s, d in value.items():
            self.set_obs_row(int(s), d)

    def obs_row(self, slot: int) -> Dict[int, float]:
        """One slot's {keyframe: quality} in the flushed table (streaming
        offload; the JAX package's reads the table as it stands, and its
        one caller flushes first)."""
        self.flush_observations()
        k = np.nonzero(self._obs_mask[slot])[0]
        return {int(j): float(self._obs_q[slot, j]) for j in k.tolist()}

    def set_obs_row(self, slot: int, d: Dict[int, float]) -> None:
        self._obs_columns(max((int(kf) for kf in d), default=0))
        self._obs_q[slot] = 0.0
        self._obs_mask[slot] = False
        for kf, q in d.items():
            self._obs_q[slot, int(kf)] = q
            self._obs_mask[slot, int(kf)] = True

    def poison_observation(self, slots, kfs) -> None:
        """Mark wrong-mapping (chunk, keyframe) pairs, slots[i] and kfs[i]
        (ints or arrays), so the MRF never re-selects them (ref:
        MobileFusion.cpp:330-343): each entry stays present (GC still
        counts the chunk as observed) at -1e11. An entry still queued is
        not there to poison, as in the JAX package."""
        slots, kfs = np.atleast_1d(slots), np.atleast_1d(kfs)
        hit = self._obs_mask[slots, kfs]
        self._obs_q[slots[hit], kfs[hit]] = -1e11

    def _queue_obs(self, slots: np.ndarray, quality: torch.Tensor, updated: torch.Tensor,
                   kf_id: int, sign: float) -> None:
        self._obs_columns(kf_id)
        self._pending_obs.append((np.asarray(slots, np.int64),
                                  async_fetch.fetch_async((quality, updated)), kf_id, sign))

    def flush_observations(self, ready_only: bool = False) -> None:
        """Apply the queued observation updates in dispatch order;
        ready_only applies only the prefix whose fetches have landed and
        leaves the rest for a later flush."""
        if not self._pending_obs:
            return
        pend, self._pending_obs = self._pending_obs, []
        if ready_only:
            n_ready = 0
            for p in pend:
                if not p[1].done():
                    STOPWATCH.count("obs_not_ready")
                    break
                n_ready += 1
            self._pending_obs, pend = pend[n_ready:], pend[:n_ready]
            STOPWATCH.count("obs_late", len(pend))
        self._apply_obs(pend)

    def _apply_obs(self, pend: List[tuple]) -> None:
        with STOPWATCH.time("obs_resolve"):
            fetched = [p[1].result() for p in pend]
        for (slots, _, kf_id, sign), (q, up) in zip(pend, fetched):
            up = np.asarray(up, bool)
            sl = slots[up]
            if sign > 0:
                self._obs_q[sl, kf_id] = q[up]
                self._obs_mask[sl, kf_id] = True
            else:
                self._obs_q[sl, kf_id] = 0.0
                self._obs_mask[sl, kf_id] = False

    def retract_observations(self, keyframe_id: int) -> List[int]:
        """Remove a keyframe's observation entries before it is
        re-integrated (ref: MobileFusion.cpp:252-272 RetractObservations).
        Only this keyframe's queued entries are applied first, in their
        order (another keyframe's entries touch another column). Returns
        the affected slots."""
        mine = [p for p in self._pending_obs if p[2] == keyframe_id]
        if mine:
            self._pending_obs = [p for p in self._pending_obs if p[2] != keyframe_id]
            self._apply_obs(mine)
        touched = np.nonzero(self._obs_mask[:, keyframe_id])[0]
        self._obs_mask[touched, keyframe_id] = False
        self._obs_q[touched, keyframe_id] = 0.0
        return touched.tolist()

    # ---------------------------------------------------------- allocator

    def _register_new(self, new_slots: np.ndarray) -> None:
        """Sync host views and device origins for freshly allocated slots."""
        if len(new_slots) == 0:
            return
        for slot in new_slots.tolist():
            if self.released and self.released[-1] == slot:
                self.released.pop()
        new_ids = self.alloc.export()[0][new_slots]
        self.ids[new_slots] = new_ids
        self.used[new_slots] = True
        for s, cid in zip(new_slots.tolist(), map(tuple, new_ids.tolist())):
            self.slot_of[cid] = int(s)
        self.chunks_created += len(new_slots)
        self.new_since_gc.update(new_slots.tolist())
        self.rows.put(new_slots, [torch.as_tensor(new_ids.astype(np.float32) * self.extent)],
                      fields=(ORIGIN_FIELD,))

    def allocate(self, ids: np.ndarray) -> np.ndarray:
        """Get-or-create slots for chunk IDs (N, 3); -1 when the pool is full."""
        ids = np.asarray(ids, np.int32)
        _, new_slots = self.alloc.touch(ids, allocate=True)
        self._register_new(new_slots)
        return self.alloc.lookup(ids)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Slots for chunk IDs without allocating; -1 for absent."""
        return self.alloc.lookup(np.asarray(ids, np.int32))

    def release(self, slots: np.ndarray) -> None:
        """Free chunk slots and reset their rows (ref: Chisel.h:184-216)."""
        slots = np.asarray([s for s in np.atleast_1d(slots) if s >= 0], np.int64)
        if len(slots) == 0:
            return
        # a queued update must not bring a released slot's entries back:
        # apply the queue's prefix up to the last entry that touches one
        rel = set(slots.tolist())
        last = max((k for k, p in enumerate(self._pending_obs)
                    if rel.intersection(p[0].tolist())), default=-1)
        if last >= 0:
            prefix, self._pending_obs = (self._pending_obs[:last + 1],
                                         self._pending_obs[last + 1:])
            self._apply_obs(prefix)
        freed = list(dict.fromkeys(s for s in slots.tolist() if self.used[s]))
        self.alloc.release(slots)
        self.released.extend(freed)
        self._obs_q[slots] = 0.0
        self._obs_mask[slots] = False
        for s in slots.tolist():
            cid = tuple(self.ids[s].tolist())
            if self.slot_of.get(cid) == s:
                del self.slot_of[cid]
            self.used[s] = False
            self.dirty_mesh.discard(s)
        self.rows.fill(slots, dict(zip(TSDF_FIELDS, (tsdf_ops.RESET_SDF, 0.0, 0.0, 0.0))))

    # ---------------------------------------------------------- integration

    def dispatch_discovery(self, depth: torch.Tensor, cam_to_world,
                           max_out: Optional[int] = None):
        """Launch the chunk discovery of a frame and start the copy of its
        ids and count; returns (handle, max_out) for discover_chunks'
        `prefetched`. Nothing here waits for the device."""
        if max_out is None:
            max_out = self.cfg.max_update_chunks * 4
        ids, n = tsdf_ops.candidate_chunks_unique_dev(
            depth, self._pose(cam_to_world), self.intr, self.cfg,
            stride=max(1, self.intr.width // 320), max_out=max_out)
        return async_fetch.fetch_async((ids, n)), max_out

    def discover_chunks(self, depth: torch.Tensor, cam_to_world,
                        allocate: bool = True, prefetched=None) -> np.ndarray:
        """Chunk IDs in this frame's truncation band → slots
        (ref: Chisel.h:103-182). Allocates new slots unless
        allocate=False. `prefetched` is a dispatch_discovery result to
        read instead of dispatching one. When the unique set fills the
        candidate budget, surface may have been dropped, so discovery
        runs again on this depth and pose with twice the budget."""
        while True:
            if prefetched is not None:
                (fetch, max_out), prefetched = prefetched, None
            else:
                fetch, max_out = self.dispatch_discovery(depth, cam_to_world)
            with STOPWATCH.time("disco_fetch"):
                ids, n = fetch.result()
            n = int(n)
            if n < max_out:
                break
            warnings.warn(f"discover_chunks: candidate budget hit ({n}); "
                          f"retrying with max_out={max_out * 2}")
            prefetched = self.dispatch_discovery(depth, cam_to_world, max_out=max_out * 2)
        if n == 0:
            return np.zeros((0,), np.int64)
        ids = ids[:n]
        if self.streamer is not None and allocate:
            # revisited space: restore offloaded chunks before assignment
            self.streamer.ensure_resident(ids)
        slots, new_slots = self.alloc.touch(ids, allocate=allocate)
        self._register_new(new_slots)
        return slots[slots >= 0]

    def integrate_frame(self, depth: torch.Tensor, rgb: Optional[torch.Tensor],
                        quality_map: Optional[torch.Tensor], cam_to_world,
                        keyframe_id: Optional[int] = None, sign: float = 1.0,
                        slots: Optional[np.ndarray] = None) -> np.ndarray:
        """Integrate (sign=+1) or de-integrate (sign=-1) one frame
        (ref: Chisel.h:218-249): update voxels, record per-chunk
        observation quality under `keyframe_id`, mark touched chunks and
        their 6-neighbours dirty for meshing. Returns the touched slots."""
        pose = self._pose(cam_to_world)
        if slots is None:
            slots = self.discover_chunks(depth, pose, allocate=sign > 0)
        if len(slots) == 0:
            return slots
        with_color = rgb is not None
        if with_color and quality_map is None:
            quality_map = torch.zeros(depth.shape, dtype=torch.float32, device=self.device)
        budget = self.cfg.max_update_chunks

        def fn(k, part, idx):
            dev = idx.device
            return tsdf_ops.integrate_frame_fused(
                tsdf_ops.ChunkBatch(*part[:4]), part[ORIGIN_FIELD], idx, None, depth.to(dev),
                _to(rgb, dev), _to(quality_map, dev), pose.to(dev), float(sign),
                self.intr, self.cfg, with_color=with_color)
        for start in range(0, len(slots), budget):
            chunk_slots = slots[start:start + budget]
            quality, updated = self.rows.launch(fn, chunk_slots, "integrate_frame")
            if with_color and keyframe_id is not None:
                self._queue_obs(chunk_slots, quality, updated, keyframe_id, sign)
            self._mark_dirty(chunk_slots)
        return slots

    def _mark_dirty(self, slots: np.ndarray) -> None:
        """Updated chunks and their 6-neighbours need remeshing
        (ref: Chisel.h:184-216 FinalizeIntegrateChunks)."""
        if len(slots) == 0:
            return
        self._gen += 1
        self._touch_gen[np.asarray(slots, np.int64)] = self._gen
        nb = (self.ids[slots][:, None, :]
              + geometry.neighbor_offsets_6()[None]).reshape(-1, 3)
        res = self.alloc.lookup(nb)
        self.dirty_mesh.update(res[res >= 0].tolist())
        self.dirty_mesh.update(int(s) for s in np.asarray(slots).tolist())

    def _pose(self, cam_to_world) -> torch.Tensor:
        return torch.as_tensor(cam_to_world, dtype=torch.float32, device=self.device)

    def reintegrate_frame(self, depth: torch.Tensor, rgb: torch.Tensor,
                          quality_map: torch.Tensor, pose_old, pose_new,
                          keyframe_id: int, slots: np.ndarray) -> np.ndarray:
        """De-integrate at pose_old and re-integrate at pose_new over a
        KNOWN chunk set, the keyframe's recorded slots (the reference
        reuses kf.validChunks the same way, MobileFusion.cpp:128-143): no
        discovery. The caller retracts the keyframe's observations first;
        the re-integration's entries are recorded here."""
        p_old, p_new = self._pose(pose_old), self._pose(pose_new)
        budget = self.cfg.max_update_chunks

        def fn(k, part, idx):
            dev = idx.device
            return tsdf_ops.reintegrate_frame_fused(
                tsdf_ops.ChunkBatch(*part[:4]), part[ORIGIN_FIELD], idx, None, depth.to(dev),
                rgb.to(dev), quality_map.to(dev), p_old.to(dev), p_new.to(dev), self.intr,
                self.cfg)
        for start in range(0, len(slots), budget):
            chunk_slots = slots[start:start + budget]
            quality, updated = self.rows.launch(fn, chunk_slots, "reintegrate_frame")
            self._queue_obs(chunk_slots, quality, updated, keyframe_id, 1.0)
            self._mark_dirty(chunk_slots)
        return slots

    def _integrate_depths(self, depths: Sequence[torch.Tensor], poses: Sequence[np.ndarray],
                          signs, slots: np.ndarray) -> None:
        d = torch.stack([x.to(self.device) for x in depths])
        p = self._pose(np.stack(poses))
        budget = self.cfg.max_update_chunks

        def fn(k, part, idx):
            dev = idx.device
            tsdf_ops.integrate_depths_batched(
                tsdf_ops.ChunkBatch(*part[:4]), part[ORIGIN_FIELD], idx, None, d.to(dev),
                p.to(dev), signs, self.intr, self.cfg)
        for start in range(0, len(slots), budget):
            self.rows.launch(fn, slots[start:start + budget], "integrate_depths")

    def integrate_local_depths(self, depths: Sequence[torch.Tensor],
                               cam_to_worlds: Sequence[np.ndarray], slots: np.ndarray,
                               sign: float = 1.0) -> None:
        """Depth-only integration of a keyframe's local frames into its
        chunk set in one pass (ref: MobileFusion.cpp:187-203). No host
        reads: the keyframe pass on the same slots marked them dirty."""
        if len(depths) == 0 or len(slots) == 0:
            return
        self._integrate_depths(depths, cam_to_worlds, float(sign), slots)

    def reintegrate_local_depths(self, depths: Sequence[torch.Tensor],
                                 poses_old: Sequence[np.ndarray],
                                 poses_new: Sequence[np.ndarray],
                                 slots: np.ndarray) -> None:
        """Drift reintegration of a keyframe's local frames in one pass:
        the old-pose frames enter at -1 and the new-pose frames at +1."""
        if len(depths) == 0 or len(slots) == 0:
            return
        n = len(depths)
        self._integrate_depths(list(depths) * 2, list(poses_old) + list(poses_new),
                               [-1.0] * n + [1.0] * n, slots)

    # ---------------------------------------------------------- garbage collection

    def _occupancy(self, slots: np.ndarray) -> torch.Tensor:
        """Σ|weight| of each listed slot's rows, on the mesh's first device."""
        (occ,) = self.rows.launch(lambda k, part, idx: (part[1][idx].abs().sum(-1),), slots,
                                  "occupancy")
        return occ

    def garbage_collect(self, slots: np.ndarray) -> np.ndarray:
        """Free the chunks among `slots` whose rows hold no weight
        (ref: Chisel.h:472-477 GarbageCollect). Returns the freed slots."""
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return slots
        empty = slots[self._occupancy(slots).cpu().numpy() <= 0.0]
        self.release(empty)
        return empty

    def _gc_candidates(self) -> np.ndarray:
        """The slots allocated since the last pass that hold no
        observation entry (the table as it stands); clears the set."""
        cand = np.asarray(sorted(self.new_since_gc), np.int64)
        self.new_since_gc.clear()
        return cand[self.used[cand] & ~self._obs_mask[cand].any(axis=1)]

    def gc_new_chunks(self) -> np.ndarray:
        """GC pass over the chunks allocated since the last pass: those
        with no observation entry are probed for occupancy (depth-only
        local frames add weight without observations) and freed when
        empty (ref: Chisel.h:184-216). Returns the freed slots."""
        if not self.new_since_gc:
            return np.zeros(0, np.int64)
        self.flush_observations()
        return self.garbage_collect(self._gc_candidates())

    def gc_dispatch(self) -> Optional[dict]:
        """The GC pass's occupancy probe, dispatched with its copy started
        and not read: gc_consume releases a cycle later. Candidates are
        taken against the table as it stands (a flush would wait for this
        cycle's copies) and checked again at the consume."""
        if not self.new_since_gc:
            return None
        cand = self._gc_candidates()
        if len(cand) == 0:
            return None
        return {"cand": cand, "ids": self.ids[cand].copy(),
                "occ": async_fetch.fetch_async(self._occupancy(cand)), "gen": self._gen,
                "defer_ok": True}

    def gc_consume(self, pending: Optional[dict]):
        """Release a gc_dispatch probe's empty chunks; returns the freed
        slots, or the probe itself while its copy is in flight and
        `defer_ok` holds (a later cycle consumes it). A candidate is freed
        only if it is still allocated to the same chunk, still has no
        observation entry after the queued entries that have landed are
        applied, and was not integrated again since the probe; one
        integrated since goes back to the candidates, to be probed again."""
        if pending is None:
            return np.zeros(0, np.int64)
        if pending.get("defer_ok") and not pending["occ"].done():
            STOPWATCH.count("gc_deferred")
            return pending
        self.flush_observations(ready_only=bool(pending.get("defer_ok")))
        cand, ids0 = pending["cand"], pending["ids"]
        with STOPWATCH.time("gc_occ_resolve"):
            occ = pending["occ"].result()[: len(cand)]
        ok = ((occ <= 0.0) & self.used[cand] & (self.ids[cand] == ids0).all(axis=1)
              & ~self._obs_mask[cand].any(axis=1))
        stale = ok & (self._touch_gen[cand] > pending.get("gen", self._gen))
        self.new_since_gc.update(cand[stale].tolist())
        empty = cand[ok & ~stale]
        with STOPWATCH.time("gc_release"):
            self.release(empty)
        return empty

    # ---------------------------------------------------------- queries

    def sdf_at(self, points_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Trilinear TSDF sample at world points (..., 3) -> (sdf, valid)
        (ref: Chisel.h:251-342 GetDistanceFromSurface;
        ChunkManager.cpp:1043-1168 GetSDF)."""
        batch, _ = self.dense_batch()
        return sample_sdf_trilinear(batch.sdf, batch.weight, self._slot_table(),
                                    points_w.to(self.device), self.cfg.chunk_size,
                                    self.cfg.voxel_resolution)

    def _slot_table(self) -> "SlotTable":
        """Dense chunk-ID → slot lookup over the active chunks' bounding
        box, built on the host and moved to the device."""
        act = self.active_slots()
        trash = self.cfg.capacity
        if len(act) == 0:
            lo = np.zeros(3, np.int32)
            table = np.full((1, 1, 1), trash, np.int32)
        else:
            ids = self.ids[act]
            lo = ids.min(0)
            table = np.full(tuple((ids.max(0) - lo + 1).tolist()), trash, np.int32)
            rel = ids - lo
            table[rel[:, 0], rel[:, 1], rel[:, 2]] = act
        return SlotTable(torch.as_tensor(table, dtype=torch.int64, device=self.device),
                         torch.as_tensor(lo, dtype=torch.int64, device=self.device), trash)


def _to(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device)


class SlotTable:
    """Dense chunk-ID → slot map over the map's bounding box, on the device."""

    def __init__(self, table: torch.Tensor, lo: torch.Tensor, trash: int):
        self.table = table   # [X, Y, Z] int64, the trash slot where absent
        self.lo = lo         # [3] int64
        self.trash = trash
        # made once: a host-to-device copy per lookup would wait for the
        # device in every step of a raycast
        self.shape = torch.tensor(table.shape, dtype=torch.int64).to(table.device)
        # the 8 trilinear corner offsets, x fastest (geometry.trilinear_weights' order)
        self.corners = torch.tensor([[x, y, z] for z in (0, 1) for y in (0, 1)
                                     for x in (0, 1)], dtype=torch.int64).to(table.device)

    def slots_for(self, ids: torch.Tensor) -> torch.Tensor:
        """(..., 3) integer chunk IDs -> slots (the trash slot when absent)."""
        rel = ids.to(torch.int64) - self.lo
        inb = torch.all((rel >= 0) & (rel < self.shape), dim=-1)
        relc = torch.minimum(torch.clamp(rel, min=0), self.shape - 1)
        s = self.table[relc[..., 0], relc[..., 1], relc[..., 2]]
        return torch.where(inb, s, self.trash)


def voxel_corners(table: SlotTable, points_w: torch.Tensor, chunk_size: int,
                  resolution: float):
    """The 8 voxel centres around world points (..., 3): (trilinear weights
    (..., 8), their slots (..., 8), linear voxel index in the chunk (..., 8))."""
    g = points_w / resolution - 0.5
    g0 = torch.floor(g)
    w8 = geometry.trilinear_weights(g - g0)
    vox = g0.to(torch.int64)[..., None, :] + table.corners
    cid = torch.div(vox, chunk_size, rounding_mode="floor")
    local = vox - cid * chunk_size
    lin = local[..., 0] + local[..., 1] * chunk_size + local[..., 2] * chunk_size * chunk_size
    return w8, table.slots_for(cid), lin


def sample_sdf_trilinear(sdf: torch.Tensor, weight: torch.Tensor, table: SlotTable,
                         points_w: torch.Tensor, chunk_size: int, resolution: float):
    """Trilinear SDF interpolation across chunk boundaries: the 8 voxel
    centres around each point, possibly in different chunks, through the
    dense slot table (ref: ChunkManager.cpp:1043-1168). A sample is valid
    where all 8 hold weight and sdf < RESET_SDF / 2 (the JAX package's
    test, one-sided; ops/raycast.py tests |sdf|)."""
    w8, slot, lin = voxel_corners(table, points_w, chunk_size, resolution)
    s8, w8v = sdf[slot, lin], weight[slot, lin]
    ok = torch.all((w8v > 0) & (s8 < tsdf_ops.RESET_SDF * 0.5), dim=-1)
    val = torch.sum(w8 * s8, dim=-1)
    return torch.where(ok, val, tsdf_ops.RESET_SDF), ok
