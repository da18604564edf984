"""Chunked TSDF volume: slot-indexed device rows + host-side allocator.

Port of texturefusion_tpu/fusion/chunkmap.py (ref:
Structure/ChunkManager.h:119-1306 ChunkManager; Structure/Chisel.h:103-249
PrepareIntersectChunks / IntegrateDepthScanColor). The TSDF lives in
dense [capacity + 1, 512] tensors on `device`; the native allocator maps
integer chunk IDs to slots. Slot `capacity` is a trash row that padded
slot lists point at; the volume itself lists only its real slots.

Unlike the JAX package, every host read is synchronous: discovery reads
its unique ids and count at once, each integration records its per-chunk
observation quality right away, and the empty-chunk GC probes occupancy
when it runs. The map's lifecycle (ref: Chisel.h:184-216 GC of empty
chunks; MobileFusion.cpp:114-272 reintegration and observation
retraction) is here too: drift reintegration of a keyframe
(`reintegrate_frame`, two K2 passes on its recorded rows), its
depth-only local frames (`integrate_local_depths`,
`reintegrate_local_depths`, K2's F-frame mode), GC of chunks allocated
since the last pass, and the hook through which a ChunkStreamer
(fusion/streaming.py) restores offloaded chunks before discovery assigns
slots.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import geometry
from texturefusion_torch.native import make_allocator
from texturefusion_torch.ops import tsdf as tsdf_ops


class TSDFVolume:
    def __init__(self, config: PipelineConfig, device="cuda"):
        self.config = config
        self.cfg = config.tsdf
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.device = torch.device(device)
        cap = self.cfg.capacity
        self.n_voxels = self.cfg.chunk_size ** 3
        self.batch = tsdf_ops.make_empty_batch(cap + 1, self.n_voxels, self.device)
        self.origins = torch.zeros((cap + 1, 3), dtype=torch.float32, device=self.device)

        self.alloc = make_allocator(cap)
        self.slot_of: dict = {}                      # chunk id -> slot
        self.ids = np.zeros((cap, 3), np.int32)      # slot -> chunk id
        self.used = np.zeros(cap, bool)
        # per-(chunk, keyframe) observation quality (ref: Chunk.h:170-172
        # `observations`), dense [cap+1, max_kf]; presence is _obs_mask
        self._max_kf = config.ba.max_keyframes
        self._obs_q = np.zeros((cap + 1, self._max_kf), np.float32)
        self._obs_mask = np.zeros((cap + 1, self._max_kf), bool)
        self.dirty_mesh: Set[int] = set()            # slots needing remesh
        self.chunks_created = 0
        # slots allocated since the last GC pass (ref: Chisel.h:184-216)
        self.new_since_gc: Set[int] = set()
        # optional ChunkStreamer: restores offloaded chunks on revisit
        self.streamer = None

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

    def obs_arrays(self):
        """(quality [cap+1, max_kf] f32, present [cap+1, max_kf] bool)."""
        return self._obs_q, self._obs_mask

    @property
    def observations(self) -> Dict[int, Dict[int, float]]:
        """Dict-of-dicts snapshot {slot: {keyframe: quality}} of the table."""
        out: Dict[int, Dict[int, float]] = {}
        rows, cols = np.nonzero(self._obs_mask[: self.cfg.capacity])
        for s, k in zip(rows.tolist(), cols.tolist()):
            out.setdefault(s, {})[k] = float(self._obs_q[s, k])
        return out

    @observations.setter
    def observations(self, value: Dict[int, Dict[int, float]]) -> None:
        self._obs_q[:] = 0.0
        self._obs_mask[:] = False
        for s, d in value.items():
            self.set_obs_row(int(s), d)

    def obs_row(self, slot: int) -> Dict[int, float]:
        """One slot's {keyframe: quality} (streaming offload)."""
        k = np.nonzero(self._obs_mask[slot])[0]
        return {int(j): float(self._obs_q[slot, j]) for j in k.tolist()}

    def set_obs_row(self, slot: int, d: Dict[int, float]) -> None:
        self._obs_q[slot] = 0.0
        self._obs_mask[slot] = False
        for kf, q in d.items():
            self._obs_q[slot, int(kf)] = q
            self._obs_mask[slot, int(kf)] = True

    def poison_observation(self, slot: int, kf: int) -> None:
        """Mark a wrong-mapping (chunk, keyframe) pair so the MRF never
        re-selects it (ref: MobileFusion.cpp:330-343): the entry stays
        present (GC still counts the chunk as observed) at -1e11."""
        if self._obs_mask[slot, kf]:
            self._obs_q[slot, kf] = -1e11

    def retract_observations(self, keyframe_id: int) -> List[int]:
        """Remove a keyframe's observation entries before it is
        re-integrated (ref: MobileFusion.cpp:252-272 RetractObservations).
        Returns the affected slots."""
        touched = np.nonzero(self._obs_mask[:, keyframe_id])[0]
        self._obs_mask[touched, keyframe_id] = False
        self._obs_q[touched, keyframe_id] = 0.0
        return touched.tolist()

    # ---------------------------------------------------------- allocator

    def _register_new(self, new_slots: np.ndarray) -> None:
        """Sync host views and device origins for freshly allocated slots."""
        if len(new_slots) == 0:
            return
        new_ids = self.alloc.export()[0][new_slots]
        self.ids[new_slots] = new_ids
        self.used[new_slots] = True
        for s, cid in zip(new_slots.tolist(), map(tuple, new_ids.tolist())):
            self.slot_of[cid] = int(s)
        self.chunks_created += len(new_slots)
        self.new_since_gc.update(new_slots.tolist())
        self.origins[torch.as_tensor(new_slots, device=self.device)] = torch.as_tensor(
            new_ids.astype(np.float32) * self.extent, device=self.device)

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
        self.alloc.release(slots)
        self._obs_q[slots] = 0.0
        self._obs_mask[slots] = False
        for s in slots.tolist():
            cid = tuple(self.ids[s].tolist())
            if self.slot_of.get(cid) == s:
                del self.slot_of[cid]
            self.used[s] = False
            self.dirty_mesh.discard(s)
        idx = torch.as_tensor(slots, device=self.device)
        self.batch.sdf[idx] = tsdf_ops.RESET_SDF
        self.batch.weight[idx] = 0.0
        self.batch.color[idx] = 0.0
        self.batch.color_count[idx] = 0.0

    # ---------------------------------------------------------- integration

    def discover_chunks(self, depth: torch.Tensor, cam_to_world: torch.Tensor,
                        allocate: bool = True) -> np.ndarray:
        """Chunk IDs in this frame's truncation band → slots
        (ref: Chisel.h:103-182). Allocates new slots unless
        allocate=False. When the unique set fills the candidate budget,
        surface may have been dropped, so discovery reruns with twice it."""
        stride = max(1, self.intr.width // 320)
        max_out = self.cfg.max_update_chunks * 4
        while True:
            ids, n = tsdf_ops.candidate_chunks_unique(
                depth, cam_to_world, self.intr, self.cfg, stride=stride,
                max_out=max_out)
            if n < max_out:
                break
            warnings.warn(f"discover_chunks: candidate budget hit ({n}); "
                          f"retrying with max_out={max_out * 2}")
            max_out *= 2
        if n == 0:
            return np.zeros((0,), np.int64)
        ids = ids[:n].cpu().numpy()
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
        for start in range(0, len(slots), budget):
            chunk_slots = slots[start:start + budget]
            quality, updated = tsdf_ops.integrate_frame_fused(
                self.batch, self.origins, self._idx(chunk_slots), None, depth, rgb, quality_map,
                pose, float(sign), self.intr, self.cfg, with_color=with_color)
            if with_color and keyframe_id is not None:
                self._record_obs(chunk_slots, quality, updated, keyframe_id, sign)
            self._mark_dirty(chunk_slots)
        return slots

    def _record_obs(self, slots: np.ndarray, quality: torch.Tensor,
                    updated: torch.Tensor, kf_id: int, sign: float) -> None:
        up = updated.cpu().numpy()
        sl = np.asarray(slots, np.int64)[up]
        if sign > 0:
            self._obs_q[sl, kf_id] = quality.cpu().numpy()[up]
            self._obs_mask[sl, kf_id] = True
        else:
            self._obs_q[sl, kf_id] = 0.0
            self._obs_mask[sl, kf_id] = False

    def _mark_dirty(self, slots: np.ndarray) -> None:
        """Updated chunks and their 6-neighbours need remeshing
        (ref: Chisel.h:184-216 FinalizeIntegrateChunks)."""
        if len(slots) == 0:
            return
        nb = (self.ids[slots][:, None, :]
              + geometry.neighbor_offsets_6()[None]).reshape(-1, 3)
        res = self.alloc.lookup(nb)
        self.dirty_mesh.update(res[res >= 0].tolist())
        self.dirty_mesh.update(int(s) for s in np.asarray(slots).tolist())

    def _pose(self, cam_to_world) -> torch.Tensor:
        return torch.as_tensor(cam_to_world, dtype=torch.float32, device=self.device)

    def _idx(self, slots: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

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
        for start in range(0, len(slots), budget):
            chunk_slots = slots[start:start + budget]
            quality, updated = tsdf_ops.reintegrate_frame_fused(
                self.batch, self.origins, self._idx(chunk_slots), None, depth, rgb,
                quality_map, p_old, p_new, self.intr, self.cfg)
            self._record_obs(chunk_slots, quality, updated, keyframe_id, 1.0)
            self._mark_dirty(chunk_slots)
        return slots

    def _integrate_depths(self, depths: Sequence[torch.Tensor], poses: Sequence[np.ndarray],
                          signs, slots: np.ndarray) -> None:
        d = torch.stack([x.to(self.device) for x in depths])
        p = self._pose(np.stack(poses))
        budget = self.cfg.max_update_chunks
        for start in range(0, len(slots), budget):
            tsdf_ops.integrate_depths_batched(
                self.batch, self.origins, self._idx(slots[start:start + budget]), None, d, p,
                signs, self.intr, self.cfg)

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

    def garbage_collect(self, slots: np.ndarray) -> np.ndarray:
        """Free the chunks among `slots` whose rows hold no weight
        (ref: Chisel.h:472-477 GarbageCollect). Returns the freed slots."""
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return slots
        occ = self.batch.weight[self._idx(slots)].abs().sum(-1).cpu().numpy()
        empty = slots[occ <= 0.0]
        self.release(empty)
        return empty

    def gc_new_chunks(self) -> np.ndarray:
        """GC pass over the chunks allocated since the last pass: those
        with no observation entry are probed for occupancy (depth-only
        local frames add weight without observations) and freed when
        empty (ref: Chisel.h:184-216). Returns the freed slots."""
        if not self.new_since_gc:
            return np.zeros(0, np.int64)
        cand = np.asarray(sorted(self.new_since_gc), np.int64)
        cand = cand[self.used[cand] & ~self._obs_mask[cand].any(axis=1)]
        self.new_since_gc.clear()
        return self.garbage_collect(cand)
