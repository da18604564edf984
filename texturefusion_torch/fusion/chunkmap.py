"""Chunked TSDF volume: slot-indexed device rows + host-side allocator.

Port of texturefusion_tpu/fusion/chunkmap.py (ref:
Structure/ChunkManager.h:119-1306 ChunkManager; Structure/Chisel.h:103-249
PrepareIntersectChunks / IntegrateDepthScanColor). The TSDF lives in
dense [capacity + 1, 512] tensors on `device`; the native allocator maps
integer chunk IDs to slots. Slot `capacity` is a trash row that padded
slot lists point at; the volume itself lists only its real slots.

Unlike the JAX package, every host read is synchronous: discovery reads
its unique ids and count at once, and each integration records its
per-chunk observation quality right away.
"""

from __future__ import annotations

import warnings
from typing import Optional, Set

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

    @property
    def extent(self) -> float:
        return self.cfg.chunk_size * self.cfg.voxel_resolution

    def n_active(self) -> int:
        return int(self.used.sum())

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.used)[0]

    def obs_arrays(self):
        """(quality [cap+1, max_kf] f32, present [cap+1, max_kf] bool)."""
        return self._obs_q, self._obs_mask

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
        slots, new_slots = self.alloc.touch(ids[:n].cpu().numpy(), allocate=allocate)
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
        pose = torch.as_tensor(cam_to_world, dtype=torch.float32, device=self.device)
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
            idx = torch.as_tensor(np.asarray(chunk_slots, np.int64), device=self.device)
            quality, updated = tsdf_ops.integrate_frame_fused(
                self.batch, self.origins, idx, None, depth, rgb, quality_map,
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
