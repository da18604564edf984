"""TSDF chunk streaming: host offload of cold chunks.

Port of texturefusion_tpu/fusion/streaming.py. The device slot pool is
finite: chunks far from the camera (or beyond the resident budget,
farthest first) move to host memory and their slots are recycled; a
revisited chunk is restored into a fresh slot before discovery assigns
slots (TSDFVolume.discover_chunks calls ensure_resident). The reference
keeps its whole chunk map in CPU memory; here this is what bounds device
memory while the map grows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.parallel.sharded_tsdf import TSDF_FIELDS


class ChunkStreamer:
    def __init__(self, volume: TSDFVolume, max_resident: int, offload_radius: float = 6.0):
        self.volume = volume
        self.max_resident = max_resident
        self.offload_radius = offload_radius
        # chunk id -> host rows (sdf, weight, color, color_count) and its
        # observation row
        self.cold: Dict[Tuple[int, int, int], tuple] = {}
        self.offloaded = 0        # chunks moved to the host, in all
        self.restored = 0         # chunks brought back, in all
        # called with the ids of the chunks each restore brought back (the
        # pipeline's mesher forgets their frozen meshes)
        self.on_restore = None

    def n_cold(self) -> int:
        return len(self.cold)

    def offload_cold(self, camera_position: np.ndarray) -> int:
        """Move the chunks beyond offload_radius, or beyond the resident
        budget (farthest first), to host memory and free their slots.
        Returns the number offloaded."""
        vol = self.volume
        act = vol.active_slots()
        if len(act) == 0:
            return 0
        centers = (vol.ids[act].astype(np.float64) + 0.5) * vol.extent
        dist = np.linalg.norm(centers - np.asarray(camera_position), axis=-1)
        over_budget = max(len(act) - self.max_resident, 0)
        victims = act[dist > self.offload_radius]
        if over_budget > len(victims):
            victims = act[np.argsort(-dist)[:over_budget]]
        if len(victims) == 0:
            return 0
        rows = vol.rows.gather(victims, fields=TSDF_FIELDS, device="cpu")
        vol.flush_observations()    # the offloaded rows carry their final entries
        for r, s in enumerate(victims.tolist()):
            self.cold[tuple(vol.ids[s].tolist())] = tuple(a[r] for a in rows) + (
                vol.obs_row(s),)
        vol.release(victims)
        self.offloaded += len(victims)
        return len(victims)

    def ensure_resident(self, ids: np.ndarray) -> int:
        """Restore the offloaded chunks among `ids` (N, 3) into allocated
        slots, their rows and observation entries as they left. Returns
        the number restored."""
        if not self.cold:
            return 0
        vol = self.volume
        hits = [c for c in map(tuple, np.asarray(ids, np.int32).tolist()) if c in self.cold]
        if not hits:
            return 0
        slots = vol.allocate(np.asarray(hits, np.int32))
        ok = slots >= 0
        if not ok.any():
            return 0
        kept = [h for h, k in zip(hits, ok) if k]
        rows = [self.cold.pop(h) for h in kept]
        vol.rows.put(slots[ok], [torch.stack([r[i] for r in rows]) for i in TSDF_FIELDS],
                     fields=TSDF_FIELDS)
        for s, r in zip(slots[ok].tolist(), rows):
            vol.set_obs_row(int(s), r[4])
            vol.dirty_mesh.add(int(s))
        self.restored += len(kept)
        if self.on_restore is not None:
            self.on_restore(kept)
        return len(kept)
