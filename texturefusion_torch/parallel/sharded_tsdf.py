"""Chunk-slot rows sharded over a device mesh.

Port of texturefusion_tpu/parallel/sharded_tsdf.py (BASELINE.json configs
4-5): TSDF chunk slots are partitioned across the devices, the natural
shard axis, since integration, meshing and texture work are chunk-local
(SURVEY.md §2.3). The images are replicated; each shard updates only
its own rows.

Placement: slot s lives on shard s % n, at local row s // n. The JAX
docstring promises round-robin slots so that new surface spreads
evenly, but its allocator hands slots out in ascending order and
NamedSharding(P(axis)) cuts the slot axis into contiguous blocks, so the
first device holds and updates the whole of a young map (ROADMAP fault
14). Round robin over the ascending slots gives every shard an even
share; each row's update is independent, so the placement changes no
result.

`ShardedRows` is the container that TSDFVolume and the mesher keep their
rows in (one shard on one device when unsharded): gather rows by slot,
put rows, fill rows, and `launch(fn, slots)`, which splits a slot list by
owner, calls fn on each shard's rows with local indices, and
reassembles fn's per-lane outputs in the listed order. A slot list the
device chose (the texture cycle's projected chunks) is gathered by
`gather_rows` without a host read, and a whole per-slot column by
`column`.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from texturefusion_torch.config import TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.parallel.mesh import DeviceMesh


def on_device(device: torch.device):
    """The context that makes `device` current: a hand kernel launches on
    the current GPU, so a shard on another card must be made current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedRows:
    """Slot-indexed row tensors over a mesh: `parts[k]` is shard k's tuple
    of tensors (leading dim rows_per_shard) on mesh.devices[k], and
    holds slots k, k + n, k + 2n, ..."""

    def __init__(self, mesh: DeviceMesh, parts: List[Tuple[torch.Tensor, ...]]):
        self.mesh = mesh
        self.parts = parts
        self.rows_per_shard = int(parts[0][0].shape[0])
        # per (tag, shard): calls made by launch(), for the launch tables
        self.calls: Dict[Tuple[str, int], int] = collections.Counter()
        # rows handed out by gather / gather_rows, and whole columns by column
        self.rows_read = 0
        self.columns_read = 0

    @classmethod
    def build(cls, mesh: DeviceMesh, n_rows: int,
              make: Callable[[int, torch.device], Sequence[torch.Tensor]]) -> "ShardedRows":
        """n_rows slots (a multiple of the mesh size); make(rows, device)
        builds one shard's tensors."""
        if n_rows % mesh.size:
            raise ValueError(f"{n_rows} rows do not split over {mesh.size} shards")
        return cls(mesh, [tuple(make(n_rows // mesh.size, d)) for d in mesh.devices])

    @classmethod
    def from_full(cls, mesh: DeviceMesh, tensors: Sequence[torch.Tensor]) -> "ShardedRows":
        """Slot-ordered tensors [S, ...] (S a multiple of the mesh size)
        placed slot s on shard s % n."""
        n = mesh.size
        if tensors[0].shape[0] % n:
            raise ValueError(f"{tensors[0].shape[0]} rows do not split over {n} shards")
        return cls(mesh, [tuple(t[k::n].to(d).contiguous() for t in tensors)
                          for k, d in enumerate(mesh.devices)])

    @property
    def n_rows(self) -> int:
        return self.rows_per_shard * self.mesh.size

    @property
    def sharded(self) -> bool:
        return self.mesh.size > 1

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for p in self.parts for t in p)

    def split(self, slots: np.ndarray) -> List[Tuple[int, np.ndarray, torch.Tensor]]:
        """(shard, positions in `slots`, local rows on the shard's device)
        for every shard that owns some of `slots`."""
        slots = np.asarray(slots, np.int64)
        n = self.mesh.size
        if n == 1:
            return [(0, np.arange(len(slots)),
                     torch.as_tensor(slots, device=self.mesh.devices[0]))]
        owner, rows = self.mesh.shard_of(slots), self.mesh.local_row(slots)
        out = []
        for k in range(n):
            pos = np.nonzero(owner == k)[0]
            if len(pos):
                out.append((k, pos, torch.as_tensor(rows[pos], device=self.mesh.devices[k])))
        return out

    def gather(self, slots: np.ndarray, fields: Optional[Sequence[int]] = None,
               device=None) -> Tuple[torch.Tensor, ...]:
        """Copies of the rows of `slots`, in the listed order, on `device`
        (the mesh's first by default)."""
        fields = range(len(self.parts[0])) if fields is None else fields
        device = self.mesh.devices[0] if device is None else torch.device(device)
        pieces = self.split(slots)
        self.rows_read += len(slots)
        if self.mesh.size == 1:
            _, _, idx = pieces[0]
            return tuple(self.parts[0][f][idx].to(device) for f in fields)
        outs = []
        for f in fields:
            t = self.parts[0][f]
            out = torch.empty((len(slots),) + t.shape[1:], dtype=t.dtype, device=device)
            for k, pos, idx in pieces:
                out[torch.as_tensor(pos, device=device)] = self.parts[k][f][idx].to(device)
            outs.append(out)
        return tuple(outs)

    def gather_rows(self, slots: torch.Tensor, fields: Sequence[int],
                    device=None) -> Tuple[torch.Tensor, ...]:
        """Copies of the rows of a slot tensor, in its order, on `device`
        (the mesh's first by default), with no host read: every shard
        gathers every lane, at its local row where it owns the slot and at
        row 0 elsewhere, and the copies are merged by owner with
        torch.where, so each lane holds its owner's row exactly. Each
        shard moves len(slots) rows; one shard indexes its rows."""
        device = self.mesh.devices[0] if device is None else torch.device(device)
        n = self.mesh.size
        self.rows_read += int(slots.numel())
        if n == 1:
            idx = slots.to(self.mesh.devices[0])
            return tuple(self.parts[0][f][idx].to(device) for f in fields)
        slots = slots.to(device)
        owner, local = slots % n, slots // n
        outs: List[Optional[torch.Tensor]] = [None] * len(fields)
        for k, dev in enumerate(self.mesh.devices):
            mine = owner == k
            idx = torch.where(mine, local, 0).to(dev)
            for i, f in enumerate(fields):
                rows = self.parts[k][f][idx].to(device)
                if outs[i] is None:
                    outs[i] = rows
                else:
                    lanes = mine.reshape(mine.shape + (1,) * (rows.dim() - mine.dim()))
                    outs[i] = torch.where(lanes, rows, outs[i])
        return tuple(outs)

    def column(self, field: int, device=None) -> torch.Tensor:
        """The whole per-slot column `field` in slot order on `device` (the
        mesh's first by default): the inverse of from_full's t[k::n],
        shard k's row r being slot r·n + k."""
        device = self.mesh.devices[0] if device is None else torch.device(device)
        self.columns_read += 1
        if self.mesh.size == 1:
            return self.parts[0][field].to(device)
        t = torch.stack([p[field].to(device) for p in self.parts], dim=1)
        return t.reshape((self.n_rows,) + t.shape[2:])

    def put(self, slots: np.ndarray, values: Sequence[torch.Tensor],
            fields: Optional[Sequence[int]] = None) -> None:
        """Write rows [len(slots), ...] (in the listed order) into `slots`."""
        fields = range(len(self.parts[0])) if fields is None else fields
        for k, pos, idx in self.split(slots):
            dev = self.mesh.devices[k]
            for f, v in zip(fields, values):
                part = v if self.mesh.size == 1 else v[torch.as_tensor(pos, device=v.device)]
                self.parts[k][f][idx] = part.to(dev, self.parts[k][f].dtype)

    def fill(self, slots: np.ndarray, values: Dict[int, float]) -> None:
        """Set whole rows of `slots` to a constant, field by field."""
        for k, _, idx in self.split(slots):
            for f, v in values.items():
                self.parts[k][f][idx] = v

    def launch(self, fn: Callable[[int, Tuple[torch.Tensor, ...], torch.Tensor],
                                  Optional[tuple]],
               slots: np.ndarray, tag: str = "") -> Tuple[torch.Tensor, ...]:
        """fn(shard, shard's tensors, local rows) on every shard that owns
        some of `slots`; fn returns per-lane outputs (or None), reassembled
        here in the listed order on the mesh's first device."""
        pieces = self.split(slots)
        results = []
        for k, pos, idx in pieces:
            self.calls[(tag, k)] += 1
            with on_device(idx.device):
                results.append(fn(k, self.parts[k], idx))
        if not results or results[0] is None:
            return ()
        if self.mesh.size == 1:
            return tuple(results[0])
        dev0 = self.mesh.devices[0]
        outs = []
        for i, first in enumerate(results[0]):
            out = torch.empty((len(slots),) + first.shape[1:], dtype=first.dtype, device=dev0)
            for (_, pos, _), r in zip(pieces, results):
                out[torch.as_tensor(pos, device=dev0)] = r[i].to(dev0)
            outs.append(out)
        return tuple(outs)

    def per_shard(self, tag: str) -> List[int]:
        """launch() calls under `tag`, per shard."""
        return [self.calls[(tag, k)] for k in range(self.mesh.size)]


# volume_rows' fields: the TSDF rows, then each slot's chunk origin
TSDF_FIELDS, ORIGIN_FIELD = (0, 1, 2, 3), 4


def volume_rows(mesh: DeviceMesh, n_rows: int, n_voxels: int) -> ShardedRows:
    """The TSDF rows (sdf, weight, color, color_count, origins), reset."""
    def make(rows, dev):
        return tuple(tsdf_ops.make_empty_batch(rows, n_voxels, dev)) + (
            torch.zeros((rows, 3), dtype=torch.float32, device=dev),)
    return ShardedRows.build(mesh, n_rows, make)


def make_sharded_batch(capacity: int, n_voxels: int, mesh: DeviceMesh
                       ) -> Tuple[ShardedRows, ShardedRows]:
    """Slot rows sharded on the chunk axis (capacity a multiple of the mesh
    size), as (batch rows (sdf, weight, color, color_count), origin rows)."""
    rows = volume_rows(mesh, capacity, n_voxels)
    return (ShardedRows(mesh, [p[:4] for p in rows.parts]),
            ShardedRows(mesh, [p[4:] for p in rows.parts]))


def sharded_integrate_step(mesh: DeviceMesh, intr: cam.Intrinsics, cfg: TSDFConfig):
    """The all-slots integration step with the chunk rows sharded: every
    shard updates every one of its rows against the (replicated) frame, in
    place (K2 on CUDA shards), with no traffic between shards but the
    images. `active` ([S] bool, sharded like the rows) masks the
    allocated slots.

    step(batch, origins, active, depth, rgb, quality, cam_to_world, sign)
    -> per-slot chunk quality [S] on the mesh's first device."""
    def step(batch: ShardedRows, origins: ShardedRows, active: ShardedRows,
             depth, rgb, quality, cam_to_world, sign: float) -> torch.Tensor:
        def fn(k, part, idx):
            dev = idx.device
            q, _ = tsdf_ops.integrate_frame_fused(
                tsdf_ops.ChunkBatch(*part), origins.parts[k][0], idx, active.parts[k][0],
                depth.to(dev), rgb.to(dev), quality.to(dev), cam_to_world.to(dev),
                float(sign), intr, cfg, with_color=True)
            return (q,)

        return batch.launch(fn, np.arange(batch.n_rows), tag="sharded_step")[0]

    return step
