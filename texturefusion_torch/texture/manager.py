"""Texture manager: view selection → patches → atlas → colour compensation.

Port of texturefusion_tpu/texture/manager.py, the texture stages of the
reference's map cycle (ref: GCFusion/MobileFusion.cpp:330-384 —
wrong-mapping datacost removal :330-343, view_selection :362-369,
GeneratePatches :374, CompensateColor :380, UpdateAtlas :382), driving
texture/{mrf,patch,color,kfstack}.py.

Incremental (ref: TexMap.cpp:257-406): the MRF is solved over every
meshed chunk each cycle, but projection, uv and wrong mapping run only
for chunks whose label flipped or whose mesh changed. Keyframe images
live in a device stack written once per keyframe; per-chunk colour
moments stay on the device, so the per-keyframe compensation still sees
every patched vertex.

`update` is one synchronous cycle: the device program, one host read of
its outputs, then the host work (atlas blits, uv and labels, poisoning,
carry-over, transfers). The JAX package splits it into a dispatch and a
consume one cycle later to hide its device link; the port does not. The
program reads the mesh pool through the mesher's reader, so a pool
sharded over several devices is textured as one is: the texture state
([S+1] labels, moments, failed) and the keyframe stack stay on the
manager's device (the mesh's first), as the JAX package keeps them
unsharded, and a cycle gathers the rows of the chunks it projects from
their shards.
Unlike the JAX package, the manager releases a slot's texture state
(atlas patch, ChunkTexture, label, moment and failed rows, warm start)
when the mesher drops the slot (GC, streaming), so a recycled slot
starts clean (ROADMAP Queue 3 fault 8), and a chunk found wrong is not
projected again until its selection or its mesh changes (fault 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.texture import patch as patch_ops
from texturefusion_torch.texture.atlas import Atlas
from texturefusion_torch.texture.kfstack import KeyframeStack
from texturefusion_torch.texture.mrf import ViewSelector
from texturefusion_torch.utils.stopwatch import STOPWATCH


class NoTexturedChunks(RuntimeError):
    """export_textured found no chunk with a texture patch to export."""


class ChunkTexture:
    __slots__ = ("label", "atlas_uv", "uv16", "uv_valid", "color_adjust", "wrong")

    def __init__(self):
        self.label = -1
        self.atlas_uv: Optional[np.ndarray] = None      # [P, 2] in [0, 1]
        self.uv16: Optional[np.ndarray] = None          # [P, 2] keyframe pixel × 16
        self.uv_valid: Optional[np.ndarray] = None      # [P]
        self.color_adjust: Optional[np.ndarray] = None  # [P, 3], set by the export
        self.wrong = False


def _to_host(tensors):
    """Copy tensors to the host behind one synchronisation."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class TextureManager:
    def __init__(self, config: PipelineConfig, device="cuda"):
        self.config = config
        self.cfg = config.texture
        self.device = torch.device(device)
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.selector = ViewSelector(max_labels=self.cfg.max_labels,
                                     potts_weight=self.cfg.mrf_potts_weight,
                                     edge_weight=self.cfg.mrf_edge_weight,
                                     sweeps=self.cfg.mrf_sweeps, device=self.device)
        self.atlas = Atlas(self.cfg, config.tsdf.voxel_resolution)
        self.chunk_tex: Dict[int, ChunkTexture] = {}
        self.kf_stack = KeyframeStack(self.intr.height, self.intr.width,
                                      initial=self.cfg.kf_stack_initial, device=self.device)
        self._labels_dev: Optional[torch.Tensor] = None  # [S+1] int32 label per slot
        self._stats_dev: Optional[torch.Tensor] = None   # [S+1, STATS_W] f32 moments
        self._failed_dev: Optional[torch.Tensor] = None  # [S+1] int32 keyframe found wrong
        self._carry: set = set()       # changed chunks left past the projection budget
        self._kf_transfer: Optional[dict] = None

    def _ensure_state(self, mesher) -> None:
        if self._labels_dev is None:
            s1 = mesher.pool_rows.n_rows
            self._labels_dev = torch.full((s1,), -1, dtype=torch.int32, device=self.device)
            self._stats_dev = torch.zeros((s1, patch_ops.STATS_W), device=self.device)
            self._failed_dev = torch.full((s1,), -1, dtype=torch.int32, device=self.device)

    def release(self, slots) -> None:
        """Forget the texture state of chunk slots whose meshes were dropped."""
        slots = np.atleast_1d(np.asarray(slots, np.int64))
        for s in slots.tolist():
            self.atlas.release(s)
            self.chunk_tex.pop(s, None)
            self._carry.discard(s)
        self.selector.labels[slots[slots < len(self.selector.labels)]] = -1
        if self._labels_dev is not None and len(slots):
            idx = torch.as_tensor(slots, device=self.device)
            self._labels_dev[idx] = -1
            self._stats_dev[idx] = 0.0
            self._failed_dev[idx] = -1

    # ------------------------------------------------------------- cycle

    def update(self, volume, mesher, kf_states: Dict[int, object], newest_kf: int,
               remeshed: Optional[set] = None) -> None:
        """One texture cycle. kf_states: keyframe slot → object with `pose`,
        `rgb` (uint8 [H, W, 3] tensor), `depth` and `rgb_host()` (uint8
        numpy, for the atlas blits)."""
        with STOPWATCH.time("tex_adjacency"):
            meshed, nbr = mesher.chunk_adjacency_arrays()
        if len(meshed) == 0:
            return
        self._ensure_state(mesher)
        with STOPWATCH.time("tex_build"):
            problem, slots, rmask, want = self.build_cycle(volume, meshed, nbr, kf_states,
                                                           newest_kf, remeshed)
        with STOPWATCH.time("tex_device"):
            # the program and the wait for it (eigh reads cuSOLVER's error
            # flag back inside it) and for the pool rows copied from the
            # other shards' devices
            out = self.run_cycle(problem, slots, rmask, newest_kf,
                                 mesher.pool_reader(self.device))
            for dev in dict.fromkeys((self.device,) + mesher.volume.mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
        with STOPWATCH.time("tex_fetch"):
            (rows, proj_kf, n_changed, uv16, uv_ok, bmin, bmax, wrong,
             t_np, mt_np, mv_np) = _to_host(list(out))
        with STOPWATCH.time("tex_host"):
            self._consume(volume, mesher, kf_states, slots, want, rows, proj_kf,
                          int(n_changed), uv16, uv_ok, bmin, bmax, wrong, t_np, mt_np, mv_np)

    def build_cycle(self, volume, meshed, nbr, kf_states, newest_kf: int,
                    remeshed: Optional[set]):
        """A cycle's host inputs: (the MRF problem over the meshed chunks,
        its node slots, the mask of the nodes remeshed or carried over,
        that set). Writes each keyframe's images into the stack once, and
        every keyframe's current pose."""
        obs_q, obs_mask = volume.obs_arrays()
        problem, slots, _ = self.selector.build_problem_arrays(
            obs_q, obs_mask, meshed, nbr, volume.ids, newest_kf)
        for kf in sorted(kf_states):
            # a keyframe's images are written once, at the first cycle
            # that sees it (the newest one's before tracking refines
            # its depth), as the JAX package does
            st = kf_states[kf]
            if kf not in self.kf_stack.present:
                self.kf_stack.add(kf, st.rgb, st.depth, st.pose)
            self.kf_stack.set_pose(kf, st.pose)
        want = (remeshed or set()) | self._carry
        rmask = np.zeros(len(slots), bool)
        if want:
            rmask = np.isin(slots, np.fromiter(want, np.int64, len(want)))
        return problem, slots, rmask, want

    def run_cycle(self, problem, slots, rmask, newest_kf: int, pool,
                  state=None) -> patch_ops.IncrementalCycleOut:
        """The cycle's device program over `pool` (a PoolReader), updating
        the texture state in place: the manager's labels, moments and
        failed rows, or the `state` triple given (copies, to compare)."""
        dev = self.device
        labels, stats, failed = state or (self._labels_dev, self._stats_dev, self._failed_dev)
        return patch_ops.texture_cycle(
            problem, torch.as_tensor(slots, device=dev), labels, stats, failed,
            torch.as_tensor(rmask, device=dev), pool, self.kf_stack.rgb_packed,
            self.kf_stack.depth, torch.as_tensor(self.kf_stack.poses, device=dev),
            max(newest_kf - 1, 0), self.intr, self.cfg, self.cfg.mrf_sweeps,
            self.cfg.patch_project_budget)

    def _consume(self, volume, mesher, kf_states, slots, want, rows, proj_kf, n_changed,
                 uv16, uv_ok, bmin, bmax, wrong, t_np, mt_np, mv_np) -> None:
        """The cycle's host work: atlas blits, uv and label bookkeeping,
        wrong-mapping poisoning, the carry-over, per-keyframe transfers."""
        m = min(n_changed, self.cfg.patch_project_budget)
        projected = set()
        for i in range(m):
            s = int(slots[int(rows[i])])
            kf = int(proj_kf[i])
            projected.add(s)
            tex = self.chunk_tex.setdefault(s, ChunkTexture())
            if wrong[i] or kf not in kf_states:
                if wrong[i] and kf >= 0:
                    # poison so the MRF selects again (ref: MobileFusion.cpp:330-343)
                    volume.poison_observation(s, kf)
                tex.wrong = True
                continue
            rec = self.atlas.patches.get(s)
            # blit again on a new patch, a new label, or when the remeshed
            # surface left the stored bbox (atlas_uv clamps to it)
            escaped = (rec is not None and rec.kf_id == kf
                       and ((bmin[i] < rec.bbox_min - 0.5).any()
                            or (bmax[i] > rec.bbox_max + 0.5).any()))
            if rec is None or rec.kf_id != kf or escaped:
                rec = self.atlas.add_or_update_patch(s, kf, bmin[i], bmax[i],
                                                     kf_states[kf].rgb_host())
                if rec is None:
                    # atlas full (ref: Atlas.cpp:52-53): stop, and drop the
                    # carry so catch-up passes do not spin on it
                    self._carry = set()
                    return
            nv = int(mesher.vcount[s])
            tex.label = kf
            tex.wrong = False
            self.selector.labels[s] = kf
            tex.uv16 = uv16[i, :nv]
            tex.atlas_uv = self.atlas.atlas_uv(s, uv16[i, :nv].astype(np.float32) / 16.0)
            tex.uv_valid = uv_ok[i, :nv]
        # changed chunks past the projection budget carry over to the next cycle
        if n_changed > m:
            in_graph = set(slots.tolist())
            self._carry = {s for s in want if s not in projected and s in in_graph}
        else:
            self._carry = set()
        # per-keyframe colour transfers for the export's bake
        self._kf_transfer = {kf: (t_np[kf], mt_np[kf], mv_np[kf])
                             for kf in sorted(kf_states) if kf < len(t_np)}

    def bake_compensation_into_atlas(self) -> int:
        """Apply each patch's keyframe colour transfer to its atlas tile, so
        the exported texture carries the global colour consistency (the
        reference applies it per vertex in its shader). Returns the number
        of tiles baked; a second call bakes nothing."""
        transfers = self._kf_transfer
        if not transfers:
            return 0
        n = 0
        ps = self.atlas.patch_size
        for rec in self.atlas.patches.values():
            tr = transfers.get(rec.kf_id)
            if tr is None:
                continue
            t, mu_t, mu_v = tr
            ox, oy = self.atlas._slot_origin(rec.slot_index)
            tile = self.atlas.image[oy:oy + ps, ox:ox + ps].astype(np.float32) / 255.0
            fixed = (tile - mu_t) @ t.T + mu_v
            self.atlas.image[oy:oy + ps, ox:ox + ps] = np.clip(fixed * 255.0, 0, 255).astype(
                np.uint8)
            n += 1
        self._kf_transfer = None
        return n

    # ------------------------------------------------------------- export

    def _sample_atlas(self, uv: np.ndarray) -> np.ndarray:
        """Bilinear sample of the atlas at normalized uv [P, 2] (v up) →
        [P, 3] float 0..1. Rows are clamped to the materialized image:
        the JAX package clamps to the full atlas size and reads past the
        image for a vertex on the bottom edge of the last materialized
        patch row (ROADMAP Queue 3 fault 1)."""
        sz = self.atlas.size
        rows = self.atlas.image.shape[0]
        x = np.clip(uv[:, 0] * sz, 0, sz - 1)
        y = np.clip((1.0 - uv[:, 1]) * sz, 0, rows - 1)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        x1 = np.minimum(x0 + 1, sz - 1)
        y1 = np.minimum(y0 + 1, rows - 1)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        img = self.atlas.image

        def at(yy, xx):
            return img[yy, xx].astype(np.float32) / 255.0

        return ((at(y0, x0) * (1 - fx) + at(y0, x1) * fx) * (1 - fy)
                + (at(y1, x0) * (1 - fx) + at(y1, x1) * fx) * fy)

    def export_textured(self, mesher, out_dir: str, name: str = "model") -> str:
        """Textured OBJ + MTL + PNG of the patched resident chunks with
        per-vertex compensated colours (ref: Atlas.cpp:93-179; per-vertex
        corrected colours Chisel.cpp:270-284 and the wrong-mapping voxel
        colour fallback, draw_mesh.vert:29-70). The keyframe transfers are
        baked into the atlas tiles; each vertex carries its corrected
        colour (ChunkTexture.color_adjust = corrected − raw sample), or the
        fused voxel colour where its projection was invalid. Offloaded
        (frozen) chunks are left out, as in the JAX package."""
        meshes = mesher.meshes
        parts = []
        for slot in sorted(self.chunk_tex):
            tex = self.chunk_tex[slot]
            if tex.atlas_uv is None or slot not in meshes:
                continue
            parts.append((slot, tex, min(len(meshes[slot][0]), len(tex.atlas_uv))))
        if not parts:
            raise NoTexturedChunks("no textured chunks to export")
        uvs = np.concatenate([tex.atlas_uv[:k] for _, tex, k in parts])
        raw = self._sample_atlas(uvs)                    # before the bake
        self.bake_compensation_into_atlas()
        corrected = self._sample_atlas(uvs)
        vs, fs, cols = [], [], []
        base = 0
        for slot, tex, k in parts:
            v, f, c, _ = meshes[slot]
            cor, r = corrected[base:base + k], raw[base:base + k]
            tex.color_adjust = cor - r
            col = cor
            if tex.uv_valid is not None:
                # invalid projections show the fused voxel colour
                col = np.where(np.asarray(tex.uv_valid[:k], bool)[:, None], cor, c[:k])
            vs.append(v[:k])
            cols.append(col)
            fs.append(f[(f < k).all(axis=1)] + base)
            base += k
        return self.atlas.save_textured_model(out_dir, np.concatenate(vs), np.concatenate(fs),
                                              uvs, name, vertex_colors=np.concatenate(cols))
