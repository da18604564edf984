"""Texture atlas: fixed-size patch allocator and the textured model export.

Port of texturefusion_tpu/texture/atlas.py (ref: Structure/Atlas.{h,cpp}
— 13824² RGB8 atlas Atlas.h:29-31, patch slot size floor(4800·res)
Atlas.h:62-65, AddPatch linear allocator Atlas.cpp:43-64, ROI blit with
resize UpdateBuffer :71-91, SaveTexturedModel OBJ+MTL+PNG :93-179).

The atlas is a host RGB image of square patch slots in a grid. A chunk's
patch is its keyframe's bbox region, resized into the slot by
`resize_bilinear` (in place of `cv2.resize(INTER_LINEAR)`); vertex atlas
uvs map bbox-relative coordinates into the slot. The image holds only
the rows that slots have used so far (slots fill the top rows first).

A texture cycle places all of its patches at once (`place_patches`):
the records in order, then every region resized in one pass
(`resize_patches`: on the card one launch of kernel K4,
csrc/atlas_blit.cu, and one copy to the host; on the CPU
`resize_bilinear` patch by patch, the plain version K4 equals bit for
bit) and scattered into the image in one assignment. `atlas_uvs` maps
the uvs of many chunks at once. The one-patch calls `add_or_update_patch`
and `atlas_uv` are those with one chunk.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from texturefusion_torch.config import TextureConfig
from texturefusion_torch.io.png import write_png
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.utils import async_fetch


@dataclasses.dataclass
class PatchRecord:
    slot_index: int            # linear patch slot in the atlas grid
    kf_id: int
    bbox_min: np.ndarray       # [2] in keyframe image coords
    bbox_max: np.ndarray


def _taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Source taps of a half-pixel-centred linear resize along one axis:
    (i0, i1, weight of i1), edges clamped."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """[h, w, C] uint8 → [height, width, C] uint8 by bilinear interpolation
    at half-pixel centres with clamped edges, rounded to the nearest level
    (cv2.resize INTER_LINEAR's sampling; cv2 uses 11-bit fixed-point
    weights, so the two agree to within one level)."""
    y0, y1, fy = _taps(image.shape[0], height)
    x0, x1, fx = _taps(image.shape[1], width)
    img = image.astype(np.float32)
    fx, fy = fx[None, :, None], fy[:, None, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return np.clip(np.floor(top * (1 - fy) + bot * fy + 0.5), 0, 255).astype(np.uint8)


def roi_table(src: np.ndarray, bbox_min: np.ndarray, bbox_max: np.ndarray, height: int,
              width: int) -> np.ndarray:
    """[n, 5] int64 rows (source index, x0, y0, x1, y1): each patch's
    region of its [height, width] keyframe image, cut from its bbox as the
    atlas always cut it (the corners truncated to integers, at least one
    pixel a side, the ends exclusive and clamped to the image)."""
    lo = np.asarray(bbox_min).reshape(-1, 2).astype(np.int64)
    hi = np.asarray(bbox_max).reshape(-1, 2).astype(np.int64)
    x1 = np.minimum(np.maximum(hi[:, 0] + 1, lo[:, 0] + 1), width)
    y1 = np.minimum(np.maximum(hi[:, 1] + 1, lo[:, 1] + 1), height)
    table = np.stack([np.asarray(src, np.int64), lo[:, 0], lo[:, 1], x1, y1], axis=1)
    if len(table) and ((lo < 0).any() or (table[:, 1] >= x1).any()
                       or (table[:, 2] >= y1).any()):
        raise ValueError("a patch region lies outside its keyframe image")
    return table


def resize_patches(images: Sequence[torch.Tensor], table: np.ndarray, size: int) -> np.ndarray:
    """Every region of `table` (roi_table's rows) resized to size × size:
    [n, size, size, 3] uint8 on the host, row i resize_bilinear of
    images[src][y0:y1, x0:x1]. `images`: [H, W, 3] uint8 tensors on one
    device. On the card: one launch of kernel K4 and one copy of its
    output to the host; on the CPU: resize_bilinear patch by patch."""
    if len(table) == 0:
        return np.zeros((0, size, size, 3), np.uint8)
    if images[0].is_cuda:
        return async_fetch.fetch_async(cuda_kernels.atlas_blit_cuda(images, table, size)).result()
    hosts = [t.numpy() for t in images]
    out = np.empty((len(table), size, size, 3), np.uint8)
    for i, (s, x0, y0, x1, y1) in enumerate(table.tolist()):
        out[i] = resize_bilinear(hosts[s][y0:y1, x0:x1], size, size)
    return out


class Atlas:
    def __init__(self, cfg: TextureConfig, voxel_resolution: float):
        self.cfg = cfg
        self.patch_size = max(int(cfg.patch_scale * voxel_resolution), 16)
        self.size = cfg.atlas_size
        self.grid = self.size // self.patch_size
        self.capacity = self.grid * self.grid
        # only the used rows are materialized; they double as slots need them
        self._rows = self.patch_size * 4
        self.image = np.zeros((self._rows, self.size, 3), np.uint8)
        self.patches: Dict[int, PatchRecord] = {}   # chunk slot -> record
        self.free = list(range(self.capacity - 1, -1, -1))
        self.overflowed = False

    def _slot_origin(self, slot_index: int) -> Tuple[int, int]:
        gy, gx = divmod(slot_index, self.grid)
        return gx * self.patch_size, gy * self.patch_size

    def add_or_update_patch(self, chunk_slot: int, kf_id: int, bbox_min: np.ndarray,
                            bbox_max: np.ndarray, kf_rgb: np.ndarray) -> Optional[PatchRecord]:
        """place_patches for one chunk (ref: Atlas.cpp:43-91). kf_rgb:
        [H, W, 3] uint8, or float 0..1. Returns the chunk's record, or None
        when the atlas is full (ref: Atlas.cpp:52-53)."""
        if kf_rgb.dtype != np.uint8:
            kf_rgb = np.clip(kf_rgb * 255.0, 0, 255).astype(np.uint8)
        placed = self.place_patches(np.asarray([chunk_slot]), np.asarray([kf_id]),
                                    np.asarray(bbox_min)[None], np.asarray(bbox_max)[None],
                                    {kf_id: torch.from_numpy(np.ascontiguousarray(kf_rgb))})
        return self.patches[chunk_slot] if placed else None

    def place_patches(self, chunk_slots: np.ndarray, kf_ids: np.ndarray, bbox_min: np.ndarray,
                      bbox_max: np.ndarray, images: Mapping[int, torch.Tensor]) -> int:
        """Allocate (or reuse) each chunk's slot, in order, and blit its
        keyframe region (ref: Atlas.cpp:43-91): chunk_slots, kf_ids [n],
        bbox_min, bbox_max [n, 2], images keyframe id → [H, W, 3] uint8
        tensor, all on one device. A chunk that needs a new slot when none
        is free stops the placement there (ref: Atlas.cpp:52-53;
        `overflowed`). Returns the number placed: the chunks before it, or
        all; those are blitted in one resize_patches call."""
        origins = []
        for s, kf, lo, hi in zip(chunk_slots.tolist(), kf_ids.tolist(), bbox_min, bbox_max):
            rec = self.patches.get(s)
            if rec is None:
                if not self.free:
                    self.overflowed = True
                    break
                rec = self.patches[s] = PatchRecord(self.free.pop(), kf, lo, hi)
            rec.kf_id, rec.bbox_min, rec.bbox_max = kf, lo, hi
            origins.append(rec.slot_index)
        n = len(origins)
        if n:
            keys, src = np.unique(kf_ids[:n], return_inverse=True)
            srcs = [images[k] for k in keys.tolist()]
            h, w = srcs[0].shape[:2]
            tiles = resize_patches(srcs, roi_table(src, bbox_min[:n], bbox_max[:n], h, w),
                                   self.patch_size)
            gy, gx = np.divmod(np.asarray(origins, np.int64), self.grid)
            self._ensure_rows((int(gy.max()) + 1) * self.patch_size)
            self._tiles()[gy, :, gx] = tiles
        return n

    def _tiles(self) -> np.ndarray:
        """The image as a writable view [slot rows, P, grid, P, 3]: tile
        (gy, gx) is [gy, :, gx]."""
        p, img = self.patch_size, self.image
        r, c = img.strides[:2]
        return np.lib.stride_tricks.as_strided(
            img, (img.shape[0] // p, p, self.grid, p, 3), (p * r, r, p * c, c, img.strides[2]))

    def _ensure_rows(self, rows: int) -> None:
        if rows <= self._rows:
            return
        new_rows = self._rows
        while new_rows < rows:
            new_rows *= 2
        new_rows = min(new_rows, self.size)
        grown = np.zeros((new_rows, self.size, 3), np.uint8)
        grown[: self._rows] = self.image
        self._rows, self.image = new_rows, grown

    def release(self, chunk_slot: int) -> None:
        rec = self.patches.pop(chunk_slot, None)
        if rec is not None:
            self.free.append(rec.slot_index)

    def atlas_uv(self, chunk_slot: int, uv_img: np.ndarray) -> np.ndarray:
        """Keyframe-image uv [N, 2] of a chunk's vertices → atlas texture
        coordinates in [0, 1] (v flipped, the OBJ convention)."""
        uv_img = np.asarray(uv_img)
        return self.atlas_uvs(np.asarray([chunk_slot]), uv_img, np.asarray([len(uv_img)]))

    def atlas_uvs(self, chunk_slots: np.ndarray, uv_img: np.ndarray,
                  counts: np.ndarray) -> np.ndarray:
        """atlas_uv of n chunks at once: uv_img [sum(counts), 2], the
        chunks' vertices one chunk after another (counts [n] of them a
        chunk) → [sum(counts), 2], in the dtype and by the operations
        atlas_uv takes for each chunk (the chunks' bboxes of one dtype),
        so each chunk's rows equal its bits."""
        recs = [self.patches[s] for s in chunk_slots.tolist()]
        each = np.repeat(np.arange(len(recs)), counts)
        bmin = np.stack([r.bbox_min for r in recs])[each]
        bmax = np.stack([r.bbox_max for r in recs])[each]
        span = np.maximum(bmax - bmin, 1.0)
        rel = np.clip((uv_img - bmin) / span, 0.0, 1.0)
        gy, gx = np.divmod(np.asarray([r.slot_index for r in recs], np.int64)[each], self.grid)
        ox = (gx * self.patch_size).astype(rel.dtype)
        oy = (gy * self.patch_size).astype(rel.dtype)
        px = (ox + rel[:, 0] * (self.patch_size - 1)) / self.size
        py = (oy + rel[:, 1] * (self.patch_size - 1)) / self.size
        return np.stack([px, 1.0 - py], axis=-1)

    def used_rows(self) -> int:
        """Rows of the exported PNG: down to the lowest used slot's bottom."""
        h_used = self._rows
        if self.patches:
            h_used = max(self._slot_origin(r.slot_index)[1] + self.patch_size
                         for r in self.patches.values())
        return max(min(h_used, self._rows), self.patch_size)

    # ------------------------------------------------------------- export

    def save_textured_model(self, out_dir: str, verts: np.ndarray, faces: np.ndarray,
                            atlas_uvs: np.ndarray, name: str = "model",
                            vertex_colors: Optional[np.ndarray] = None) -> str:
        """OBJ + MTL + PNG (ref: Atlas.cpp:93-179 SaveTexturedModel). The
        PNG holds only the used rows, and the OBJ's v coordinates are
        renormalized to that height. `vertex_colors` [N, 3] float 0..1
        appends per-vertex compensated colours to the `v` records (a
        widely read OBJ extension; ref: Chisel.cpp:270-284)."""
        os.makedirs(out_dir, exist_ok=True)
        h_used = self.used_rows()
        write_png(os.path.join(out_dir, f"{name}.png"), self.image[:h_used])
        if len(atlas_uvs):
            atlas_uvs = atlas_uvs.copy()
            # v was normalized against the full size: py = 1 - v in
            # [0, h_used / size] → renormalized to h_used
            atlas_uvs[:, 1] = 1.0 - (1.0 - atlas_uvs[:, 1]) * (self.size / h_used)
        with open(os.path.join(out_dir, f"{name}.mtl"), "w") as f:
            f.write(f"newmtl textured\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\nmap_Kd {name}.png\n")
        lines = [f"mtllib {name}.mtl", "usemtl textured"]
        if vertex_colors is not None:
            lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}"
                      for v, c in zip(verts.tolist(),
                                      np.clip(vertex_colors, 0.0, 1.0).tolist())]
        else:
            lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts.tolist()]
        lines += [f"vt {t[0]:.6f} {t[1]:.6f}" for t in atlas_uvs.tolist()]
        lines += [f"f {a}/{a} {b}/{b} {c}/{c}" for a, b, c in (faces + 1).tolist()]
        obj_path = os.path.join(out_dir, f"{name}.obj")
        with open(obj_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return obj_path
