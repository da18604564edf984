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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from texturefusion_torch.config import TextureConfig
from texturefusion_torch.io.png import write_png


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
        """Allocate (or reuse) a slot and blit the keyframe region
        (ref: Atlas.cpp:43-91). kf_rgb: [H, W, 3] uint8, or float 0..1.
        Returns None when the atlas is full (ref: Atlas.cpp:52-53)."""
        rec = self.patches.get(chunk_slot)
        if rec is None:
            if not self.free:
                self.overflowed = True
                return None
            rec = PatchRecord(self.free.pop(), kf_id, np.asarray(bbox_min), np.asarray(bbox_max))
            self.patches[chunk_slot] = rec
        rec.kf_id = kf_id
        rec.bbox_min = np.asarray(bbox_min)
        rec.bbox_max = np.asarray(bbox_max)

        x0, y0 = int(rec.bbox_min[0]), int(rec.bbox_min[1])
        x1 = max(int(rec.bbox_max[0]) + 1, x0 + 1)
        y1 = max(int(rec.bbox_max[1]) + 1, y0 + 1)
        roi = kf_rgb[y0:y1, x0:x1]
        if roi.dtype != np.uint8:
            roi = np.clip(roi * 255.0, 0, 255).astype(np.uint8)
        ox, oy = self._slot_origin(rec.slot_index)
        self._ensure_rows(oy + self.patch_size)
        self.image[oy:oy + self.patch_size, ox:ox + self.patch_size] = resize_bilinear(
            roi, self.patch_size, self.patch_size)
        return rec

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
        rec = self.patches[chunk_slot]
        span = np.maximum(rec.bbox_max - rec.bbox_min, 1.0)
        rel = np.clip((uv_img - rec.bbox_min) / span, 0.0, 1.0)
        ox, oy = self._slot_origin(rec.slot_index)
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
