"""The analytic scene every traffic mix is rendered from, in NumPy.

A frozen copy of the box room of texturefusion_torch/io/synthetic.py
(`BoxRoomScene.sdf` and `.color`): an axis-aligned room seen from inside,
spheres in it, and a procedural albedo of hash-noise cells at two scales.
It is the ground truth the fused map and the texture are judged against,
so it imports nothing of the program. The albedo hash rounds as the
renderer of tfbench/traffic/render.py does (each fused multiply-add exact
in float64, then rounded to float32; sin in float64, rounded), so both
give the same cell colour for the same point.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class Scene:
    """A box room from a configuration's "scene" entry: room_min,
    room_max, spheres [[cx, cy, cz, r], ...] and checker_scale."""

    def __init__(self, spec: Dict):
        self.room_min = np.asarray(spec["room_min"], np.float64)
        self.room_max = np.asarray(spec["room_max"], np.float64)
        self.spheres = np.asarray(spec.get("spheres", []), np.float64).reshape(-1, 4)
        self.checker_scale = float(spec["checker_scale"])

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        """Signed distance (m) of points [..., 3], positive in free space
        (inside the room, outside the spheres)."""
        p = np.asarray(pts, np.float64)
        d = np.minimum(np.min(p - self.room_min, axis=-1), np.min(self.room_max - p, axis=-1))
        for cx, cy, cz, r in self.spheres:
            d = np.minimum(d, np.linalg.norm(p - np.asarray([cx, cy, cz]), axis=-1) - r)
        return d

    def color(self, pts: np.ndarray) -> np.ndarray:
        """Albedo [..., 3] in [0, 1] at points [..., 3] (float32 points,
        as the renderer hands them to its hash)."""
        p = np.asarray(pts, np.float32)

        def fma(a, b, c):
            return (a.astype(np.float64) * b + c.astype(np.float64)).astype(np.float32)

        def hash_noise(cells, salt):
            f32 = lambda v: float(np.float32(v))  # noqa: E731
            h = fma(cells[..., 2], f32(37.719),
                    fma(cells[..., 0], f32(12.9898),
                        (cells[..., 1] * np.float32(78.233)).astype(np.float32)))
            h = (h + np.float32(salt)).astype(np.float32)
            s = np.sin(h.astype(np.float64)).astype(np.float32) * np.float32(43758.5453)
            return np.mod(s, np.float32(1.0)).astype(np.float32)

        s = np.float32(self.checker_scale)
        coarse = np.floor(p * s)
        fine = np.floor(p * s * np.float32(3.0))
        base = np.float32(0.2) + np.float32(0.6) * hash_noise(coarse, 0.0)
        r = np.clip(base * (np.float32(0.6) + np.float32(0.6) * hash_noise(fine, 17.0)), 0, 1)
        g = np.clip(base * (np.float32(0.6) + np.float32(0.6) * hash_noise(fine, 29.0)), 0, 1)
        b = np.clip(base * (np.float32(0.6) + np.float32(0.6) * hash_noise(coarse, 43.0)), 0, 1)
        return np.stack([r, g, b], axis=-1).astype(np.float32)
