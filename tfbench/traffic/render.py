"""Noise-free RGB-D frames of the analytic scene, rendered on the device.

A frozen copy of texturefusion_torch/io/synthetic.py's sphere tracer and
of the Brown-Conrady camera of texturefusion_torch/core/camera.py,
batched over frames: each pixel's ray leaves through its undistorted
coordinates, so the frames are what a camera with that lens sees. The
scene is tfbench/reference/scene.py's, written in torch; the albedo hash
rounds as there. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MAX_DIST = 8.0
STEPS = 96
HIT = 5e-3


def _f32(v: float) -> float:
    return float(np.float32(v))


class TorchScene:
    def __init__(self, spec: Dict, device):
        self.mn = torch.tensor(spec["room_min"], dtype=torch.float32, device=device)
        self.mx = torch.tensor(spec["room_max"], dtype=torch.float32, device=device)
        self.spheres = [(torch.tensor(s[:3], dtype=torch.float32, device=device), float(s[3]))
                        for s in spec.get("spheres", [])]
        self.checker_scale = float(spec["checker_scale"])

    def sdf(self, p: torch.Tensor) -> torch.Tensor:
        d = torch.minimum(torch.amin(p - self.mn, dim=-1), torch.amin(self.mx - p, dim=-1))
        for c, r in self.spheres:
            d = torch.minimum(d, torch.linalg.vector_norm(p - c, dim=-1) - r)
        return d

    def color(self, p: torch.Tensor) -> torch.Tensor:
        def fma(a, b, c):
            return (a.double() * b + c.double()).float()

        def hash_noise(cells, salt):
            h = fma(cells[..., 2], _f32(37.719),
                    fma(cells[..., 0], _f32(12.9898), cells[..., 1] * _f32(78.233)))
            h = h + _f32(salt)
            return torch.remainder(torch.sin(h.double()).float() * _f32(43758.5453), 1.0)

        s = self.checker_scale
        coarse = torch.floor(p * s)
        fine = torch.floor(p * s * 3.0)
        base = 0.2 + 0.6 * hash_noise(coarse, 0.0)
        r = torch.clamp(base * (0.6 + 0.6 * hash_noise(fine, 17.0)), 0.0, 1.0)
        g = torch.clamp(base * (0.6 + 0.6 * hash_noise(fine, 29.0)), 0.0, 1.0)
        b = torch.clamp(base * (0.6 + 0.6 * hash_noise(coarse, 43.0)), 0.0, 1.0)
        return torch.stack([r, g, b], dim=-1)


def ray_directions(cam: Dict, device) -> torch.Tensor:
    """Unit camera-frame ray directions [H, W, 3] of a camera entry
    (fx, fy, cx, cy, width, height, d0..d4): each pixel undistorted by 8
    fixed-point iterations of the inverse Brown model."""
    h, w = int(cam["height"]), int(cam["width"])
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    k1, k2, p1, p2, k3 = (float(cam.get(f"d{i}", 0.0)) for i in range(5))
    xd = (u - cam["cx"]) / cam["fx"]
    yd = (v - cam["cy"]) / cam["fy"]
    x, y = xd, yd
    if any(abs(c) > 1e-12 for c in (k1, k2, p1, p2, k3)):
        for _ in range(8):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            safe = torch.where(torch.abs(radial) > 1e-8, radial, 1e-8)
            x = (xd - dx) / safe
            y = (yd - dy) / safe
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def render(scene_spec: Dict, cam: Dict, poses: np.ndarray, device,
           batch: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth [N, H, W] f32 metres, 0 where nothing was hit; rgb [N, H, W,
    3] f32 in [0, 1]) of camera-to-world poses [N, 4, 4], on `device`,
    `batch` frames at a time."""
    scene = TorchScene(scene_spec, device)
    dirs_cam = ray_directions(cam, device)
    depths, rgbs = [], []
    pose_t = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    for i in range(0, len(pose_t), batch):
        p = pose_t[i:i + batch]
        dirs = torch.einsum("hwj,nij->nhwi", dirs_cam, p[:, :3, :3])
        origin = p[:, None, None, :3, 3].expand(dirs.shape)
        t = torch.zeros(dirs.shape[:-1], dtype=torch.float32, device=device)
        for _ in range(STEPS):
            # negative steps backtrack after an overshoot
            t = t + torch.clamp(scene.sdf(origin + dirs * t[..., None]), -0.25, 0.5)
        pts = origin + dirs * t[..., None]
        hit = torch.abs(scene.sdf(pts)) < HIT
        t = torch.where(hit, t, MAX_DIST)
        depth = t * dirs_cam[..., 2]
        depth = torch.where(t < 7.9, depth, 0.0)
        rgb = torch.where(depth[..., None] > 0, scene.color(origin + dirs * t[..., None]), 0.0)
        depths.append(depth)
        rgbs.append(rgb)
    return torch.cat(depths), torch.cat(rgbs)
