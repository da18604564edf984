"""Synthetic RGB-D scenes with known poses, rendered with torch.

Port of texturefusion_tpu/io/synthetic.py: an axis-aligned box room with
spheres, sphere-traced on any device, plus the orbit and 360° loop
camera trajectories (numpy). It lets the port make its own frames on a
machine without jax.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from texturefusion_torch.core import camera as cam


@dataclasses.dataclass(frozen=True)
class BoxRoomScene:
    """A room interior: the camera is inside an axis-aligned box looking
    at textured walls; spheres add curved geometry."""

    room_min: Tuple[float, float, float] = (-2.0, -1.5, -2.0)
    room_max: Tuple[float, float, float] = (2.0, 1.5, 2.0)
    spheres: Tuple[Tuple[float, float, float, float], ...] = (
        (0.6, 0.3, 0.8, 0.4),   # (cx, cy, cz, radius)
        (-0.8, 0.5, -0.5, 0.3),
    )
    checker_scale: float = 4.0

    def sdf(self, pts: torch.Tensor) -> torch.Tensor:
        """Analytic signed distance, negative inside solid matter (outside
        the room box, inside the spheres)."""
        mn = torch.tensor(self.room_min, dtype=pts.dtype, device=pts.device)
        mx = torch.tensor(self.room_max, dtype=pts.dtype, device=pts.device)
        d = torch.minimum(torch.amin(pts - mn, dim=-1), torch.amin(mx - pts, dim=-1))
        for (cx, cy, cz, r) in self.spheres:
            c = torch.tensor([cx, cy, cz], dtype=pts.dtype, device=pts.device)
            d = torch.minimum(d, torch.linalg.vector_norm(pts - c, dim=-1) - r)
        return d

    def color(self, pts: torch.Tensor) -> torch.Tensor:
        """Procedural albedo (..., 3) in [0, 1]: hash-noise cells at two
        scales.

        The hash amplifies one ulp of its argument h (~2e-4 at |h| ~ 4000)
        into a different cell colour, so h is rounded as the JAX package's
        compiled renderer rounds it: XLA contracts the sum into
        fma(c2, 37.719, fma(c0, 12.9898, c1 · 78.233)) + salt. Each fused
        multiply-add is exact in float64 (a float32 product fits) and is
        rounded once to float32; sin is taken in float64 and rounded, so
        the CPU and the GPU render the same texture."""
        def fma(a, b, c):
            return (a.double() * b + c.double()).float()

        def hash_noise(cells: torch.Tensor, salt: float) -> torch.Tensor:
            f32 = lambda v: float(np.float32(v))  # noqa: E731
            h = fma(cells[..., 2], f32(37.719),
                    fma(cells[..., 0], f32(12.9898), cells[..., 1] * f32(78.233))) + salt
            return torch.remainder(torch.sin(h.double()).float() * 43758.5453, 1.0)

        s = self.checker_scale
        coarse = torch.floor(pts * s)
        fine = torch.floor(pts * s * 3.0)
        base = 0.2 + 0.6 * hash_noise(coarse, 0.0)
        r = torch.clamp(base * (0.6 + 0.6 * hash_noise(fine, 17.0)), 0.0, 1.0)
        g = torch.clamp(base * (0.6 + 0.6 * hash_noise(fine, 29.0)), 0.0, 1.0)
        b = torch.clamp(base * (0.6 + 0.6 * hash_noise(coarse, 43.0)), 0.0, 1.0)
        return torch.stack([r, g, b], dim=-1)


def _raymarch(scene: BoxRoomScene, origins: torch.Tensor, dirs: torch.Tensor,
              max_dist: float = 8.0, n_steps: int = 96) -> torch.Tensor:
    """Sphere-trace the scene SDF; hit distance, or max_dist if no hit."""
    t = torch.zeros(origins.shape[:-1], dtype=origins.dtype, device=origins.device)
    for _ in range(n_steps):
        # negative steps backtrack after an overshoot
        t = t + torch.clamp(scene.sdf(origins + dirs * t[..., None]), -0.25, 0.5)
    hit = torch.abs(scene.sdf(origins + dirs * t[..., None])) < 5e-3
    return torch.where(hit, t, max_dist)


def render_frame(scene: BoxRoomScene, intr: cam.Intrinsics,
                 pose_c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render noise-free (depth [H, W] metres, rgb [H, W, 3] in [0, 1])
    from a camera-to-world pose, on the pose's device. Depth is z-depth;
    0 is invalid. With distortion, each pixel's ray comes from its
    undistorted coordinates. Callers add sensor noise themselves (from a
    numpy generator, as bench.py does)."""
    u, v = cam.pixel_grid(intr, device=pose_c2w.device)
    if intr.has_distortion:
        uv_u = cam.undistort_points(intr, torch.stack([u, v], dim=-1))
        rays_cam = cam.unproject(intr, uv_u[..., 0], uv_u[..., 1], torch.ones_like(u))
    else:
        rays_cam = cam.unproject(intr, u, v, torch.ones_like(u))
    dirs_cam = rays_cam / torch.linalg.vector_norm(rays_cam, dim=-1, keepdim=True)
    dirs_w = dirs_cam @ pose_c2w[:3, :3].T
    origin = pose_c2w[:3, 3].expand(dirs_w.shape)
    t = _raymarch(scene, origin, dirs_w)
    pts_w = origin + dirs_w * t[..., None]
    depth = t * dirs_cam[..., 2]
    depth = torch.where(t < 7.9, depth, 0.0)
    rgb = torch.where(depth[..., None] > 0, scene.color(pts_w), 0.0)
    return depth, rgb


def render_sequence(scene: BoxRoomScene, intr: cam.Intrinsics,
                    poses: List[np.ndarray], device="cuda"):
    """Render a sequence on `device`; returns numpy (depths [N, H, W],
    rgbs [N, H, W, 3])."""
    depths, rgbs = [], []
    for p in poses:
        d, c = render_frame(scene, intr, torch.as_tensor(p, dtype=torch.float32,
                                                         device=device))
        depths.append(d.cpu().numpy())
        rgbs.append(c.cpu().numpy())
    return np.stack(depths), np.stack(rgbs)


def orbit_trajectory(n_frames: int, radius: float = 0.8,
                     center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                     angle_range: float = 1.2) -> List[np.ndarray]:
    """Camera-to-world poses orbiting inside the room, looking toward the
    +z wall."""
    poses = []
    look_at = np.asarray([0.0, 0.0, 1.8])
    for i in range(n_frames):
        a = (i / max(n_frames - 1, 1) - 0.5) * angle_range
        eye = np.asarray(center) + np.asarray(
            [radius * np.sin(a), 0.1 * np.sin(2 * a), -0.2 + 0.1 * np.cos(a)])
        z_axis = look_at - eye
        z_axis = z_axis / np.linalg.norm(z_axis)
        up = np.asarray([0.0, -1.0, 0.0])  # camera y points down
        x_axis = np.cross(up, z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([x_axis, y_axis, z_axis], axis=-1)
        pose[:3, 3] = eye
        poses.append(pose)
    return poses


def loop_trajectory(n_frames: int, radius: float = 1.6,
                    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                    revolutions: float = 1.05) -> List[np.ndarray]:
    """A closed 360° loop: the camera rides a circle looking radially
    outward at the walls."""
    poses = []
    up_hint = np.asarray([0.0, -1.0, 0.0])
    for i in range(n_frames):
        a = 2.0 * np.pi * revolutions * i / max(n_frames - 1, 1)
        eye = np.asarray(center) + np.asarray(
            [radius * np.sin(a), 0.05 * np.sin(3 * a), radius * np.cos(a)])
        z_axis = np.asarray([np.sin(a), 0.0, np.cos(a)])
        z_axis = z_axis / np.linalg.norm(z_axis)
        x_axis = np.cross(up_hint, z_axis)
        x_axis = x_axis / np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = x_axis
        pose[:3, 1] = y_axis
        pose[:3, 2] = z_axis
        pose[:3, 3] = eye
        poses.append(pose)
    return poses
