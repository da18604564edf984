"""Pinhole camera model with Brown-Conrady distortion, on torch tensors.

Port of texturefusion_tpu/core/camera.py (ref:
open_chisel/camera/PinholeCamera.h:33-63, the projection math inside
voxelUpdateSIMD, open_chisel/utils/ProjectionIntegrator.cpp:67-426).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from texturefusion_torch.config import CameraConfig


class Intrinsics(NamedTuple):
    """Camera intrinsics as plain Python scalars. d0-d4 are the
    Brown-Conrady coefficients (k1, k2, p1, p2, k3) of the 13-field
    calib.txt (ref: BasicAPI.cpp:1108-1133); all zero when rectified."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float
    far: float
    d0: float = 0.0
    d1: float = 0.0
    d2: float = 0.0
    d3: float = 0.0
    d4: float = 0.0

    @classmethod
    def from_config(cls, cam: CameraConfig) -> "Intrinsics":
        return cls(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                   width=cam.width, height=cam.height,
                   near=cam.near_plane, far=cam.far_plane,
                   d0=cam.d0, d1=cam.d1, d2=cam.d2, d3=cam.d3, d4=cam.d4)

    def scaled(self, factor: float) -> "Intrinsics":
        """Intrinsics for an image resized by `factor` (pyramid levels)."""
        return self._replace(
            fx=self.fx * factor, fy=self.fy * factor,
            cx=(self.cx + 0.5) * factor - 0.5, cy=(self.cy + 0.5) * factor - 0.5,
            width=int(round(self.width * factor)), height=int(round(self.height * factor)))

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12
                   for d in (self.d0, self.d1, self.d2, self.d3, self.d4))


def project(intr: Intrinsics, pts_cam: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) [u, v] and
    depth (...,); u = fx·x/z + cx."""
    z = pts_cam[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u = intr.fx * pts_cam[..., 0] / safe_z + intr.cx
    v = intr.fy * pts_cam[..., 1] / safe_z + intr.cy
    return torch.stack([u, v], dim=-1), z


def unproject(intr: Intrinsics, u: torch.Tensor, v: torch.Tensor,
              depth: torch.Tensor) -> torch.Tensor:
    """Pixel coords + depth -> camera-frame points (..., 3)."""
    x = (u - intr.cx) / intr.fx * depth
    y = (v - intr.cy) / intr.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(intr: Intrinsics, x: torch.Tensor, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward Brown-Conrady model on normalized camera coords."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (intr.d0 + r2 * (intr.d1 + r2 * intr.d4))
    xd = x * radial + 2.0 * intr.d2 * x * y + intr.d3 * (r2 + 2.0 * x * x)
    yd = y * radial + intr.d2 * (r2 + 2.0 * y * y) + 2.0 * intr.d3 * x * y
    return xd, yd


def undistort_points(intr: Intrinsics, uv: torch.Tensor,
                     iterations: int = 8) -> torch.Tensor:
    """Undistort pixel coords (..., 2) by fixed-point iteration of the
    inverse Brown model (ref: BasicAPI.cpp:195-241). Identity when all
    coefficients are zero."""
    if not intr.has_distortion:
        return uv
    xd = (uv[..., 0] - intr.cx) / intr.fx
    yd = (uv[..., 1] - intr.cy) / intr.fy
    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (intr.d0 + r2 * (intr.d1 + r2 * intr.d4))
        dx = 2.0 * intr.d2 * x * y + intr.d3 * (r2 + 2.0 * x * x)
        dy = intr.d2 * (r2 + 2.0 * y * y) + 2.0 * intr.d3 * x * y
        safe = torch.where(torch.abs(radial) > 1e-8, radial, 1e-8)
        x = (xd - dx) / safe
        y = (yd - dy) / safe
    return torch.stack([x * intr.fx + intr.cx, y * intr.fy + intr.cy], dim=-1)


def pixel_grid(intr: Intrinsics, dtype=torch.float32, *, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) grids of pixel u (x) and v (y) coordinates."""
    v, u = torch.meshgrid(
        torch.arange(intr.height, dtype=dtype, device=device),
        torch.arange(intr.width, dtype=dtype, device=device), indexing="ij")
    return u, v


def backproject_depth_map(intr: Intrinsics, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame point map."""
    u, v = pixel_grid(intr, depth.dtype, device=depth.device)
    return unproject(intr, u, v, depth)


def in_image(intr: Intrinsics, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Validity mask for pixel coords (..., 2)."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= intr.width - 1 - margin)
            & (v >= margin) & (v <= intr.height - 1 - margin))


def bilinear_sample(image: torch.Tensor, uv: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of (H, W) or (H, W, C) at (..., 2) [u, v]
    (ref: Structure/Patch.cpp:110-170). Returns (values, in-bounds mask);
    samples outside the image are 0."""
    h, w = image.shape[0], image.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    mask = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u0c = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 2)
    v0c = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 2)
    # fractions relative to the clamped base so edge samples stay exact
    du = u - u0c.to(u.dtype)
    dv = v - v0c.to(v.dtype)
    if image.ndim == 3:
        du, dv = du[..., None], dv[..., None]

    def at(dy, dx):
        return image[v0c + dy, u0c + dx]

    top = at(0, 0) * (1 - du) + at(0, 1) * du
    bot = at(1, 0) * (1 - du) + at(1, 1) * du
    val = top * (1 - dv) + bot * dv
    keep = mask[..., None] if image.ndim == 3 else mask
    return torch.where(keep, val, 0.0), mask


def nearest_sample(image: torch.Tensor, uv: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour sample of (H, W[, C]) at (..., 2) [u, v]
    (round half to even, as jnp.round). Returns (values, in-bounds mask)."""
    h, w = image.shape[0], image.shape[1]
    u = torch.round(uv[..., 0]).to(torch.int64)
    v = torch.round(uv[..., 1]).to(torch.int64)
    mask = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    val = image[torch.clamp(v, 0, h - 1), torch.clamp(u, 0, w - 1)]
    keep = mask[..., None] if image.ndim == 3 else mask
    return torch.where(keep, val, torch.zeros((), dtype=val.dtype, device=val.device)), mask
