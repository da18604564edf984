"""TSDF raycasting: depth, normal and colour images rendered from the volume.

Port of texturefusion_tpu/ops/raycast.py (ref: open_chisel/geometry/
Raycast.cpp; the reference's OpenGL view, Shaders/draw_mesh.vert/frag):
every camera ray is sphere-traced through the trilinear TSDF, a fixed
number of steps of tensor ops on the volume's device. Neither JAX file
reaches a Pallas kernel, so these stay plain torch ops.

The sampler here counts a sample valid where all 8 voxels hold weight and
|sdf| < RESET_SDF / 2, as the JAX raycaster does; TSDFVolume.sdf_at
(fusion/chunkmap.sample_sdf_trilinear) tests sdf < RESET_SDF / 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from texturefusion_torch.config import TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion.chunkmap import SlotTable, voxel_corners
from texturefusion_torch.ops.tsdf import RESET_SDF


class RaycastResult(NamedTuple):
    depth: torch.Tensor    # [H, W] z-depth, 0 where no surface was hit
    normals: torch.Tensor  # [H, W, 3]
    color: torch.Tensor    # [H, W, 3]
    hit: torch.Tensor      # [H, W] bool


def _sample(table: SlotTable, sdf, weight, color, ccnt, pts, chunk_size: int, res: float):
    """Trilinear TSDF sample at world points (..., 3) -> (sdf, valid,
    colour or None). Colour only when `color` is given."""
    w8, slot, lin = voxel_corners(table, pts, chunk_size, res)
    s8, w8v = sdf[slot, lin], weight[slot, lin]
    ok = torch.all((w8v > 0) & (torch.abs(s8) < RESET_SDF * 0.5), dim=-1)
    val = torch.where(ok, torch.sum(w8 * s8, dim=-1), RESET_SDF)
    if color is None:
        return val, ok, None
    cnt = torch.clamp(ccnt[slot, lin], min=1e-6)
    c8 = color[slot, lin] / cnt[..., None] / 255.0
    return val, ok, torch.sum(w8[..., None] * c8, dim=-2)


def _rays(intr: cam.Intrinsics, rot: torch.Tensor):
    """Per pixel: the camera-frame ray at unit z, its length, and the unit
    world direction."""
    u, v = cam.pixel_grid(intr, device=rot.device)
    dirs_cam = cam.unproject(intr, u, v, torch.ones_like(u))
    scale = torch.linalg.vector_norm(dirs_cam, dim=-1)
    return dirs_cam, scale, (dirs_cam / scale[..., None]) @ rot.T


def raycast(sdf: torch.Tensor, weight: torch.Tensor, color: torch.Tensor,
            color_count: torch.Tensor, table: torch.Tensor, lo: torch.Tensor, trash: int,
            cam_to_world: torch.Tensor, intr: cam.Intrinsics, cfg: TSDFConfig,
            n_steps: int = 128) -> RaycastResult:
    """Sphere-trace every ray of a virtual camera through the TSDF."""
    res = cfg.voxel_resolution
    st = SlotTable(table, lo, trash)
    dirs_cam, scale, dirs_w = _rays(intr, cam_to_world[:3, :3])
    origin = cam_to_world[:3, 3]
    # the stride outside observed space stays under the truncation shell's
    # thickness, or rays leap over the surface band
    coarse = 3.0 * res
    t = torch.full(dirs_cam.shape[:-1], intr.near, dtype=torch.float32,
                   device=cam_to_world.device)
    for _ in range(n_steps):
        s, ok, _ = _sample(st, sdf, weight, None, None, origin + dirs_w * t[..., None],
                           cfg.chunk_size, res)
        t = t + torch.where(ok, torch.clamp(s, -2.0 * res, 4.0 * res), coarse)
    p = origin + dirs_w * t[..., None]
    s, ok, col = _sample(st, sdf, weight, color, color_count, p, cfg.chunk_size, res)
    hit = ok & (torch.abs(s) < 1.5 * res) & (t < intr.far * 2.0)

    # normals: central differences of the TSDF at the hit point
    grads = []
    for axis in range(3):
        e = torch.zeros(3, device=p.device)
        e[axis] = res
        sp, okp, _ = _sample(st, sdf, weight, None, None, p + e, cfg.chunk_size, res)
        sm, okm, _ = _sample(st, sdf, weight, None, None, p - e, cfg.chunk_size, res)
        grads.append(torch.where(okp & okm, sp - sm, 0.0))
    n = torch.stack(grads, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    depth = t * (dirs_cam[..., 2] / scale)          # z of the unit ray
    return RaycastResult(depth=torch.where(hit, depth, 0.0),
                         normals=torch.where(hit[..., None], n, 0.0),
                         color=torch.where(hit[..., None], col, 0.0), hit=hit)


def refine_depth_to_isosurface(sdf: torch.Tensor, weight: torch.Tensor, table: torch.Tensor,
                               lo: torch.Tensor, trash: int, depth: torch.Tensor,
                               cam_to_world: torch.Tensor, intr: cam.Intrinsics,
                               cfg: TSDFConfig, iters: int = 3) -> torch.Tensor:
    """Snap a depth map onto the fused model's isosurface: each depth
    sample moves along its ray by the local TSDF value, `iters` times
    (ref: Chisel.h:377-451 RefineFrameInVoxel; GetDistanceFromSurface
    :251-342)."""
    res = cfg.voxel_resolution
    st = SlotTable(table, lo, trash)
    _, ray_scale, dirs_w = _rays(intr, cam_to_world[:3, :3])
    origin = cam_to_world[:3, 3]
    z = depth
    for _ in range(iters):
        p = origin + dirs_w * (z * ray_scale)[..., None]
        s, ok, _ = _sample(st, sdf, weight, None, None, p, cfg.chunk_size, res)
        z = z + torch.where(ok & (torch.abs(s) < 3 * res), s, 0.0) / ray_scale
    return torch.where(depth > 0, z, 0.0)


def raycast_volume(volume, cam_to_world, intr: Optional[cam.Intrinsics] = None,
                   n_steps: int = 128) -> RaycastResult:
    """raycast over a TSDFVolume, on its device."""
    table = volume._slot_table()
    batch, _ = volume.dense_batch()
    return raycast(batch.sdf, batch.weight, batch.color, batch.color_count,
                   table.table, table.lo, table.trash,
                   torch.as_tensor(cam_to_world, dtype=torch.float32, device=volume.device),
                   intr or volume.intr, volume.cfg, n_steps=n_steps)
