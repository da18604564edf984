"""TSDF voxel update and chunk discovery on torch tensors.

Port of texturefusion_tpu/ops/tsdf.py (ref: open_chisel
ProjectionIntegrator.cpp:67-426 voxelUpdateSIMD; QuadraticTruncator.h:45-48).

`integrate_chunks` is the plain PyTorch voxel update over a gathered
[U, 512] batch of chunk rows: the CPU path, and on the card the oracle
of kernel K2 (csrc/tsdf_integrate.cu). `integrate_frame_fused` updates
the full slot rows IN PLACE: on CUDA tensors through K2, on CPU tensors
through `integrate_frame_fused_plain` (gather → integrate_chunks →
index_copy_). Semantics kept from the reference's AVX path:

  * truncation once per chunk, at the chunk origin's camera depth
  * strict-interior pixel validity (0 < u < W-1, 0 < v < H-1), the pixel
    being the projection rounded half to even (as jnp.round)
  * SDF running average with +1e-4 in the denominator
  * update band -0.03 < dist < truncation + resolution·√3
  * weight ≤ min_weight after update ⇒ voxel resets to (999, 0)
  * colour band |dist| < resolution·√3/2 + pad, ÷4 saturation rescale
  * per-chunk quality = Σ quality over colour-updated voxels, -1e11 when
    the chunk projects partially outside the image or lies behind
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from texturefusion_torch.config import TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import geometry, se3
from texturefusion_torch.ops import cuda_kernels

RESET_SDF = 999.0


@dataclasses.dataclass
class ChunkBatch:
    """Per-chunk-slot TSDF rows (U rows, or the full S+1 slot arrays)."""

    sdf: torch.Tensor          # [U, V] f32, RESET_SDF when unobserved
    weight: torch.Tensor       # [U, V] f32
    color: torch.Tensor        # [U, V, 3] f32 accumulators (byte scale 0-255)
    color_count: torch.Tensor  # [U, V] f32 observation-count accumulator

    def __iter__(self):
        return iter((self.sdf, self.weight, self.color, self.color_count))

    def rows(self, idx: torch.Tensor) -> "ChunkBatch":
        return ChunkBatch(*(a[idx] for a in self))


def make_empty_batch(u: int, v: int, device=None,
                     dtype=torch.float32) -> ChunkBatch:
    return ChunkBatch(
        sdf=torch.full((u, v), RESET_SDF, dtype=dtype, device=device),
        weight=torch.zeros((u, v), dtype=dtype, device=device),
        color=torch.zeros((u, v, 3), dtype=dtype, device=device),
        color_count=torch.zeros((u, v), dtype=dtype, device=device),
    )


def truncation_distance(z: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """|q·z² + l·z + c| · scale (ref: QuadraticTruncator.h:45-48)."""
    return torch.abs(cfg.truncation_quad * z * z + cfg.truncation_linear * z
                     + cfg.truncation_const) * cfg.truncation_scale


def pack_image(depth: torch.Tensor, rgb: torch.Tensor,
               quality_map: torch.Tensor) -> torch.Tensor:
    """[H, W, 5] f32 = depth | rgb×255 | quality: one gather per voxel."""
    return torch.cat([depth[..., None], rgb * 255.0, quality_map[..., None]],
                     dim=-1).contiguous()


def integrate_chunks(batch: ChunkBatch, origins: torch.Tensor,
                     active: torch.Tensor, depth: torch.Tensor,
                     rgb: torch.Tensor, quality_map: torch.Tensor,
                     cam_to_world: torch.Tensor, sign: float,
                     intr: cam.Intrinsics, cfg: TSDFConfig,
                     with_color: bool = True
                     ) -> Tuple[ChunkBatch, torch.Tensor, torch.Tensor]:
    """Plain voxel update of a gathered batch. origins [U, 3], active [U]
    bool, depth [H, W], rgb [H, W, 3] in 0..1, quality_map [H, W],
    cam_to_world [4, 4], sign ±1. Returns (new batch, per-chunk quality
    [U], per-chunk updated flag [U])."""
    u_chunks, v_voxels = batch.sdf.shape
    dev = batch.sdf.device
    res_diag = float(np.sqrt(3.0)) * cfg.voxel_resolution

    cent = torch.as_tensor(geometry.voxel_centroids(cfg.chunk_size,
                                                    cfg.voxel_resolution), device=dev)
    world = origins[:, None, :] + cent[None, :, :]                       # [U,V,3]
    world_to_cam = se3.inverse(cam_to_world)
    pts = se3.transform_points(world_to_cam, world.reshape(-1, 3)
                               ).reshape(u_chunks, v_voxels, 3)
    z_vox = pts[..., 2]
    uv, _ = cam.project(intr, pts)
    ur = torch.round(uv[..., 0])
    vr = torch.round(uv[..., 1])
    in_img = ((ur > 0) & (ur < intr.width - 1) & (vr > 0)
              & (vr < intr.height - 1) & (z_vox > 0))
    flat = torch.where(in_img, vr * intr.width + ur, 0.0).long()

    image = (pack_image(depth, rgb, quality_map) if with_color
             else depth[..., None]).reshape(-1, 5 if with_color else 1)
    g = image[flat]                                                      # [U,V,C]
    d = torch.where(in_img, g[..., 0], 0.0)
    surface_dist = d - z_vox

    origin_cam = se3.transform_points(world_to_cam, origins[:, None, :])[:, 0, :]
    trunc = truncation_distance(origin_cam[..., 2], cfg)                 # [U]
    depth_ok = (d > intr.near) & (d < intr.far)
    band = (surface_dist > -0.03) & (surface_dist < trunc[:, None] + res_diag)
    upd = in_img & depth_ok & band & active[:, None]

    w_in = torch.where(upd, cfg.integration_weight * sign, 0.0)
    new_w = batch.weight + w_in
    new_sdf = (batch.sdf * batch.weight + surface_dist * w_in) / (new_w + 1e-4)
    new_sdf = torch.where(upd, new_sdf, batch.sdf)
    new_w = torch.where(upd, new_w, batch.weight)
    dead = upd & (new_w <= cfg.min_weight)
    new_sdf = torch.where(dead, RESET_SDF, new_sdf)
    new_w = torch.where(dead, 0.0, new_w)

    quality = torch.zeros(u_chunks, dtype=batch.sdf.dtype, device=dev)
    new_color, new_ccnt = batch.color, batch.color_count
    if with_color:
        cupd = (in_img & depth_ok & (torch.abs(surface_dist) < res_diag * 0.5
                                     + cfg.color_band_pad) & active[:, None])
        rgb255 = torch.where(cupd[..., None], g[..., 1:4], 0.0)
        new_color = batch.color + rgb255 * sign
        new_ccnt = batch.color_count + torch.where(cupd, sign, 0.0)
        sat = (torch.amax(new_color, dim=-1) > cfg.color_saturation) & cupd & (sign > 0)
        new_color = torch.where(sat[..., None], new_color * 0.25, new_color)
        new_ccnt = torch.where(sat, new_ccnt * 0.25, new_ccnt)
        new_color = torch.where(cupd[..., None], new_color, batch.color)
        new_ccnt = torch.where(cupd, new_ccnt, batch.color_count)

        quality = torch.sum(torch.where(cupd, g[..., 4], 0.0), dim=-1)
        partial = torch.any(~in_img & active[:, None] & (z_vox > 0), dim=-1)
        behind = torch.any(z_vox <= 0, dim=-1) & active
        quality = torch.where(partial | behind, -1e11, quality)

    updated = torch.any(upd, dim=-1)
    return ChunkBatch(new_sdf, new_w, new_color, new_ccnt), quality, updated


def integrate_frame_fused_plain(batch: ChunkBatch, origins_full: torch.Tensor,
                                idx: torch.Tensor, active: torch.Tensor,
                                depth, rgb, quality_map, cam_to_world,
                                sign: float, intr: cam.Intrinsics,
                                cfg: TSDFConfig, with_color: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel K2 on any device: gather the idx rows, run
    integrate_chunks, write them back with index_copy_. Padding lanes all
    name the trash row, whose content is then undefined."""
    sub, quality, updated = integrate_chunks(
        batch.rows(idx), origins_full[idx], active, depth, rgb, quality_map,
        cam_to_world, sign, intr, cfg, with_color=with_color)
    for full, part in zip(batch, sub):
        full.index_copy_(0, idx, part)
    return quality, updated


def integrate_frame_fused(batch: ChunkBatch, origins_full: torch.Tensor,
                          idx: torch.Tensor, active: torch.Tensor,
                          depth: torch.Tensor, rgb: torch.Tensor,
                          quality_map: torch.Tensor, cam_to_world: torch.Tensor,
                          sign: float, intr: cam.Intrinsics, cfg: TSDFConfig,
                          with_color: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel update of the full slot rows [S+1, ...] IN PLACE at slots idx
    [U] (int64, trash-padded; active [U] bool marks the real lanes).
    Returns (per-chunk quality [U], updated [U]). CUDA rows launch kernel
    K2; CPU rows take integrate_frame_fused_plain."""
    if batch.sdf.is_cuda:
        image = (pack_image(depth, rgb, quality_map) if with_color else
                 torch.nn.functional.pad(depth[..., None], (0, 4)).contiguous())
        return cuda_kernels.tsdf_integrate_cuda(
            *batch, idx, active, origins_full[idx].contiguous(), image,
            se3.inverse(cam_to_world).contiguous(), sign, intr, cfg,
            with_color=with_color)
    if batch.sdf.device.type != "cpu":
        raise ValueError(f"integrate_frame_fused: unsupported device {batch.sdf.device}")
    return integrate_frame_fused_plain(batch, origins_full, idx, active, depth, rgb,
                                       quality_map, cam_to_world, sign, intr, cfg,
                                       with_color=with_color)


def candidate_chunk_coords(depth: torch.Tensor, cam_to_world: torch.Tensor,
                           intr: cam.Intrinsics, cfg: TSDFConfig,
                           stride: int = 1, n_band: int = 5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk IDs whose truncation band this depth map touches: each
    (strided) ray is walked across ±truncation at n_band depths
    (ref: ChunkManager.h:303-636). Returns ([N, 3] int32 ids, [N] valid)."""
    d = depth[::stride, ::stride]
    h, w = d.shape
    dev = depth.device
    u = (torch.arange(w, dtype=torch.float32, device=dev) * stride)[None, :].expand(h, w)
    v = (torch.arange(h, dtype=torch.float32, device=dev) * stride)[:, None].expand(h, w)
    valid = (d > intr.near) & (d < intr.far)
    trunc = truncation_distance(d, cfg) + float(np.sqrt(3.0)) * cfg.voxel_resolution
    offs = torch.linspace(-1.0, 1.0, n_band, device=dev)
    z = d[None] + offs[:, None, None] * trunc[None]                    # [B,h,w]
    pts_cam = cam.unproject(intr, u[None], v[None], z)
    pts_w = se3.transform_points(cam_to_world, pts_cam.reshape(-1, 3))
    ids = geometry.world_to_chunk(pts_w, cfg.chunk_size * cfg.voxel_resolution)
    mask = valid[None].expand(z.shape).reshape(-1)
    return ids, mask


# Chunk-ID keys pack 3×10 bits into int32, as the JAX package does, so the
# sort order (and hence slot order and max_out overflow) is the same:
# chunk coords must lie in ±512.
_KEY_BITS = 10
_KEY_OFF = 1 << (_KEY_BITS - 1)
_KEY_SENTINEL = torch.iinfo(torch.int32).max


def _decode_keys(keys: torch.Tensor) -> torch.Tensor:
    m = (1 << _KEY_BITS) - 1
    return torch.stack([((keys >> (2 * _KEY_BITS)) & m) - _KEY_OFF,
                        ((keys >> _KEY_BITS) & m) - _KEY_OFF,
                        (keys & m) - _KEY_OFF], dim=-1).to(torch.int32)


def candidate_chunks_unique(depth: torch.Tensor, cam_to_world: torch.Tensor,
                            intr: cam.Intrinsics, cfg: TSDFConfig,
                            stride: int = 1, n_band: int = 5,
                            max_out: int = 4096) -> Tuple[torch.Tensor, int]:
    """candidate_chunk_coords + dedup by sorted unique keys. Returns
    (ids [max_out, 3] int32 in ascending key order, n_unique) with
    n_unique capped at max_out; callers check n_unique == max_out for
    overflow. Rows past n_unique hold the decoded sentinel, as in JAX."""
    ids, mask = candidate_chunk_coords(depth, cam_to_world, intr, cfg,
                                       stride=stride, n_band=n_band)
    xyz = torch.clamp(ids + _KEY_OFF, 0, 2 * _KEY_OFF - 1)
    in_range = (torch.abs(ids) < _KEY_OFF).all(dim=-1)
    key = (xyz[:, 0] << (2 * _KEY_BITS)) | (xyz[:, 1] << _KEY_BITS) | xyz[:, 2]
    key = torch.where(mask & in_range, key, _KEY_SENTINEL)
    uniq = torch.unique(key, sorted=True)
    uniq = uniq[uniq != _KEY_SENTINEL][:max_out]
    n = int(uniq.numel())
    out = torch.full((max_out,), _KEY_SENTINEL, dtype=torch.int32, device=depth.device)
    out[:n] = uniq
    return _decode_keys(out), n
