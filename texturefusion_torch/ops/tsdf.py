"""TSDF voxel update and chunk discovery on torch tensors.

Port of texturefusion_tpu/ops/tsdf.py (ref: open_chisel
ProjectionIntegrator.cpp:67-426 voxelUpdateSIMD; QuadraticTruncator.h:45-48).

`integrate_chunks` is the plain PyTorch voxel update over a gathered
[U, 512] batch of chunk rows: the CPU path, and on the card the oracle
of kernel K2 (csrc/tsdf_integrate.cu). `integrate_frame_fused` updates
the full slot rows IN PLACE: on CUDA tensors through one launch of K2,
which takes the frame's planes, the origins table and the pose as they
are; on CPU tensors through `integrate_frame_fused_plain` (gather →
integrate_chunks → index_copy_). `reintegrate_frame_fused` (drift
reintegration: -1 at the old pose, +1 at the new) is two K2 launches on
the same rows, and `integrate_depths_batched` (a keyframe's depth-only
local frames) one launch of K2's F-frame mode; each has a `_plain`
version. `integrate_depths_scan` walks the frames one by one (one K2
launch a frame), the F-frame mode's reference. Semantics kept from the reference's AVX path:

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
from typing import Optional, Tuple

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


def make_empty_batch(u: int, v: int, device,
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


def _voxel_world(origins: torch.Tensor, cfg: TSDFConfig) -> torch.Tensor:
    """World centroids [U, V, 3] of the voxels of chunks at `origins` [U, 3]."""
    cent = torch.as_tensor(geometry.voxel_centroids(cfg.chunk_size, cfg.voxel_resolution),
                           device=origins.device)
    return origins[:, None, :] + cent[None, :, :]


def _project_voxels(world: torch.Tensor, origins: torch.Tensor, cam_to_world: torch.Tensor,
                    intr: cam.Intrinsics, cfg: TSDFConfig):
    """One frame's view of the voxels: camera depth z [U, V], the
    strict-interior mask [U, V], the flat pixel index (0 outside) [U, V]
    and the truncation at each chunk origin's camera depth [U]."""
    u_chunks, v_voxels = world.shape[:2]
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
    origin_cam = se3.transform_points(world_to_cam, origins[:, None, :])[:, 0, :]
    return z_vox, in_img, flat, truncation_distance(origin_cam[..., 2], cfg)


def integrate_chunks(batch: ChunkBatch, origins: torch.Tensor,
                     active: torch.Tensor, depth: torch.Tensor,
                     rgb: Optional[torch.Tensor], quality_map: Optional[torch.Tensor],
                     cam_to_world: torch.Tensor, sign: float,
                     intr: cam.Intrinsics, cfg: TSDFConfig,
                     with_color: bool = True
                     ) -> Tuple[ChunkBatch, torch.Tensor, torch.Tensor]:
    """Plain voxel update of a gathered batch. origins [U, 3], active [U]
    bool, depth [H, W], rgb [H, W, 3] in 0..1, quality_map [H, W] (both
    unread, and may be None, when with_color is False), cam_to_world
    [4, 4], sign ±1. Returns (new batch, per-chunk quality [U], per-chunk
    updated flag [U])."""
    u_chunks = batch.sdf.shape[0]
    dev = batch.sdf.device
    res_diag = float(np.sqrt(3.0)) * cfg.voxel_resolution

    world = _voxel_world(origins, cfg)
    z_vox, in_img, flat, trunc = _project_voxels(world, origins, cam_to_world, intr, cfg)
    image = (pack_image(depth, rgb, quality_map) if with_color
             else depth[..., None]).reshape(-1, 5 if with_color else 1)
    g = image[flat]                                                      # [U,V,C]
    d = torch.where(in_img, g[..., 0], 0.0)
    surface_dist = d - z_vox

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
                                idx: torch.Tensor, active: Optional[torch.Tensor],
                                depth, rgb, quality_map, cam_to_world,
                                sign: float, intr: cam.Intrinsics,
                                cfg: TSDFConfig, with_color: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel K2 on any device: gather the idx rows, run
    integrate_chunks, write them back with index_copy_. active None marks
    every lane. Padding lanes all name the trash row, whose content is
    then undefined."""
    if active is None:
        active = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    sub, quality, updated = integrate_chunks(
        batch.rows(idx), origins_full[idx], active, depth, rgb, quality_map,
        cam_to_world, sign, intr, cfg, with_color=with_color)
    for full, part in zip(batch, sub):
        full.index_copy_(0, idx, part)
    return quality, updated


def integrate_frame_fused(batch: ChunkBatch, origins_full: torch.Tensor,
                          idx: torch.Tensor, active: Optional[torch.Tensor],
                          depth: torch.Tensor, rgb: Optional[torch.Tensor],
                          quality_map: Optional[torch.Tensor], cam_to_world: torch.Tensor,
                          sign: float, intr: cam.Intrinsics, cfg: TSDFConfig,
                          with_color: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel update of the full slot rows [S+1, ...] IN PLACE at slots idx
    [U] (int64). active [U] bool marks the lanes to update; None marks
    all, as when idx lists the real slots only (TSDFVolume); a padded
    list names the trash row in its inactive lanes. rgb and quality_map
    may be None when with_color is False. Returns (per-chunk quality [U],
    updated [U]). CUDA rows launch kernel K2 once, and nothing else; CPU
    rows take integrate_frame_fused_plain."""
    if _check_device(batch, "integrate_frame_fused"):
        return cuda_kernels.tsdf_integrate_cuda(
            *batch, idx, active, origins_full, depth, rgb, quality_map, cam_to_world,
            sign, intr, cfg, with_color=with_color)
    return integrate_frame_fused_plain(batch, origins_full, idx, active, depth, rgb,
                                       quality_map, cam_to_world, sign, intr, cfg,
                                       with_color=with_color)


def _check_device(batch: ChunkBatch, name: str) -> bool:
    """True for CUDA rows; False for CPU rows; raises on any other device."""
    if batch.sdf.is_cuda:
        return True
    if batch.sdf.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {batch.sdf.device}")
    return False


def reintegrate_frame_fused_plain(batch: ChunkBatch, origins_full: torch.Tensor,
                                  idx: torch.Tensor, active: Optional[torch.Tensor],
                                  depth, rgb, quality_map, pose_old, pose_new,
                                  intr: cam.Intrinsics, cfg: TSDFConfig,
                                  with_color: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of reintegrate_frame_fused: one gather of the idx
    rows, the -1 update at pose_old, the +1 update at pose_new, one
    index_copy_ back. Returns the second update's (quality, updated)."""
    if active is None:
        active = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    origins = origins_full[idx]
    sub, _, _ = integrate_chunks(batch.rows(idx), origins, active, depth, rgb, quality_map,
                                 pose_old, -1.0, intr, cfg, with_color=with_color)
    sub, quality, updated = integrate_chunks(sub, origins, active, depth, rgb, quality_map,
                                             pose_new, 1.0, intr, cfg, with_color=with_color)
    for full, part in zip(batch, sub):
        full.index_copy_(0, idx, part)
    return quality, updated


def reintegrate_frame_fused(batch: ChunkBatch, origins_full: torch.Tensor,
                            idx: torch.Tensor, active: Optional[torch.Tensor],
                            depth: torch.Tensor, rgb: Optional[torch.Tensor],
                            quality_map: Optional[torch.Tensor], pose_old: torch.Tensor,
                            pose_new: torch.Tensor, intr: cam.Intrinsics, cfg: TSDFConfig,
                            with_color: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """De-integrate at pose_old, then re-integrate at pose_new, on the
    same rows IN PLACE (ref: ReIntegrateKeyframe MobileFusion.cpp:114-221
    runs both passes back to back over the recorded chunk set). Returns
    the re-integration's per-chunk (quality [U], updated [U]); the
    de-integration's observations are retracted by the caller. CUDA rows
    launch K2 twice on the same slots, which computes what one gather and
    two sequential updates compute; CPU rows take the plain version."""
    if _check_device(batch, "reintegrate_frame_fused"):
        cuda_kernels.tsdf_integrate_cuda(*batch, idx, active, origins_full, depth, rgb,
                                         quality_map, pose_old, -1.0, intr, cfg,
                                         with_color=with_color)
        return cuda_kernels.tsdf_integrate_cuda(*batch, idx, active, origins_full, depth, rgb,
                                                quality_map, pose_new, 1.0, intr, cfg,
                                                with_color=with_color)
    return reintegrate_frame_fused_plain(batch, origins_full, idx, active, depth, rgb,
                                         quality_map, pose_old, pose_new, intr, cfg,
                                         with_color=with_color)


def integrate_depths_scan(batch: ChunkBatch, origins_full: torch.Tensor,
                          idx: torch.Tensor, active: Optional[torch.Tensor],
                          depths: torch.Tensor, cam_to_worlds: torch.Tensor, sign: float,
                          intr: cam.Intrinsics, cfg: TSDFConfig) -> None:
    """Depth-only integration of F frames (depths [F, H, W], cam_to_worlds
    [F, 4, 4]) into the idx rows IN PLACE, one frame after another, as
    the reference integrates a keyframe's local frames
    (ref: MobileFusion.cpp:187-203): each frame is a depth-only voxel
    update (K2 on CUDA rows, integrate_frame_fused_plain on CPU rows), so
    the weight reset applies between frames. The reference against which
    integrate_depths_batched's one-pass sum is measured."""
    for depth, pose in zip(depths, cam_to_worlds):
        integrate_frame_fused(batch, origins_full, idx, active, depth, None, None, pose,
                              float(sign), intr, cfg, with_color=False)


def frame_signs(signs, n_frames: int) -> Tuple[float, ...]:
    """A scalar sign, or one per frame, as a tuple of n_frames floats."""
    if np.ndim(signs) == 0:
        return (float(signs),) * n_frames
    out = tuple(float(s) for s in np.asarray(signs, np.float64).reshape(-1))
    if len(out) != n_frames:
        raise ValueError(f"{len(out)} signs for {n_frames} frames")
    return out


def integrate_depths_batched_plain(batch: ChunkBatch, origins_full: torch.Tensor,
                                   idx: torch.Tensor, active: Optional[torch.Tensor],
                                   depths: torch.Tensor, cam_to_worlds: torch.Tensor,
                                   signs, intr: cam.Intrinsics, cfg: TSDFConfig) -> None:
    """Plain version of the F-frame mode of K2, IN PLACE on the idx rows'
    sdf and weight. Per voxel, each frame f (in order) adds a_f = w·s_f
    and a_f·dist_f where it updates (the band test of integrate_chunks);
    then one read-modify-write: where ANY frame updated the voxel,
    w' = w + Σa, sdf' = (sdf·w + Σa·dist) / (w' + 1e-4), and w' ≤
    min_weight resets the voxel to (999, 0). Colour rows are untouched."""
    if active is None:
        active = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    n_frames = depths.shape[0]
    signs = frame_signs(signs, n_frames)
    res_diag = float(np.sqrt(3.0)) * cfg.voxel_resolution
    origins = origins_full[idx]
    world = _voxel_world(origins, cfg)
    sdf, weight = batch.sdf[idx], batch.weight[idx]
    a = torch.zeros_like(sdf)
    ad = torch.zeros_like(sdf)
    touched = torch.zeros(sdf.shape, dtype=torch.bool, device=sdf.device)
    for f in range(n_frames):
        z_vox, in_img, flat, trunc = _project_voxels(world, origins, cam_to_worlds[f],
                                                     intr, cfg)
        d = torch.where(in_img, depths[f].reshape(-1)[flat], 0.0)
        surface_dist = d - z_vox
        upd = (in_img & (d > intr.near) & (d < intr.far) & (surface_dist > -0.03)
               & (surface_dist < trunc[:, None] + res_diag) & active[:, None])
        a_f = torch.where(upd, cfg.integration_weight * signs[f], 0.0)
        a = a + a_f
        ad = ad + a_f * surface_dist
        touched = touched | upd
    new_w = weight + a
    new_sdf = (sdf * weight + ad) / (new_w + 1e-4)
    new_sdf = torch.where(touched, new_sdf, sdf)
    new_w = torch.where(touched, new_w, weight)
    dead = touched & (new_w <= cfg.min_weight)
    batch.sdf.index_copy_(0, idx, torch.where(dead, RESET_SDF, new_sdf))
    batch.weight.index_copy_(0, idx, torch.where(dead, 0.0, new_w))


def integrate_depths_batched(batch: ChunkBatch, origins_full: torch.Tensor,
                             idx: torch.Tensor, active: Optional[torch.Tensor],
                             depths: torch.Tensor, cam_to_worlds: torch.Tensor,
                             signs, intr: cam.Intrinsics, cfg: TSDFConfig) -> None:
    """Depth-only integration of F frames (depths [F, H, W], cam_to_worlds
    [F, 4, 4]) into the idx rows IN PLACE, in one pass over the rows:
    the running average commutes, s = (s0·w0 + Σ a_f·d_f) / (w0 + Σ a_f),
    so each voxel sums its frames' terms and is written once (ref:
    MobileFusion.cpp:187-203 integrates a keyframe's local frames one by
    one). `signs` is a scalar or one per frame (drift reintegration
    stacks the old-pose frames at -1 and the new-pose frames at +1). A
    voxel counts as updated where any frame updated it, so frames whose
    weights cancel still move its sdf; the weight reset (w ≤ min_weight)
    applies once, after all frames. CUDA rows launch the F-frame mode of
    K2 once, and nothing else; CPU rows take the plain version."""
    if _check_device(batch, "integrate_depths_batched"):
        cuda_kernels.tsdf_integrate_frames_cuda(
            batch.sdf, batch.weight, idx, active, origins_full, depths, cam_to_worlds,
            frame_signs(signs, depths.shape[0]), intr, cfg)
        return
    integrate_depths_batched_plain(batch, origins_full, idx, active, depths, cam_to_worlds,
                                   signs, intr, cfg)


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
