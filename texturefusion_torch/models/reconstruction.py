"""The per-frame reconstruction steps.

Port of texturefusion_tpu/models/reconstruction.py (ref: main.cpp:102-211
+ MobileFusion.cpp:274-406):

  * frame_step          — preprocess + normals + quality + TSDF
                          integration of one frame into a batch of rows;
  * track_frame_fused   — preprocessing + features + registration
                          against the last keyframe;
  * frame_step_tracked  — that, plus the keyframe-depth refinement;
  * frame_step_tracked2 — the same against the last keyframe AND the
                          previous frame: the tracked path's per-frame step.

On CUDA tensors the bilateral filter is kernel K1 and the voxel update
kernel K2; on CPU tensors both take their plain versions. The JAX
package derives each frame's PRNG key with fold_in(base_key, frame_idx);
here the RANSAC draws come from a torch.Generator on the frame's device,
seeded from (base seed, frame index), or are passed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from texturefusion_torch.config import TrackingConfig, TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import preprocess
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.slam.features import Keypoints, extract_features
from texturefusion_torch.slam.matching import lite_config, ransac_draws, register_frames


def frame_step(depth_raw: torch.Tensor, rgb: torch.Tensor,
               batch: tsdf_ops.ChunkBatch, origins: torch.Tensor,
               active: torch.Tensor, cam_to_world: torch.Tensor,
               intr: cam.Intrinsics, cfg: TSDFConfig
               ) -> Tuple[tsdf_ops.ChunkBatch, torch.Tensor, torch.Tensor]:
    """One frame into `batch` [U, 512] rows, updated IN PLACE (the JAX
    step donates its batch). Returns (batch, per-chunk quality, normals)."""
    depth = preprocess.frame_preprocess(depth_raw, intr)
    normals = preprocess.extract_normal_map(depth, intr)
    depth = preprocess.refine_depth_with_normals(depth, normals, intr)
    quality = preprocess.observation_quality_map(rgb, depth, normals, intr)
    idx = torch.arange(origins.shape[0], device=origins.device)
    chunk_q, _ = tsdf_ops.integrate_frame_fused(
        batch, origins, idx, active, depth, rgb, quality, cam_to_world, 1.0,
        intr, cfg, with_color=True)
    return batch, chunk_q, normals


def frame_generator(base_seed: int, frame_idx: int, device) -> torch.Generator:
    """The per-frame generator: seeded from (base seed, frame index)."""
    return torch.Generator(device=device).manual_seed(
        (int(base_seed) * 1_000_003 + int(frame_idx)) % (1 << 63))


def tracked_draws(base_seed: int, frame_idx: int, tcfg: TrackingConfig, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frame_step_tracked2's Gumbel draws (vs keyframe, vs previous frame),
    made on `device` from the frame's generator."""
    gen = frame_generator(base_seed, frame_idx, device)
    k = tcfg.max_features_pad
    return ransac_draws(tcfg, k, gen), ransac_draws(lite_config(tcfg), k, gen)


def track_frame_fused(packed_or_depth: torch.Tensor, rgb, kp_ref: Keypoints,
                      draws: torch.Tensor, intr: cam.Intrinsics, tcfg: TrackingConfig,
                      depth_scale: float):
    """Preprocessing bundle + features + registration against the last
    keyframe. draws: [R, H, 4, K]. Returns (bundle, Keypoints, TwoViewResult)."""
    bundle = preprocess.preprocess_bundle(packed_or_depth, rgb, intr, depth_scale=depth_scale)
    kp = extract_features(bundle[3], bundle[0], tcfg, intr)
    return bundle, kp, register_frames(kp_ref, kp, draws, tcfg, intr)


def _fuse_if_tracked(kf_depth, kf_weight, depth_refined, res, intr):
    fused, w = preprocess.fuse_depth_into_keyframe(kf_depth, kf_weight, depth_refined,
                                                   res.pose, intr)
    return (torch.where(res.success, fused, kf_depth), torch.where(res.success, w, kf_weight))


def frame_step_tracked(packed_or_depth: torch.Tensor, rgb, kp_ref: Keypoints,
                       kf_depth: torch.Tensor, kf_weight: torch.Tensor,
                       base_seed: int, frame_idx: int, intr: cam.Intrinsics,
                       tcfg: TrackingConfig, depth_scale: float,
                       draws: Optional[torch.Tensor] = None):
    """track_frame_fused + running-weight keyframe depth refinement, kept
    only when the registration succeeded (ref: refineKeyframesSIMD
    BasicAPI.cpp:506-635). Returns (bundle, kp, res, fused_depth, fused_weight)."""
    if draws is None:
        draws = ransac_draws(tcfg, tcfg.max_features_pad,
                             frame_generator(base_seed, frame_idx, kf_depth.device))
    bundle, kp, res = track_frame_fused(packed_or_depth, rgb, kp_ref, draws, intr, tcfg,
                                        depth_scale)
    return (bundle, kp, res) + _fuse_if_tracked(kf_depth, kf_weight, bundle[0], res, intr)


def frame_step_tracked2(packed_or_depth: torch.Tensor, rgb, kp_ref: Keypoints,
                        kp_prev: Keypoints, kf_depth: torch.Tensor,
                        kf_weight: torch.Tensor, base_seed: int, frame_idx: int,
                        intr: cam.Intrinsics, tcfg: TrackingConfig, depth_scale: float,
                        draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """frame_step_tracked with TWO references: the last keyframe and the
    previous frame (the frame-to-frame fallback uses lite settings:
    a quarter of the hypotheses, no fine search).

    Returns (bundle, kp, res_kf, res_ff, stats2, fused_depth, fused_weight);
    stats2 [43] f32 = stats vs keyframe (21) ‖ stats vs previous frame
    (21) ‖ blur score (1). `draws` = (vs keyframe [R, H, 4, K], vs
    previous frame [1, H', 4, K]); by default tracked_draws on the frame's device."""
    if draws is None:
        draws = tracked_draws(base_seed, frame_idx, tcfg, kf_depth.device)
    bundle = preprocess.preprocess_bundle(packed_or_depth, rgb, intr, depth_scale=depth_scale)
    depth_refined = bundle[0]
    kp = extract_features(bundle[3], depth_refined, tcfg, intr)
    res_kf = register_frames(kp_ref, kp, draws[0], tcfg, intr)
    res_ff = register_frames(kp_prev, kp, draws[1], lite_config(tcfg), intr)
    stats2 = torch.cat([res_kf.stats, res_ff.stats, bundle[4].reshape(1)])
    fused, w = _fuse_if_tracked(kf_depth, kf_weight, depth_refined, res_kf, intr)
    return bundle, kp, res_kf, res_ff, stats2, fused, w
