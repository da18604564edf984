"""The per-frame reconstruction steps.

Port of texturefusion_tpu/models/reconstruction.py (ref: main.cpp:102-211
+ MobileFusion.cpp:274-406):

  * frame_step          — preprocess + normals + quality + TSDF
                          integration of one frame into a batch of rows;
  * track_frame_fused   — preprocessing + features + registration
                          against the last keyframe;
  * frame_step_tracked  — that, plus the keyframe-depth refinement;
  * frame_step_tracked2 — the same against the last keyframe AND the
                          previous frame: the tracked path's per-frame step;
                          FRAME_STEP_PROGRAMS runs it as one captured
                          CUDA graph on the card, as the JAX package runs
                          it as one jitted program;
  * make_multichip_step / make_multichip_full_step — the map cycle over a
                          DeviceMesh: chunk-sharded TSDF integration and one
                          edge-sharded BA Gauss-Newton round (the full step
                          adds discovery, the texture datacost column,
                          meshing across shards and MRF view selection).

On CUDA tensors the bilateral filter is kernel K1 and the voxel update
kernel K2; on CPU tensors both take their plain versions. The JAX
package derives each frame's PRNG key with fold_in(base_key, frame_idx);
here the RANSAC draws come from a torch.Generator on the frame's device,
seeded from (base seed, frame index), or are passed in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.config import BAConfig, TrackingConfig, TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import preprocess
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.parallel import ba as pba
from texturefusion_torch.parallel.ba import ShardedEdges
from texturefusion_torch.parallel.mesh import DeviceMesh
from texturefusion_torch.parallel.sharded_tsdf import ShardedRows, sharded_integrate_step
from texturefusion_torch.slam.features import Keypoints, extract_features
from texturefusion_torch.slam.matching import (lite_config, ransac_draws, register_frames,
                                               solve_guarded)
from texturefusion_torch.utils import graphs


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


def _frame_step_program(packed_or_depth, rgb, kp_ref, kp_prev, kf_depth, kf_weight, draws, *,
                        intr, tcfg, depth_scale):
    """frame_step_tracked2 with its draws a tensor argument, made outside
    the program (a packed frame and a depth plane are two programs)."""
    return frame_step_tracked2(packed_or_depth, rgb, kp_ref, kp_prev, kf_depth, kf_weight, 0, 0,
                               intr, tcfg, depth_scale, draws=draws)


# the frame step as the JAX package runs it, one jitted program per
# (intr, tcfg, depth_scale, input shapes): one captured program on the card
FRAME_STEP_PROGRAMS = graphs.program("frame_step", _frame_step_program)


class MultichipState(NamedTuple):
    batch: ShardedRows        # chunk-sharded TSDF rows (sdf, weight, color, color_count)
    origins: ShardedRows      # [S, 3] chunk-sharded
    active: ShardedRows       # [S] bool chunk-sharded
    poses: torch.Tensor       # [K, 4, 4] keyframe poses, replicated (the mesh's first device)
    edges: ShardedEdges       # edge-sharded pre-integrated pose graph


class MultichipFullState(NamedTuple):
    """State of the full multi-device map cycle: TSDF and texture datacost."""

    batch: ShardedRows        # chunk-sharded TSDF rows
    origins: ShardedRows      # [S, 3] chunk-sharded
    active: ShardedRows       # [S] bool chunk-sharded
    datacost: ShardedRows     # [S, K] chunk-sharded observation quality
    poses: torch.Tensor       # [K, 4, 4] replicated
    edges: ShardedEdges       # edge-sharded pose graph


def _ba_round(mesh: DeviceMesh, poses: torch.Tensor, edges: ShardedEdges,
              active_kf: torch.Tensor, n_kf: int, cfg: BAConfig) -> torch.Tensor:
    """One edge-sharded GN round as the JAX multichip steps run it: the
    summed system with the pin and λ on the diagonal (no Marquardt term),
    the replicated solve (zero where singular or not finite); no rollback."""
    diag = torch.arange(n_kf * 6, device=poses.device)
    for _ in range(cfg.gn_iterations_per_round):
        h, b, pin6 = pba.summed_system(mesh, poses, edges, n_kf, active_kf)
        h[diag, diag] += pin6 + cfg.levenberg_lambda
        poses = pba.apply_step(poses, solve_guarded(h, b), active_kf, n_kf)
    return poses


def make_multichip_full_step(mesh: DeviceMesh, intr: cam.Intrinsics, tsdf_cfg: TSDFConfig,
                             ba_cfg: BAConfig, n_kf: int, mesh_u: int,
                             vert_cap: int = 4096, tri_cap: int = 8192):
    """The whole map cycle over a mesh (ref: MobileFusion.cpp:274-406
    tsdfFusion): chunk discovery → chunk-sharded TSDF integration →
    marching cubes over a chunk batch, its rows gathered across shards →
    texture datacost column (ref: TexMap.cpp:63-105) → MRF view-selection
    ICM sweeps → one edge-sharded BA Gauss-Newton round.

    step(state, depth, rgb, quality, cam_to_world, kf_index, active_kf,
    mesh_slots, mrf_problem) -> (state, n_found, vcount [mesh_u], labels);
    the rows and the datacost are updated in place, the poses replaced."""
    from texturefusion_torch.ops import marching_cubes as mc_ops
    from texturefusion_torch.texture import mrf as mrf_ops
    integrate = sharded_integrate_step(mesh, intr, tsdf_cfg)

    def step(state: MultichipFullState, depth, rgb, quality, cam_to_world, kf_index: int,
             active_kf, mesh_slots, mrf_problem):
        # 1. chunk discovery (replicated compute; allocation is the host's)
        _, n_found = tsdf_ops.candidate_chunks_unique(
            depth, cam_to_world, intr, tsdf_cfg, stride=max(1, intr.width // 320),
            max_out=1024)
        # 2. chunk-sharded integration: each shard updates its rows
        chunk_q = integrate(state.batch, state.origins, state.active, depth, rgb, quality,
                            cam_to_world, 1.0)
        # 3. the datacost column of this keyframe, on each shard
        for k, part in enumerate(state.datacost.parts):
            part[0][:, int(kf_index)] = chunk_q[k::mesh.size].to(part[0].device)
        # 4. meshing a chunk batch: its rows gathered from their shards
        #    (every block neighbour is the chunk itself, as in the JAX step)
        sl = np.asarray(mesh_slots.cpu(), np.int64)
        uniq, inv = np.unique(sl, return_inverse=True)
        dev0 = mesh.devices[0]
        rows = state.batch.gather(uniq, device=dev0)
        nbr = torch.as_tensor(inv.reshape(-1), device=dev0)[:, None].expand(mesh_u, 8)
        flat = mc_ops.mesh_chunks_compact(
            *rows, nbr.contiguous(), state.origins.gather(sl, device=dev0)[0],
            torch.ones(mesh_u, dtype=torch.bool, device=dev0), tsdf_cfg.chunk_size,
            tsdf_cfg.voxel_resolution, vert_cap, tri_cap)
        # 5. MRF view-selection sweeps (ref: TexMap view_selection), replicated
        labels = mrf_ops.solve_icm(mrf_problem, 1.0, 0.5, sweeps=2)
        # 6. one edge-sharded BA round
        new_poses = _ba_round(mesh, state.poses, state.edges, active_kf, n_kf, ba_cfg)
        return state._replace(poses=new_poses), n_found, flat.vcount, labels

    return step


def make_multichip_step(mesh: DeviceMesh, intr: cam.Intrinsics, tsdf_cfg: TSDFConfig,
                        ba_cfg: BAConfig, n_kf: int):
    """Chunk-sharded TSDF integration and one edge-sharded BA round:
    step(state, depth, rgb, quality, cam_to_world, active_kf) -> state."""
    integrate = sharded_integrate_step(mesh, intr, tsdf_cfg)

    def step(state: MultichipState, depth, rgb, quality, cam_to_world,
             active_kf) -> MultichipState:
        integrate(state.batch, state.origins, state.active, depth, rgb, quality, cam_to_world,
                  1.0)
        return state._replace(poses=_ba_round(mesh, state.poses, state.edges, active_kf,
                                              n_kf, ba_cfg))

    return step
