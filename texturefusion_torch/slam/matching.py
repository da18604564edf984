"""Two-view RGB-D registration: matching, filtering, RANSAC, Huber GN.

Port of texturefusion_tpu/slam/matching.py (ref: GCSLAM/
MultiViewGeometry.cpp:517-718 FrameMatchingTwoViewRGB; :154-250
estimateRigid3DTransformation; :252-481 ransac3D3D; :31-152 Huber
refinement; :483-515 outlierFiltering; MultiViewGeometry.h:554-594
RefineByRotation). The estimated pose maps source-frame points into the
reference frame: p_ref ≈ T · p_src.

Random draws are explicit. `jax.random.categorical(key, logits,
shape=(H, 4))` is argmax(gumbel + logits) over the last axis, so RANSAC
takes a Gumbel tensor [H, 4, K] per round and does that argmax itself:
`register_frames` takes `gumbel` [R, H, 4, K], one slice per round
(R = 2 with the fine search, else 1). `ransac_draws` makes them from a
torch.Generator; a parity test passes the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from texturefusion_torch.config import TrackingConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import exact
from texturefusion_torch.core import se3
from texturefusion_torch.ops import cuda_kernels, hamming
from texturefusion_torch.slam.features import Keypoints


class TwoViewResult(NamedTuple):
    pose: torch.Tensor          # [4, 4] T: p_ref = T · p_src
    success: torch.Tensor       # bool
    inliers: torch.Tensor       # [K] bool over source keypoint slots
    match_idx: torch.Tensor     # [K] int32: ref keypoint index per src slot
    n_inliers: torch.Tensor     # int32
    mean_error: torch.Tensor    # mean 3D residual over inliers
    disparity: torch.Tensor     # mean 2D keypoint motion (pixels / width)
    scale_change: torch.Tensor  # relative mean-depth change
    stats: torch.Tensor         # [21] f32 [success, n_inl, err, disp, scale, pose(16)]


def n_rounds(cfg: TrackingConfig) -> int:
    return 2 if cfg.use_fine_search else 1


def lite_config(cfg: TrackingConfig) -> TrackingConfig:
    """The frame-to-frame registration's settings: a quarter of the
    hypotheses (at least 64) and no fine search."""
    return dataclasses.replace(cfg, ransac_iterations=max(cfg.ransac_iterations // 4, 64),
                               use_fine_search=False)


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1), on the
    generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def ransac_draws(cfg: TrackingConfig, k: int, generator: torch.Generator,
                 batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Gumbel draws for register_frames: [*batch, R, H, 4, k], on the
    generator's device."""
    return gumbel(tuple(batch) + (n_rounds(cfg), cfg.ransac_iterations, 4, k), generator)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid fit, batched: T with p ≈ R q + t. p, q: [..., N, 3]; w: [..., N].
    On a CUDA tensor kernel K3 (csrc/kabsch.cu, no host sync); on a CPU
    tensor kabsch_plain."""
    if p.is_cuda:
        return cuda_kernels.kabsch_cuda(p.contiguous(), q.contiguous(), w.contiguous())
    if p.device.type != "cpu":
        raise ValueError(f"kabsch: unsupported device {p.device}")
    return kabsch_plain(p, q, w)


def kabsch_plain(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K3, in float32: the centroids, the
    cross-covariance, torch.linalg.svd, the reflection fix on the last
    column and t = pc − R qc."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    pc = torch.sum(p * w[..., None], dim=-2) / wsum
    qc = torch.sum(q * w[..., None], dim=-2) / wsum
    pp = (p - pc[..., None, :]) * w[..., None]
    qq = q - qc[..., None, :]
    h = qq.transpose(-1, -2) @ pp                       # [..., 3, 3]
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    d = torch.linalg.det(v @ u.transpose(-1, -2))
    sign = torch.ones(d.shape + (3,), dtype=p.dtype, device=p.device)
    sign[..., 2] = torch.sign(d)
    r = (v * sign[..., None, :]) @ u.transpose(-1, -2)
    t = pc - (r @ qc[..., None])[..., 0]
    return se3.make_pose(r, t)


def huber_weights(residual_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber norm (ref: MultiViewGeometry.h:245-311)."""
    return torch.where(residual_norm <= delta, 1.0,
                       delta / torch.clamp(residual_norm, min=1e-12))


def solve_guarded(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """−h⁻¹b, or zeros where the solve is singular or not finite (the JAX
    code's `where(all(isfinite(dx)), dx, 0)`). No host sync."""
    x, info = torch.linalg.solve_ex(h, b)
    ok = (info == 0) & torch.isfinite(x).all(dim=-1)
    return torch.where(ok[..., None], -x, 0.0)


def refine_pose_gn(pose: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                   w: torch.Tensor, iters: int, huber_delta: float) -> torch.Tensor:
    """Huber-IRLS Gauss-Newton on 3D-3D alignment (ref: MultiViewGeometry.cpp:31-152);
    left-multiplicative update T ← exp(ξ)·T. With J_i = [I | −x̂_i] the
    normal equations reduce to moments of the weighted points:
    JᵀJ = [[Σw·I, −hat(Σwx)], [hat(Σwx), tr(S)·I − S]] with S = Σw·xxᵀ,
    and Jᵀr = [Σw·r, Σw·x×r]."""
    eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
    eye6 = torch.eye(6, dtype=p.dtype, device=p.device) * 1e-9
    for _ in range(iters):
        x = se3.transform_points(pose, q)
        r = x - p
        wr = w * huber_weights(_norm(r), huber_delta)
        wx = wr[:, None] * x
        s = wx.T @ x
        hm = se3.hat(torch.sum(wx, dim=0))
        h6 = torch.cat([torch.cat([torch.sum(wr) * eye3, -hm], 1),
                        torch.cat([hm, torch.trace(s) * eye3 - s], 1)], 0)
        b6 = torch.cat([wr @ r, torch.sum(torch.linalg.cross(wx, r, dim=-1), dim=0)])
        pose = se3.compose(se3.se3_exp(solve_guarded(h6 + eye6, b6)), pose)
    return pose


def _rotation_histogram_filter(ok: torch.Tensor, ang_src: torch.Tensor,
                               ang_ref: torch.Tensor, n_bins: int = 12,
                               n_keep: int = 3) -> torch.Tensor:
    """Keep matches whose orientation difference falls in the top-k
    histogram bins (ref: RefineByRotation MultiViewGeometry.h:554-594)."""
    two_pi = 2 * torch.pi
    delta = torch.remainder(ang_ref - ang_src + torch.pi, two_pi)
    bins = torch.clamp((exact.div(delta, two_pi) * n_bins).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=ok.device).scatter_add_(
        0, bins, ok.to(torch.int64))
    top = torch.topk(hist, n_keep).values[-1]
    good_bin = hist >= torch.clamp(top, min=1)
    return ok & good_bin[bins]


def _distance_consistency_filter(ok: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
                                 threshold: float = 0.015,
                                 min_frac: float = 0.2) -> torch.Tensor:
    """All-pairs geometric consistency (ref: outlierFiltering
    MultiViewGeometry.cpp:483-515, threshold 0.015·z): a match survives if
    ≥ min_frac of the other tentative matches preserve pairwise distance."""
    dp = _norm(p[:, None, :] - p[None, :, :])
    dq = _norm(q[:, None, :] - q[None, :, :])
    zref = torch.clamp(p[:, 2], min=1e-3)
    consistent = (torch.abs(dp - dq) / zref[:, None]) < threshold
    consistent = consistent & ok[None, :] & ok[:, None]
    frac = torch.sum(consistent, dim=1) / torch.clamp(torch.sum(ok), min=1)
    return ok & (frac >= min_frac)


def _ransac(g: torch.Tensor, p: torch.Tensor, q: torch.Tensor, ok: torch.Tensor,
            uv_ref: torch.Tensor, intr: cam.Intrinsics,
            cfg: TrackingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel 4-point Kabsch RANSAC (ref: MultiViewGeometry.cpp:154-481).
    g: [H, 4, K] Gumbel draws; each hypothesis samples 4 valid matches."""
    samples = torch.argmax(g + torch.where(ok, 0.0, -1e9), dim=-1)     # [H, 4]
    poses = kabsch(p[samples], q[samples], torch.ones(samples.shape, device=p.device))
    x = se3.transform_points(poses, q)                                 # [H, K, 3]
    err3d = _norm(x - p[None])
    uv_proj, _ = cam.project(intr, x)
    err2d = _norm(uv_proj - uv_ref[None])
    inl = ok[None] & (err3d < cfg.reproj_3d_threshold * 3.0) & (err2d < cfg.reproj_2d_threshold)
    best = torch.argmax(torch.sum(inl, dim=1))[None]     # a 0-d index would be read on the host
    return poses[best][0], inl[best][0]


def register_frames(kp_ref: Keypoints, kp_src: Keypoints, gumbel_draws: torch.Tensor,
                    cfg: TrackingConfig, intr: cam.Intrinsics) -> TwoViewResult:
    """Full two-view registration (ref: FrameMatchingTwoViewRGB
    MultiViewGeometry.cpp:517-718). gumbel_draws: [R, H, 4, K]."""

    def run_round(g, match_idx, ok):
        p = kp_ref.points3d[match_idx]
        q = kp_src.points3d
        uvr = kp_ref.uv[match_idx]
        ok = _rotation_histogram_filter(ok, kp_src.angle, kp_ref.angle[match_idx])
        for _ in range(2):
            ok = _distance_consistency_filter(ok, p, q)
        pose, inl = _ransac(g, p, q, ok, uvr, intr, cfg)
        pose = refine_pose_gn(pose, p, q, inl.to(torch.float32), cfg.gn_iterations,
                              cfg.huber_delta)
        # re-select inliers with the refined pose
        x = se3.transform_points(pose, q)
        uv_proj, _ = cam.project(intr, x)
        inl = (ok & (_norm(x - p) < cfg.reproj_3d_threshold * 3.0)
               & (_norm(uv_proj - uvr) < cfg.reproj_2d_threshold))
        pose = refine_pose_gn(pose, p, q, inl.to(torch.float32), cfg.gn_iterations,
                              cfg.huber_delta)
        return pose, inl

    # round 1: appearance-only matching
    ref_ok = kp_ref.valid & kp_ref.has_depth
    src_ok = kp_src.valid & kp_src.has_depth
    idx, _, ok = hamming.match_descriptors(kp_src.desc, src_ok, kp_ref.desc, ref_ok,
                                           cfg.hamming_threshold)
    ok = ok & kp_ref.has_depth[idx]
    pose, inl = run_round(gumbel_draws[0], idx, ok)

    # round 2: guided fine search with projected priors
    # (ref: MultiViewGeometry.cpp:608-648; sparse_match search_8_with_range)
    if cfg.use_fine_search:
        pred = se3.transform_points(se3.inverse(pose), kp_ref.points3d)
        pred_uv, _ = cam.project(intr, pred)
        idx2, _, ok2 = hamming.match_descriptors_ranged(
            kp_src.desc, src_ok, kp_src.uv, kp_ref.desc, ref_ok, pred_uv,
            cfg.hamming_threshold, radius=24.0)
        ok2 = ok2 & kp_ref.has_depth[idx2]
        use2 = torch.sum(ok2) >= torch.sum(ok)
        idx = torch.where(use2, idx2, idx)
        ok = torch.where(use2, ok2, ok)
        pose, inl = run_round(gumbel_draws[1], idx, ok)

    p = kp_ref.points3d[idx]
    q = kp_src.points3d
    err = _norm(se3.transform_points(pose, q) - p)
    n_inl = torch.sum(inl)
    denom = torch.clamp(n_inl, min=1)
    mean_err = torch.sum(torch.where(inl, err, 0.0)) / denom
    # keyframe-decision statistics (ref: GCSLAM.cpp:315-327)
    flow = _norm(kp_ref.uv[idx] - kp_src.uv)
    disparity = torch.sum(torch.where(inl, flow, 0.0)) / denom / intr.width
    z_ref = torch.sum(torch.where(inl, p[:, 2], 0.0)) / denom
    z_src = torch.sum(torch.where(inl, q[:, 2], 0.0)) / denom
    scale_change = torch.abs(z_ref - z_src) / torch.clamp(z_src, min=1e-6)
    success = ((n_inl >= cfg.min_matches) & (mean_err < cfg.reproj_3d_threshold * 5)
               & torch.isfinite(pose).all())
    stats = torch.cat([torch.stack([success.to(torch.float32), n_inl.to(torch.float32),
                                    mean_err, disparity, scale_change]), pose.reshape(-1)])
    return TwoViewResult(pose=pose, success=success, inliers=inl, match_idx=idx,
                         n_inliers=n_inl.to(torch.int32), mean_error=mean_err,
                         disparity=disparity, scale_change=scale_change, stats=stats)


def stack_results(results) -> TwoViewResult:
    return TwoViewResult(*(torch.stack(xs) for xs in zip(*results)))


def register_frames_batch(kp_refs: Keypoints, kp_src: Keypoints,
                          gumbel_draws: torch.Tensor, cfg: TrackingConfig,
                          intr: cam.Intrinsics) -> TwoViewResult:
    """Register one source frame against N stacked references (a loop over
    the reference axis). gumbel_draws: [N, R, H, 4, K]. Returns a
    TwoViewResult with leading [N] axes."""
    n = kp_refs.uv.shape[0]
    return stack_results([
        register_frames(Keypoints(*(a[i] for a in kp_refs)), kp_src, gumbel_draws[i], cfg, intr)
        for i in range(n)])


def stack_keypoints(kps) -> Keypoints:
    """Stack a list of Keypoints along a new leading axis."""
    return Keypoints(*(torch.stack(xs) for xs in zip(*kps)))
