"""FastBA: pose-graph Gauss-Newton over pre-integrated 3D-3D edges.

Port of texturefusion_tpu/slam/fastba.py, dense path (ref: GCSLAM/
MultiViewGeometry.cpp — ComputeJacobianInfo :720-834,
optimizeKeyFrameMapRobust :915-1207, optimizeKeyFrameMap :1209-1217;
pre-integration MultiViewGeometry.h:245-373). Each edge's
correspondences reduce once to second-moment sums, so every GN
iteration is O(edges) with closed-form 6×6 blocks.

Cost: E(T) = Σ_edges Σ_k w_k ‖T_i p_k − T_j q_k‖² over world poses T;
left-multiplicative se3 updates; the first active keyframe is pinned
with a 1e12 diagonal, as are inactive rows.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from texturefusion_torch.config import BAConfig
from texturefusion_torch.core import se3
from texturefusion_torch.slam.matching import huber_weights, solve_guarded


class EdgeSums(NamedTuple):
    """Pre-integrated per-edge statistics (all Huber-weighted)."""

    kf_i: torch.Tensor   # [E] int64 — reference keyframe index
    kf_j: torch.Tensor   # [E] int64 — source keyframe index
    s_w: torch.Tensor    # [E] Σw
    s_p: torch.Tensor    # [E, 3] Σw·p      (points in frame i)
    s_q: torch.Tensor    # [E, 3] Σw·q      (points in frame j)
    s_pp: torch.Tensor   # [E, 3, 3] Σw·ppᵀ
    s_qq: torch.Tensor   # [E, 3, 3] Σw·qqᵀ
    s_pq: torch.Tensor   # [E, 3, 3] Σw·pqᵀ
    valid: torch.Tensor  # [E] bool

    def head(self, n: int) -> "EdgeSums":
        return EdgeSums(*(a[:n] for a in self))


def preintegrate_edge(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Reduce correspondences to second-moment sums (ref: MultiViewGeometry.h:314-373).
    p, q: [..., N, 3]; w: [..., N] (zero off the inliers)."""
    return (torch.sum(w, dim=-1),
            torch.einsum("...n,...ni->...i", w, p),
            torch.einsum("...n,...ni->...i", w, q),
            torch.einsum("...n,...ni,...nj->...ij", w, p, p),
            torch.einsum("...n,...ni,...nj->...ij", w, q, q),
            torch.einsum("...n,...ni,...nj->...ij", w, p, q))


def preintegrate_from_registration(p: torch.Tensor, q: torch.Tensor,
                                   inliers: torch.Tensor, pose: torch.Tensor,
                                   huber_delta: float):
    """Huber-weighted pre-integration of a registration result
    (ref: preIntegrateWithHuberNorm MultiViewGeometry.h:245-311)."""
    x = se3.transform_points(pose, q)
    rn = torch.sqrt(torch.sum((x - p) ** 2, dim=-1))
    return preintegrate_edge(p, q, inliers * huber_weights(rn, huber_delta))


def make_edges(capacity: int, device) -> EdgeSums:
    z = lambda *s: torch.zeros((capacity,) + s, device=device)  # noqa: E731
    return EdgeSums(kf_i=torch.zeros(capacity, dtype=torch.int64, device=device),
                    kf_j=torch.zeros(capacity, dtype=torch.int64, device=device),
                    s_w=z(), s_p=z(3), s_q=z(3), s_pp=z(3, 3), s_qq=z(3, 3), s_pq=z(3, 3),
                    valid=torch.zeros(capacity, dtype=torch.bool, device=device))


def write_edges(edges: EdgeSums, e: torch.Tensor, kf_i, kf_j, sums) -> None:
    """Write edge rows `e` (index tensor) in place and mark them valid."""
    edges.kf_i[e] = torch.as_tensor(kf_i, dtype=torch.int64, device=e.device)
    edges.kf_j[e] = torch.as_tensor(kf_j, dtype=torch.int64, device=e.device)
    for dst, src in zip(edges[2:8], sums):
        dst[e] = src
    edges.valid[e] = True


def _edge_moments(edges: EdgeSums, rot_i, t_i, rot_j, t_j):
    """Σw-weighted moments of x = T_i p, y = T_j q: (m_x, m_y, s_xx, s_yy, s_xy)."""
    m_x = torch.einsum("eij,ej->ei", rot_i, edges.s_p) + edges.s_w[:, None] * t_i
    m_y = torch.einsum("eij,ej->ei", rot_j, edges.s_q) + edges.s_w[:, None] * t_j

    def outer_term(rot_a, t_a, rot_b, t_b, s_ab, s_a, s_b):
        # Σw (R_a a + t_a)(R_b b + t_b)ᵀ
        return (torch.einsum("eik,ekl,ejl->eij", rot_a, s_ab, rot_b)
                + torch.einsum("eik,ek,ej->eij", rot_a, s_a, t_b)
                + torch.einsum("ei,ejk,ek->eij", t_a, rot_b, s_b)
                + edges.s_w[:, None, None] * t_a[:, :, None] * t_b[:, None, :])

    s_xx = outer_term(rot_i, t_i, rot_i, t_i, edges.s_pp, edges.s_p, edges.s_p)
    s_yy = outer_term(rot_j, t_j, rot_j, t_j, edges.s_qq, edges.s_q, edges.s_q)
    s_xy = outer_term(rot_i, t_i, rot_j, t_j, edges.s_pq, edges.s_p, edges.s_q)
    return m_x, m_y, s_xx, s_yy, s_xy


def _endpoints(poses: torch.Tensor, edges: EdgeSums):
    pi, pj = poses[edges.kf_i], poses[edges.kf_j]
    return pi[:, :3, :3], pi[:, :3, 3], pj[:, :3, :3], pj[:, :3, 3]


def _tr(m: torch.Tensor) -> torch.Tensor:
    return m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]


def edge_errors(poses: torch.Tensor, edges: EdgeSums) -> torch.Tensor:
    """Closed-form per-edge Σw‖x−y‖² (ref: MultiViewGeometry.cpp:1219-1248)."""
    _, _, s_xx, s_yy, s_xy = _edge_moments(edges, *_endpoints(poses, edges))
    e = _tr(s_xx) + _tr(s_yy) - 2.0 * _tr(s_xy)
    return torch.where(edges.valid, e, 0.0)


def _edge_blocks(poses: torch.Tensor, edges: EdgeSums):
    """Closed-form per-edge JᵀJ blocks and JᵀR (ref: ComputeJacobianInfo
    MultiViewGeometry.cpp:720-834); J_i,k = [I −x̂_k], J_j,k = −[I −ŷ_k]."""
    m_x, m_y, s_xx, s_yy, s_xy = _edge_moments(edges, *_endpoints(poses, edges))
    e3 = torch.eye(3, dtype=poses.dtype, device=poses.device)
    sw = edges.s_w[:, None, None]

    def cross_sum(s):
        # Σw x̂_k ŷ_kᵀ = tr(s_xy)·I − s_xyᵀ
        return _tr(s)[:, None, None] * e3 - s.transpose(1, 2)

    def self_block(m, s):
        h = se3.hat(m)
        return torch.cat([torch.cat([sw * e3, -h], dim=2),
                          torch.cat([h, cross_sum(s)], dim=2)], dim=1)

    h_ii = self_block(m_x, s_xx)
    h_jj = self_block(m_y, s_yy)
    h_ij = -torch.cat([torch.cat([sw * e3, -se3.hat(m_y)], dim=2),
                       torch.cat([se3.hat(m_x), cross_sum(s_xy)], dim=2)], dim=1)

    def cross_vec(s):
        # Σw x_k × y_k from s_xy = Σw x yᵀ
        return torch.stack([s[:, 1, 2] - s[:, 2, 1], s[:, 2, 0] - s[:, 0, 2],
                            s[:, 0, 1] - s[:, 1, 0]], dim=-1)

    b_i = torch.cat([m_x - m_y, -cross_vec(s_xy)], dim=-1)
    b_j = -torch.cat([m_x - m_y, cross_vec(s_xy.transpose(1, 2))], dim=-1)
    vz = edges.valid[:, None, None]
    vb = edges.valid[:, None]
    return (torch.where(vz, h_ii, 0.0), torch.where(vz, h_jj, 0.0),
            torch.where(vz, h_ij, 0.0), torch.where(vb, b_i, 0.0), torch.where(vb, b_j, 0.0))


def assemble_dense(h_ii, h_jj, h_ij, b_i, b_j, kf_i, kf_j, n_kf: int):
    """Scatter-add per-edge blocks into the dense [6K, 6K] system."""
    k6 = n_kf * 6
    h = torch.zeros((k6, k6), dtype=h_ii.dtype, device=h_ii.device)
    b = torch.zeros((k6,), dtype=h_ii.dtype, device=h_ii.device)
    r = torch.arange(6, device=h_ii.device)

    def put(blocks, rows_kf, cols_kf):
        rows = (rows_kf[:, None, None] * 6 + r[None, :, None]).expand(blocks.shape)
        cols = (cols_kf[:, None, None] * 6 + r[None, None, :]).expand(blocks.shape)
        h.index_put_((rows, cols), blocks, accumulate=True)

    put(h_ii, kf_i, kf_i)
    put(h_jj, kf_j, kf_j)
    put(h_ij, kf_i, kf_j)
    put(h_ij.transpose(1, 2), kf_j, kf_i)
    b.index_put_((kf_i[:, None] * 6 + r[None, :],), b_i, accumulate=True)
    b.index_put_((kf_j[:, None] * 6 + r[None, :],), b_j, accumulate=True)
    return h, b


def gauss_newton_rounds(poses: torch.Tensor, edges: EdgeSums, n_kf: int,
                        active: torch.Tensor, cfg: BAConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One robust GN round with rollback when the total error grows past
    the 5% gate (ref: MultiViewGeometry.cpp:1024-1143, :1165-1205).
    Returns (poses, error before, error after)."""
    err0 = torch.sum(edge_errors(poses, edges))
    diag = torch.arange(n_kf * 6, device=poses.device)
    first_active = torch.argmax(active.to(torch.int32))
    pin = (torch.arange(n_kf, device=poses.device) == first_active) | ~active
    pin6 = torch.repeat_interleave(pin, 6)
    new_poses = poses
    for _ in range(cfg.gn_iterations_per_round):
        h, b = assemble_dense(*_edge_blocks(new_poses, edges), edges.kf_i, edges.kf_j, n_kf)
        h[diag, diag] += torch.where(pin6, 1e12, 0.0)
        h[diag, diag] += cfg.levenberg_lambda + 1e-6 * torch.abs(h[diag, diag])
        xi = solve_guarded(h, b).reshape(n_kf, 6)
        xi = torch.where(active[:, None], xi, 0.0)
        upd = se3.compose(se3.se3_exp(xi), new_poses)
        new_poses = torch.where(active[:, None, None], upd, new_poses)
    err1 = torch.sum(edge_errors(new_poses, edges))
    grew = err1 > err0 * cfg.rollback_error_growth
    return (torch.where(grew, poses, new_poses), err0, torch.where(grew, err0, err1))


def prune_mask(mean_per_pt: torch.Tensor, valid: torch.Tensor, kf_i: torch.Tensor,
               kf_j: torch.Tensor, factor: float = 3.0) -> torch.Tensor:
    """The `valid` mask after pruning: an edge stays valid while its mean
    residual is at most factor × the median over VALID edges; odometry
    edges (consecutive keyframes) are never pruned."""
    n_valid = torch.sum(valid)
    srt = torch.sort(torch.where(valid, mean_per_pt, torch.inf)).values
    last = srt.numel() - 1
    hi = torch.clamp((n_valid - 1) // 2 + (n_valid - 1) % 2, 0, last)
    lo = torch.clamp((n_valid - 1) // 2, 0, last)
    med = 0.5 * (srt[lo] + srt[hi])
    med = torch.where(n_valid > 0, med, 1e9)
    keep = valid & (mean_per_pt <= factor * torch.clamp(med, min=1e-12))
    odo = torch.abs(kf_i - kf_j) == 1
    return torch.where(odo, valid, keep)


def prune_outlier_edges(poses: torch.Tensor, edges: EdgeSums,
                        factor: float = 3.0) -> EdgeSums:
    """Disable edges whose mean residual exceeds factor × the median over
    VALID edges (ref: MultiViewGeometry.cpp:1165-1205); odometry edges
    (consecutive keyframes) are never pruned."""
    mean_per_pt = edge_errors(poses, edges) / torch.clamp(edges.s_w, min=1e-9)
    return edges._replace(valid=prune_mask(mean_per_pt, edges.valid, edges.kf_i,
                                           edges.kf_j, factor))


def reweight_edges(poses: torch.Tensor, edges: EdgeSums,
                   kp_pts: torch.Tensor,       # [K, P, 3] keypoint DB points
                   match_idx: torch.Tensor,    # [E, P] ref row per src slot
                   match_w: torch.Tensor,      # [E, P] inlier weight (0 off)
                   has_matches: torch.Tensor,  # [E] bool — raw matches kept
                   huber_delta: float) -> EdgeSums:
    """Re-pre-integrate every edge with Huber weights at the CURRENT poses
    (ref: GCSLAM.h:32-39 initGraphHuberNorm); edges without stored
    matches (virtual odometry priors) keep their sums."""
    rel = se3.compose(se3.inverse(poses[edges.kf_i]), poses[edges.kf_j])   # i ← j
    p = kp_pts[edges.kf_i[:, None], match_idx.long()]
    q = kp_pts[edges.kf_j]
    x = se3.transform_points(rel, q)
    rn = torch.sqrt(torch.sum((x - p) ** 2, dim=-1))
    sums = preintegrate_edge(p, q, match_w * huber_weights(rn, huber_delta))
    use = has_matches & edges.valid
    return edges._replace(**{
        name: torch.where(use.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
        for name, new, old in zip(EdgeSums._fields[2:8], sums, edges[2:8])})


def optimize(poses: torch.Tensor, edges: EdgeSums, n_kf: int, active: torch.Tensor,
             cfg: BAConfig):
    """Rounds of robust GN with pruning in between (ref: optimizeKeyFrameMap
    :1209-1217). Returns (poses, edges, errs [rounds, 2])."""
    errs = []
    for r in range(cfg.gn_rounds):
        poses, e0, e1 = gauss_newton_rounds(poses, edges, n_kf, active, cfg)
        errs.append(torch.stack([e0, e1]))
        if r < cfg.gn_rounds - 1:
            edges = prune_outlier_edges(poses, edges)
    return poses, edges, torch.stack(errs)
