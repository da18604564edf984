"""Distributed FastBA: pose-graph Gauss-Newton with the edges sharded.

Port of texturefusion_tpu/parallel/ba.py. Each shard reduces its edges'
closed-form 6×6 Hessian blocks into the dense system on its own device
(slam/fastba.py's `_edge_blocks` and `assemble_dense`), a psum over the
mesh combines them, and the small solve runs once and is replicated.
The pre-integrated edges make the per-edge payload O(1), so the
reduction is tiny (SURVEY.md §5). `schur_gn` partitions the keyframes
into one contiguous block per shard, eliminates each block's interior
keyframes on its shard and solves only the separator system
(BASELINE.json config 5).

Sharded edges are a list of EdgeSums, one per shard on its device: the
padded edge array cut into contiguous blocks (`shard_edges`). Poses,
`active` and the results live on the mesh's first device. What XLA's
lax.cond decides on the device (separator overflow → dense solve) is a
host decision here, made once a call from the edge layout.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from texturefusion_torch.config import BAConfig
from texturefusion_torch.core import se3
from texturefusion_torch.parallel.mesh import DeviceMesh, shard_leading
from texturefusion_torch.slam import fastba
from texturefusion_torch.slam.fastba import EdgeSums

ShardedEdges = List[EdgeSums]


def pad_edges_for_mesh(edges: EdgeSums, n_dev: int) -> EdgeSums:
    """Pad the edge arrays (zeros, valid False) so the leading dim divides
    the mesh size."""
    e = edges.s_w.shape[0]
    pad = -e % n_dev
    if pad == 0:
        return edges
    return EdgeSums(*(torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                                device=a.device)]) for a in edges))


def shard_edges(edges: EdgeSums, mesh: DeviceMesh) -> ShardedEdges:
    """The (padded) edges cut into contiguous blocks, one on each shard's device."""
    return [EdgeSums(*(a[sl].to(dev) for a in edges))
            for sl, dev in zip(shard_leading(mesh, edges.s_w.shape[0]), mesh.devices)]


def local_system(poses: torch.Tensor, edges: EdgeSums, n_kf: int):
    """One shard's dense [6K, 6K] H and [6K] b from its edges."""
    return fastba.assemble_dense(*fastba._edge_blocks(poses, edges), edges.kf_i, edges.kf_j,
                                 n_kf)


def _total_err(mesh: DeviceMesh, poses: torch.Tensor, shards: ShardedEdges) -> torch.Tensor:
    return mesh.psum([torch.sum(fastba.edge_errors(p, e))
                      for p, e in zip(mesh.replicate(poses), shards)])[0]


def summed_system(mesh: DeviceMesh, poses: torch.Tensor, shards: ShardedEdges, n_kf: int,
                  active: torch.Tensor):
    """psum of the shards' systems (H [6K, 6K], b [6K]), replicated, and
    the [6K] diagonal weight that pins the first active and every
    inactive keyframe."""
    parts = [local_system(p, e, n_kf) for p, e in zip(mesh.replicate(poses), shards)]
    h = mesh.psum([x[0] for x in parts])[0]
    b = mesh.psum([x[1] for x in parts])[0]
    first_active = torch.argmax(active.to(torch.int32))
    pin = (torch.arange(n_kf, device=h.device) == first_active) | ~active
    return h, b, torch.where(torch.repeat_interleave(pin, 6), 1e12, 0.0)


def _damped_system(mesh: DeviceMesh, poses: torch.Tensor, shards: ShardedEdges, n_kf: int,
                   active: torch.Tensor, cfg: BAConfig):
    """summed_system with the pin and the Levenberg-Marquardt damping on
    the diagonal."""
    h, b, pin6 = summed_system(mesh, poses, shards, n_kf, active)
    diag = torch.arange(n_kf * 6, device=h.device)
    h[diag, diag] += pin6
    h[diag, diag] += cfg.levenberg_lambda + 1e-6 * torch.abs(h[diag, diag])
    return h, b


def apply_step(poses: torch.Tensor, dx: torch.Tensor, active: torch.Tensor, n_kf: int):
    """exp(ξ)·T for the active keyframes, dx [6K] the GN step."""
    xi = torch.where(active[:, None], dx.reshape(n_kf, 6), 0.0)
    upd = se3.compose(se3.se3_exp(xi), poses)
    return torch.where(active[:, None, None], upd, poses)


def _rollback(mesh, poses, new_poses, shards, err0, cfg):
    err1 = _total_err(mesh, new_poses, shards)
    grew = err1 > err0 * cfg.rollback_error_growth
    return torch.where(grew, poses, new_poses), err0, torch.where(grew, err0, err1)


def distributed_gn(poses: torch.Tensor, edges: ShardedEdges, n_kf: int,
                   active: torch.Tensor, cfg: BAConfig, mesh: DeviceMesh
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-sharded Gauss-Newton round: fastba.gauss_newton_rounds with
    the edges partitioned over the mesh (pad them to a mesh multiple with
    valid False). Returns (poses, err_before, err_after)."""
    err0 = _total_err(mesh, poses, edges)
    new_poses = poses
    for _ in range(cfg.gn_iterations_per_round):
        h, b = _damped_system(mesh, new_poses, edges, n_kf, active, cfg)
        new_poses = apply_step(new_poses, fastba.solve_guarded(h, b), active, n_kf)
    return _rollback(mesh, poses, new_poses, edges, err0, cfg)


def _separators(mesh: DeviceMesh, edges: ShardedEdges, n_kf: int, blk: int) -> torch.Tensor:
    """[K] bool: keyframes with a valid edge across a block boundary (the
    per-shard scatter, then a max across the shards)."""
    parts = []
    for e in edges:
        cross = ((torch.div(e.kf_i, blk, rounding_mode="floor")
                  != torch.div(e.kf_j, blk, rounding_mode="floor")) & e.valid).to(torch.float32)
        loc = torch.zeros(n_kf, device=cross.device)
        loc.scatter_reduce_(0, e.kf_i, cross, reduce="amax")
        loc.scatter_reduce_(0, e.kf_j, cross, reduce="amax")
        parts.append(loc)
    return mesh.pmax(parts)[0] > 0


def schur_gn(poses: torch.Tensor, edges: ShardedEdges, n_kf: int,
             active: torch.Tensor, cfg: BAConfig, mesh: DeviceMesh,
             sep_budget: int = 128) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keyframe-partitioned Gauss-Newton with Schur-complement reduction.

    Keyframes split into contiguous blocks of B = n_kf / n_dev, one per
    shard (n_kf must divide: pad with inactive keyframes). A keyframe is a
    separator iff a valid edge couples it across a block boundary; each
    shard eliminates its interior keyframes,

        S = H_ss − Σ_d H_sI_d · H_I_dI_d⁻¹ · H_I_ds     (psum over d),

    the [6·n_sep] separator system is solved once and replicated, and
    each shard back-substitutes its interiors. When the separators
    outnumber `sep_budget`, every iteration takes the dense replicated
    solve, as the JAX lax.cond does. Returns (poses, err_before, err_after)."""
    n_dev = mesh.size
    if n_kf % n_dev:
        raise ValueError(f"pad n_kf ({n_kf}) to a multiple of the mesh size ({n_dev})")
    blk = n_kf // n_dev
    s_max = min(sep_budget, n_kf)
    dev0 = poses.device
    err0 = _total_err(mesh, poses, edges)

    sep = _separators(mesh, edges, n_kf, blk)
    n_sep = int(sep.sum())               # the one host read of the call
    interior = ~sep
    sep_idx = torch.nonzero(sep)[:, 0][:s_max]
    sep_idx = torch.cat([sep_idx, sep_idx.new_zeros(s_max - sep_idx.numel())])
    sep_ok = torch.arange(s_max, device=dev0) < n_sep
    r6 = torch.arange(6, device=dev0)
    sep6 = (sep_idx[:, None] * 6 + r6).reshape(-1)
    ok6 = torch.repeat_interleave(sep_ok, 6)
    mine = []                            # per shard: (my6, interior mask) on its device
    for d, dev in enumerate(mesh.devices):
        my = torch.arange(blk, device=dev0) + d * blk
        mine.append(((my[:, None] * 6 + r6).reshape(-1).to(dev),
                     torch.repeat_interleave(interior[my], 6).to(dev)))

    def schur_solve(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        eliminated = []
        g_parts, gb_parts = [], []
        for (my6, im6), h_d, b_d, sep6_d, ok6_d in zip(
                mine, mesh.replicate(h), mesh.replicate(b), mesh.replicate(sep6),
                mesh.replicate(ok6)):
            # A_d: the block's interior system, identity on its other rows
            hb = h_d[my6][:, my6]
            a_d = (torch.where(im6[:, None] & im6[None, :], hb, 0.0)
                   + torch.diag(torch.where(im6, 0.0, 1.0)))
            c_d = torch.where(im6[:, None] & ok6_d[None, :], h_d[my6][:, sep6_d], 0.0)
            b_i = torch.where(im6, b_d[my6], 0.0)
            xy, info = torch.linalg.solve_ex(a_d, torch.cat([c_d, b_i[:, None]], dim=1))
            x_d, y_d = xy[:, :-1], xy[:, -1]
            eliminated.append((x_d, y_d, info))
            g_parts.append(c_d.T @ x_d)
            gb_parts.append(c_d.T @ y_d)
        g = mesh.psum(g_parts)[0]
        g_b = mesh.psum(gb_parts)[0]
        okm = ok6[:, None] & ok6[None, :]
        s_mat = (torch.where(okm, h[sep6][:, sep6] - g, 0.0)
                 + torch.diag(torch.where(ok6, 0.0, 1.0)))
        rhs = torch.where(ok6, b[sep6] - g_b, 0.0)
        dx_s, info_s = torch.linalg.solve_ex(s_mat, rhs)
        dx_s = torch.where(ok6, -dx_s, 0.0)
        dx = torch.zeros(n_kf * 6, device=dev0).index_add_(0, sep6, dx_s)
        back, bad = [], info_s != 0
        for (my6, im6), (x_d, y_d, info), dxs_d in zip(mine, eliminated,
                                                      mesh.replicate(dx_s)):
            # interior back-substitution: dx_I = −A⁻¹(b_I + C dx_s)
            dx_i = torch.where(im6, -(y_d + x_d @ dxs_d), 0.0)
            back.append(torch.zeros(n_kf * 6, device=dx_i.device).index_add_(0, my6, dx_i))
            bad = bad | (info != 0).to(dev0)
        dx = dx + mesh.psum(back)[0]
        # a failed factorization zeroes the step, as a non-finite one does
        return torch.where(bad | ~torch.isfinite(dx).all(), 0.0, dx)

    new_poses = poses
    for _ in range(cfg.gn_iterations_per_round):
        h, b = _damped_system(mesh, new_poses, edges, n_kf, active, cfg)
        dx = schur_solve(h, b) if n_sep <= s_max else fastba.solve_guarded(h, b)
        new_poses = apply_step(new_poses, dx, active, n_kf)
    return _rollback(mesh, poses, new_poses, edges, err0, cfg)


def _prune_sharded(mesh: DeviceMesh, poses: torch.Tensor, edges: ShardedEdges
                   ) -> ShardedEdges:
    """fastba.prune_outlier_edges over ALL the shards' edges: the per-edge
    mean residuals are gathered first, so the median is the global one
    (as the JAX prune on GSPMD-sharded edges takes it)."""
    means = [fastba.edge_errors(p, e) / torch.clamp(e.s_w, min=1e-9)
             for p, e in zip(mesh.replicate(poses), edges)]

    def cat(field):
        return mesh.all_gather([getattr(e, field) for e in edges])[0]

    valid = fastba.prune_mask(mesh.all_gather(means)[0], cat("valid"), cat("kf_i"),
                              cat("kf_j"))
    sizes = [e.s_w.shape[0] for e in edges]
    return [e._replace(valid=v.to(e.valid.device))
            for e, v in zip(edges, torch.split(valid, sizes))]


def ba_rounds(poses: torch.Tensor, edges: EdgeSums, n_kf: int, active: torch.Tensor,
              cfg: BAConfig, mesh: DeviceMesh, use_schur: bool, sep_budget: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole per-keyframe BA over the mesh: pad the edges to a mesh
    multiple, shard them, then cfg.gn_rounds of distributed or Schur GN
    with the (global) outlier pruning between rounds. `edges` are the
    live ones, unpadded. Returns (poses, valid [E], errs [rounds, 2])."""
    n_e = edges.s_w.shape[0]
    shards = shard_edges(pad_edges_for_mesh(edges, mesh.size), mesh)
    errs = []
    for r in range(cfg.gn_rounds):
        if use_schur:
            poses, e0, e1 = schur_gn(poses, shards, n_kf, active, cfg, mesh, sep_budget)
        else:
            poses, e0, e1 = distributed_gn(poses, shards, n_kf, active, cfg, mesh)
        errs.append(torch.stack([e0, e1]))
        if r < cfg.gn_rounds - 1:
            shards = _prune_sharded(mesh, poses, shards)
    valid = mesh.all_gather([e.valid for e in shards])[0][:n_e]
    return poses, valid, torch.stack(errs)
