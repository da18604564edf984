"""The pose-graph BA of the program, written plainly: the reference that
the program's `slam/fastba.optimize` is held to (tests/test_torch_kf_capacity.py,
chip_smoke.py `[kf-grow]`). Plain PyTorch in float64; it imports nothing of
the program or of JAX.

The energy is fastba's: over world poses T (camera to world, [K, 4, 4]),

    E(T) = sum over valid edges e = (i, j) of  sum_k w_k |T_i p_k - T_j q_k|^2,

each edge given by its pre-integrated sums (an EdgeSums-shaped set:
kf_i, kf_j, s_w = sum w, s_p = sum w p, s_q = sum w q, s_pp = sum w p p^T,
s_qq = sum w q q^T, s_pq = sum w p q^T, valid), so an edge's energy is a
closed form of the sums (`edge_energy`). The weights w_k are the Huber
weights of the registration that made the edge (`huber_sums`).

`optimize` runs `rounds` rounds. Each: the total energy; `iterations`
Gauss-Newton steps, each the exact minimiser of the energy with every
pose moved to first order, T_i <- (I + hat(w_i)) T_i + rho_i, under the
damping below; then the rollback test (a round whose energy grew past
`rollback` times its start keeps its start); then, on every round but
the last, the prune (an edge stays valid while its energy over its sum
of weights is at most 3 times the median over the valid edges; edges
between consecutive keyframes always stay). The gradient and the
Hessian of the first-order energy come from autograd; the step is
-(H + D)^-1 g with H = 1/2 the Hessian, g = 1/2 the gradient (the
normal equations J^T J, J^T r), and the update T_i <- exp(xi_i) T_i with
xi = (rho, w) through the matrix exponential.

Departures from upstream (GCSLAM/MultiViewGeometry.cpp:915-1217,
optimizeKeyFrameMapRobust and optimizeKeyFrameMap), which the program
shares:
- the normal equations are solved dense; upstream assembles them sparse
  (:1067-1088) and solves with Eigen's SimplicialLDLT (:1092-1098);
- the first active keyframe, and every inactive one, is pinned by 1e12 on
  its diagonal, and every diagonal entry is damped by `damping` plus
  1e-6 of its magnitude (Levenberg); upstream fixes the first keyframe in
  its assembly;
- a step that is singular or not finite is zero (upstream's NaN guard,
  :1101-1112, leaves the pose);
- the Huber weights are those of each edge's registration
  (MultiViewGeometry.h:245-311); upstream's robust loop re-weights
  between its rounds, the program only in its final BA (GCSLAM.h:32-39,
  which `huber_sums` computes too);
- local frames are not propagated (:1149-1156): the program composes
  them from their keyframe's pose when it reads them.

`dtype` runs the same in a lower precision (for the comparison's
tolerance: bfloat16 has to fail it); the solve and the matrix
exponential, which have no bfloat16 kernels, then run in float32 and
their results are rounded to `dtype`.
"""

from __future__ import annotations

import torch

PIN = 1e12
# the comparison's tolerance on poses, in metres and in radians: float32's
# rounding of the GN steps at a room's scale reads 2.6-4.2 um on 40-keyframe
# graphs and ~13 um at 1,024 rows; the reference in bfloat16 fails it
TOL_M, TOL_RAD = 1e-4, 1e-4


def _hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _wide(fn, *xs):
    """fn over xs, in float32 where xs are of a narrower float type."""
    dt = xs[0].dtype
    if dt in (torch.float32, torch.float64):
        return fn(*xs)
    return fn(*(x.float() for x in xs)).to(dt)


def edge_energy(rot_i, t_i, rot_j, t_j, e) -> torch.Tensor:
    """sum w |M_i p + c_i - M_j q - c_j|^2 of each edge from its sums, for
    any affine maps (M, c) of its two ends: [E]."""
    def tr(a, s, b):                     # tr(a s b^T), batched
        return torch.einsum("eab,ebc,eac->e", a, s, b)
    d = t_i - t_j
    return (tr(rot_i, e["s_pp"], rot_i) + tr(rot_j, e["s_qq"], rot_j)
            - 2.0 * tr(rot_i, e["s_pq"], rot_j)
            + 2.0 * torch.sum(d * (torch.einsum("eab,eb->ea", rot_i, e["s_p"])
                                   - torch.einsum("eab,eb->ea", rot_j, e["s_q"])), -1)
            + e["s_w"] * torch.sum(d * d, -1))


def energies(poses: torch.Tensor, e) -> torch.Tensor:
    """Each edge's energy at `poses`, 0 on invalid edges: [E]."""
    pi, pj = poses[e["kf_i"]], poses[e["kf_j"]]
    en = edge_energy(pi[:, :3, :3], pi[:, :3, 3], pj[:, :3, :3], pj[:, :3, 3], e)
    return torch.where(e["valid"], en, torch.zeros_like(en))


def _first_order_energy(xi: torch.Tensor, poses: torch.Tensor, e) -> torch.Tensor:
    """The total energy with every pose moved to first order by its
    twist xi_k = (rho, w): R <- (I + hat(w)) R, t <- (I + hat(w)) t + rho."""
    k = poses.shape[0]
    xi = xi.reshape(k, 6)
    a = torch.eye(3, dtype=poses.dtype, device=poses.device) + _hat(xi[:, 3:])
    rot = a @ poses[:, :3, :3]
    t = torch.einsum("kab,kb->ka", a, poses[:, :3, 3]) + xi[:, :3]
    en = edge_energy(rot[e["kf_i"]], t[e["kf_i"]], rot[e["kf_j"]], t[e["kf_j"]], e)
    return torch.sum(torch.where(e["valid"], en, torch.zeros_like(en)))


def normal_equations(poses: torch.Tensor, e, chunk: int = 256):
    """(J^T J [6K, 6K], J^T r [6K]) at `poses`: half the Hessian and half
    the gradient of the first-order energy at xi = 0. The energy is
    quadratic in xi, so a column of its Hessian is its gradient at a
    unit vector less its gradient at 0."""
    n = poses.shape[0] * 6

    def grad(x):
        return torch.func.grad(_first_order_energy)(x, poses, e)

    zero = torch.zeros(n, dtype=poses.dtype, device=poses.device)
    g0 = grad(zero)
    eye = torch.eye(n, dtype=poses.dtype, device=poses.device)
    cols = [torch.func.vmap(grad)(eye[c:c + chunk]) - g0 for c in range(0, n, chunk)]
    return 0.5 * torch.cat(cols).T, 0.5 * g0


def _solve(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-h^-1 b, or zeros where the solve is singular or not finite."""
    x, info = torch.linalg.solve_ex(h, b)
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, -x, torch.zeros_like(x))


def _exp(xi: torch.Tensor) -> torch.Tensor:
    """[K, 6] twists (rho, w) -> [K, 4, 4] rigid motions."""
    m = torch.zeros(xi.shape[0], 4, 4, dtype=xi.dtype, device=xi.device)
    m[:, :3, :3] = _hat(xi[:, 3:])
    m[:, :3, 3] = xi[:, :3]
    return torch.linalg.matrix_exp(m)


def prune(poses: torch.Tensor, e, factor: float = 3.0) -> torch.Tensor:
    """The `valid` mask after the prune."""
    mean = energies(poses, e) / torch.clamp(e["s_w"], min=1e-9)
    valid = e["valid"]
    med = torch.quantile(mean[valid].double(), 0.5).to(mean.dtype) if valid.any() else 1e9
    keep = valid & (mean <= factor * torch.clamp(torch.as_tensor(med, dtype=mean.dtype), min=1e-12))
    odometry = torch.abs(e["kf_i"] - e["kf_j"]) == 1
    return torch.where(odometry, valid, keep)


def huber_sums(p: torch.Tensor, q: torch.Tensor, inliers: torch.Tensor, rel: torch.Tensor,
               delta: float):
    """An edge's sums from its correspondences p [N, 3] (in keyframe i),
    q [N, 3] (in keyframe j) and inlier mask, weighted by the Huber weight
    of each residual |rel q - p| at the relative pose rel (j to i):
    (s_w, s_p, s_q, s_pp, s_qq, s_pq)."""
    r = torch.linalg.norm(q @ rel[:3, :3].T + rel[:3, 3] - p, dim=-1)
    w = inliers.to(p.dtype) * torch.where(r <= delta, torch.ones_like(r),
                                          delta / torch.clamp(r, min=1e-12))
    return (w.sum(), w @ p, w @ q, torch.einsum("n,na,nb->ab", w, p, p),
            torch.einsum("n,na,nb->ab", w, q, q), torch.einsum("n,na,nb->ab", w, p, q))


def pose_errors(a: torch.Tensor, b: torch.Tensor):
    """(largest translation difference in m, largest rotation difference
    in rad, as |R_a - R_b|_F / sqrt 2) over two pose stacks."""
    a, b = a.double(), b.double()
    dt = torch.linalg.norm(a[:, :3, 3] - b[:, :3, 3], dim=-1).max()
    dr = torch.linalg.norm(a[:, :3, :3] - b[:, :3, :3], dim=(1, 2)).max() / 2 ** 0.5
    return float(dt), float(dr)


FIELDS = ("kf_i", "kf_j", "s_w", "s_p", "s_q", "s_pp", "s_qq", "s_pq", "valid")


def optimize(poses: torch.Tensor, edges, active: torch.Tensor, *, rounds: int,
             iterations: int, damping: float, rollback: float, dtype=torch.float64):
    """BA over `poses` [K, 4, 4] and the EdgeSums-shaped `edges` (any object
    with FIELDS as attributes); rows where `active` is false stay put.
    Returns (poses, valid, energies [rounds, 2]: each round's energy at
    its start and at its end), in `dtype`."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        e = {f: getattr(edges, f) for f in FIELDS}
        e.update({f: e[f].to(dtype) for f in FIELDS[2:8]})
        e.update(kf_i=e["kf_i"].long(), kf_j=e["kf_j"].long(), valid=e["valid"].bool())
        poses = poses.to(dtype)
        k = poses.shape[0]
        first = torch.nonzero(active)[0, 0]
        pin = (torch.arange(k, device=poses.device) == first) | ~active
        pin6 = pin.repeat_interleave(6)
        out = []
        for r in range(rounds):
            start = poses
            e0 = energies(poses, e).sum()
            for _ in range(iterations):
                h, g = normal_equations(poses, e)
                d = torch.diagonal(h) + torch.where(pin6, PIN, 0.0).to(dtype)
                h = h - torch.diag(torch.diagonal(h)) + torch.diag(d + damping + 1e-6 * d.abs())
                xi = _wide(_solve, h, g).reshape(k, 6)
                xi = torch.where(active[:, None], xi, torch.zeros_like(xi))
                poses = torch.where(active[:, None, None], _wide(_exp, xi) @ poses, poses)
            e1 = energies(poses, e).sum()
            if e1 > e0 * rollback:
                poses, e1 = start, e0
            out.append(torch.stack([e0, e1]))
            if r < rounds - 1:
                e["valid"] = prune(poses, e)
        return poses, e["valid"], torch.stack(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
