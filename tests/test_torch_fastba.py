"""FastBA (dense path), port against JAX on a random pose graph.

Six keyframes on an arc, 120 landmarks, odometry edges plus a loop edge,
noisy initial poses. Tolerances (float32 on both sides, solves of a
system pinned with 1e12): edge sums and errors rtol 1e-4; the assembled
system within 1e-3 relative to its largest entry; optimized poses within
1e-4 of JAX on the active rows; pruning masks and reweighted sums
(rtol 1e-4) on the valid rows. BA at GCSLAM's buckets (32 pose rows, 128
edge rows, the floors of BAConfig) keeps the padded rows and edges as
they were and agrees, at the same tolerances, with BA at the true counts
and with the JAX package's BA at the same buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import BAConfig
from texturefusion_tpu.core import se3 as jse3
from texturefusion_tpu.slam import fastba as jba
from texturefusion_torch.slam import fastba as tba
from texturefusion_torch.utils.convert import edges_from_numpy, poses_from_numpy

torch.set_num_threads(2)

N_KF, N_TOTAL, CAP = 6, 8, 16


def _graph(noise=0.05, seed=0, n_pts=120):
    rng = np.random.default_rng(seed)
    gt = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(
        [0.4 * k, 0.02 * k, 0.01 * k * k, 0.0, 0.05 * k, 0.0], jnp.float32)))
        for k in range(N_KF)])
    pts = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pairs = [(k, k + 1) for k in range(N_KF - 1)] + [(0, N_KF - 1), (1, 4)]
    sums = []
    for i, j in pairs:
        ti, tj = np.linalg.inv(gt[i]), np.linalg.inv(gt[j])
        p = (pts @ ti[:3, :3].T + ti[:3, 3]).astype(np.float32)
        q = (pts @ tj[:3, :3].T + tj[:3, 3] + rng.normal(0, 0.002, pts.shape)).astype(np.float32)
        w = rng.uniform(0.5, 1.0, n_pts).astype(np.float32)
        sums.append([np.asarray(s) for s in jba.preintegrate_edge(jnp.asarray(p), jnp.asarray(q),
                                                                 jnp.asarray(w))])
    n_e = len(pairs)
    fields = [np.zeros((CAP,) + a.shape, np.float32) for a in sums[0]]
    for e, s in enumerate(sums):
        for f, v in zip(fields, s):
            f[e] = v
    edges = jba.EdgeSums(
        jnp.asarray(np.pad([p[0] for p in pairs], (0, CAP - n_e)), jnp.int32),
        jnp.asarray(np.pad([p[1] for p in pairs], (0, CAP - n_e)), jnp.int32),
        *[jnp.asarray(f) for f in fields], jnp.asarray(np.arange(CAP) < n_e))
    poses = np.tile(np.eye(4, dtype=np.float32), (N_TOTAL, 1, 1))
    poses[:N_KF] = gt
    for k in range(1, N_KF):
        xi = np.concatenate([rng.normal(0, noise, 3), rng.normal(0, noise / 2, 3)])
        poses[k] = gt[k] @ np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))
    return poses, edges, np.arange(N_TOTAL) < N_KF, gt


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _both(poses, edges, active):
    return ((jnp.asarray(poses), edges, jnp.asarray(active)),
            (poses_from_numpy(poses, "cpu"), edges_from_numpy(edges, "cpu"), torch.as_tensor(active)))


def test_preintegrate_from_registration_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.normal(0, 1, (64, 3)).astype(np.float32)
    q = (p + rng.normal(0, 0.01, p.shape)).astype(np.float32)
    inl = (rng.random(64) < 0.8).astype(np.float32)
    pose = np.array(jse3.se3_exp(jnp.asarray([0.01, 0.0, -0.02, 0.0, 0.01, 0.0], jnp.float32)))
    want = jba.preintegrate_from_registration(jnp.asarray(p), jnp.asarray(q), jnp.asarray(inl),
                                              jnp.asarray(pose), jnp.float32(0.008))
    got = tba.preintegrate_from_registration(torch.as_tensor(p), torch.as_tensor(q),
                                             torch.as_tensor(inl), torch.as_tensor(pose), 0.008)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_edge_errors_and_system_match_jax(graph):
    poses, edges, active, _ = graph
    (jp, je, _), (tp, te, _) = _both(poses, edges, active)
    np.testing.assert_allclose(tba.edge_errors(tp, te).numpy(),
                               np.asarray(jba.edge_errors(jp, je)), rtol=1e-4, atol=1e-3)
    jh, jb = jba.assemble_dense(*jba._edge_blocks(jp, je), je.kf_i, je.kf_j, N_TOTAL)
    th, tb = tba.assemble_dense(*tba._edge_blocks(tp, te), te.kf_i, te.kf_j, N_TOTAL)
    jh, jb = np.asarray(jh), np.asarray(jb)
    np.testing.assert_allclose(th.numpy(), jh, atol=1e-3 * np.abs(jh).max(), rtol=0)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-3 * np.abs(jb).max(), rtol=0)


@pytest.mark.parametrize("noise,seed,rounds,iters", [(0.05, 0, 3, 5), (0.3, 3, 1, 2)])
def test_optimize_matches_jax(noise, seed, rounds, iters):
    poses, edges, active, gt = _graph(noise, seed)
    cfg = BAConfig(gn_rounds=rounds, gn_iterations_per_round=iters)
    (jp, je, ja), (tp, te, ta) = _both(poses, edges, active)
    jout, jedges, jerrs = jba.optimize(jp, je, N_TOTAL, ja, cfg)
    tout, tedges, terrs = tba.optimize(tp, te, N_TOTAL, ta, cfg)
    np.testing.assert_allclose(tout.numpy()[:N_KF], np.asarray(jout)[:N_KF], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tout.numpy()[N_KF:], poses[N_KF:])
    np.testing.assert_array_equal(tedges.valid.numpy(), np.asarray(jedges.valid))
    np.testing.assert_allclose(terrs.numpy(), np.asarray(jerrs), rtol=1e-3, atol=1e-3)
    e0, e1 = terrs.numpy()[-1]
    assert e1 <= e0 * cfg.rollback_error_growth + 1e-6
    if noise < 0.1:
        for k in range(N_KF):
            np.testing.assert_allclose(tout.numpy()[k], gt[k], atol=2e-3)


@pytest.mark.parametrize("rounds,corrupt", [(1, False), (3, True)])
def test_optimize_matches_one_device_schur_ba(rounds, corrupt):
    """The port's dense optimize against the JAX package's BA past
    schur_min_keyframes: ba_rounds on a 1-device mesh with use_schur, as
    its GCSLAM runs it, on test_parallel's 32-keyframe chain with three
    loop edges, 4 iterations a round. Three rounds prune between rounds:
    the first loop edge is corrupted so that an outlier is pruned and the
    errors stay above the float32 noise floor, where pruning would decide
    on noise. Tolerances of test_parallel.py::test_schur_gn_matches_dense:
    the first error rtol 1e-4, every later one within 3e-5 of the first;
    poses rtol 2e-3, atol 2e-4; then the same edge mask."""
    from test_parallel import _make_chain_graph
    from texturefusion_tpu.parallel import ba as pba
    from texturefusion_tpu.parallel.mesh import make_mesh
    poses, edges, active, _, n_kf = _make_chain_graph()
    if corrupt:
        s_pq = np.asarray(edges.s_pq).copy()
        s_pq[n_kf - 1] -= 50.0 * np.eye(3, dtype=np.float32)
        edges = edges._replace(s_pq=jnp.asarray(s_pq))
    cfg = BAConfig(gn_rounds=rounds, gn_iterations_per_round=4)
    e_bucket = int(edges.s_w.shape[0])
    jout, jvalid, jerrs = pba.ba_rounds(poses, edges, n_kf, active, cfg, make_mesh(1),
                                        e_bucket, True, cfg.schur_separator_budget)
    _, (tp, te, ta) = _both(np.asarray(poses), edges, np.asarray(active))
    tout, tedges, terrs = tba.optimize(tp, te, n_kf, ta, cfg)
    jerrs, terrs = np.asarray(jerrs), terrs.numpy()
    assert terrs.shape == jerrs.shape == (rounds, 2)
    np.testing.assert_allclose(terrs[0, 0], jerrs[0, 0], rtol=1e-4)
    assert (np.abs(terrs - jerrs).reshape(-1)[1:] < 3e-5 * jerrs[0, 0]).all()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(tedges.valid.numpy(), np.asarray(jvalid))
    if corrupt:
        assert not tedges.valid[n_kf - 1] and tedges.valid[:n_kf - 1].all()   # odometry kept


def test_prune_outlier_edges_matches_jax(graph):
    poses, edges, active, _ = graph
    s_pq = np.asarray(edges.s_pq).copy()
    s_pq[5] -= 50.0 * np.eye(3, dtype=np.float32)   # corrupt the loop edge (0, 5): error grows
    bad = edges._replace(s_pq=jnp.asarray(s_pq))
    masks = []
    for e in (bad, bad._replace(valid=jnp.zeros_like(bad.valid))):
        (jp, je, _), (tp, te, _) = _both(poses, e, active)
        want = np.asarray(jba.prune_outlier_edges(jp, je).valid)
        got = tba.prune_outlier_edges(tp, te).valid.numpy()
        np.testing.assert_array_equal(got, want)
        masks.append(got)
    assert not masks[0][5] and masks[0][:5].all()   # outlier pruned, odometry kept
    assert not masks[1].any()


def test_reweight_edges_matches_jax(graph):
    poses, edges, active, _ = graph
    rng = np.random.default_rng(9)
    p = 32
    kp_pts = rng.normal(0, 1, (N_TOTAL, p, 3)).astype(np.float32)
    kp_pts[..., 2] += 3.0
    midx = rng.integers(0, p, (CAP, p)).astype(np.int32)
    minl = (rng.random((CAP, p)) < 0.7).astype(np.float32)
    has = np.arange(CAP) < 4                        # edges 4.. keep their sums
    (jp, je, _), (tp, te, _) = _both(poses, edges, active)
    want = jba.reweight_edges(jp, je, jnp.asarray(kp_pts), jnp.asarray(midx),
                              jnp.asarray(minl), jnp.asarray(has), jnp.float32(0.5))
    got = tba.reweight_edges(tp, te, torch.as_tensor(kp_pts), torch.as_tensor(midx),
                             torch.as_tensor(minl), torch.as_tensor(has), 0.5)
    for name, a, b in zip(tba.EdgeSums._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=name)


FLOORS = (BAConfig.kf_bucket_floor, BAConfig.edge_bucket_floor)     # (32, 128)


def _bucketed(poses, edges, n_rows, n_edges):
    """The graph as GCSLAM hands it to BA at its buckets: identity pose rows
    past the keyframes, inactive; zero edge rows past the store, invalid."""
    p = np.tile(np.eye(4, dtype=np.float32), (n_rows, 1, 1))
    p[:N_KF] = poses[:N_KF]
    e = jba.EdgeSums(*(jnp.concatenate([a, jnp.zeros((n_edges - a.shape[0],) + a.shape[1:],
                                                      a.dtype)]) for a in edges))
    return p, e, np.arange(n_rows) < N_KF


@pytest.mark.parametrize("against", ["true_count", "jax"])
@pytest.mark.parametrize("noise,seed,rounds,corrupt", [(0.05, 0, 3, False), (0.05, 1, 3, True),
                                                       (0.3, 3, 1, False)])
def test_bucketed_optimize(against, noise, seed, rounds, corrupt):
    """BA at the buckets: the padded pose rows stay the identity and the
    padded edges invalid; on the active rows the poses, the kept edges and
    the errors agree with BA at the true counts (6 keyframes, 7 edges), or
    with the JAX package's BA at the same buckets, within
    test_optimize_matches_jax's tolerances. With `corrupt` the loop edge
    (0, 5) is an outlier that the first round's prune disables."""
    poses, edges, active, _ = _graph(noise, seed)
    n_e = int(np.asarray(edges.valid).sum())
    if corrupt:
        s_pq = np.asarray(edges.s_pq).copy()
        s_pq[5] -= 50.0 * np.eye(3, dtype=np.float32)
        edges = edges._replace(s_pq=jnp.asarray(s_pq))
    cfg = BAConfig(gn_rounds=rounds, gn_iterations_per_round=4)
    bp, be, ba = _bucketed(poses, edges, *FLOORS)
    (jp, je, ja), (tp, te, ta) = _both(bp, be, ba)
    tout, tedges, terrs = tba.optimize(tp, te, FLOORS[0], ta, cfg)
    tout, tvalid, terrs = tout.numpy(), tedges.valid.numpy(), terrs.numpy()
    np.testing.assert_array_equal(tout[N_KF:], bp[N_KF:])
    assert tvalid.shape == (FLOORS[1],) and not tvalid[n_e:].any()
    if against == "jax":
        want, want_edges, want_errs = jba.optimize(jp, je, FLOORS[0], ja, cfg)
    else:
        _, (rp, re, ra) = _both(poses[:N_KF], jax.tree.map(lambda a: a[:n_e], edges),
                                active[:N_KF])
        want, want_edges, want_errs = tba.optimize(rp, re, N_KF, ra, cfg)
    np.testing.assert_allclose(tout[:N_KF], np.asarray(want)[:N_KF], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tvalid[:n_e], np.asarray(want_edges.valid)[:n_e])
    np.testing.assert_allclose(terrs, np.asarray(want_errs), rtol=1e-3, atol=1e-3)
    if corrupt:
        assert not tvalid[5] and tvalid[:5].all()
