"""Edge-sharded and Schur BA (parallel/ba.py), port against JAX.

The JAX side runs on its eight CPU devices, as tests/test_parallel.py
runs it; the port on an 8-shard CPU DeviceMesh. Graphs are
test_fastba.py's six-keyframe arc and test_parallel.py's 32-keyframe
chain. Tolerances are test_parallel.py's: distributed GN poses rtol 1e-3,
atol 1e-5, the first error rtol 1e-4; Schur poses rtol 2e-3,
atol 2e-4 with the final error within 3e-5 of the first (the converged
float32 noise floor moves with the order of the sums; the distributed
GN's final errors, converged to that floor on both sides, are each held
below 1e-4 of the first); the separator
overflow's dense fallback rtol 1e-3, atol 1e-5.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fastba import _make_pose_graph
from test_parallel import _make_chain_graph
from texturefusion_tpu.config import BAConfig as JBAConfig
from texturefusion_tpu.parallel import ba as jpba
from texturefusion_tpu.parallel import mesh as jmesh
from texturefusion_torch.config import BAConfig, tiny_test_config
from texturefusion_torch.parallel import ba as pba
from texturefusion_torch.parallel import mesh as pmesh
from texturefusion_torch.slam import fastba as tba
from texturefusion_torch.slam.gcslam import GCSLAM as TSLAM
from texturefusion_torch.slam.gcslam import KeyframeRecord
from texturefusion_torch.utils.convert import edges_from_numpy, poses_from_numpy

torch.set_num_threads(2)


def _jax_sharded(edges, m):
    return jpba.shard_edges(jpba.pad_edges_for_mesh(edges, m.size), m)


def _torch(poses, edges, active):
    return (poses_from_numpy(poses, "cpu"), edges_from_numpy(edges, "cpu"),
            torch.tensor(np.asarray(active)))


def _port_sharded(edges, mesh):
    return pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh)


@pytest.mark.parametrize("seed", [0, 7])
def test_distributed_gn_matches_jax(seed):
    poses, edges, active, _, n = _make_pose_graph(noise=0.05, seed=seed)
    m = jmesh.make_mesh()
    jcfg = JBAConfig(gn_rounds=1, gn_iterations_per_round=5)
    jout, je0, je1 = jpba.distributed_gn(poses, _jax_sharded(edges, m), n, active, jcfg, m)
    mesh = pmesh.make_mesh(8, "cpu")
    tp, te, ta = _torch(poses, edges, active)
    tout, te0, te1 = pba.distributed_gn(tp, _port_sharded(te, mesh), n, ta,
                                        BAConfig(gn_rounds=1, gn_iterations_per_round=5), mesh)
    np.testing.assert_allclose(float(te0), float(je0), rtol=1e-4)
    # both converge to the float32 floor of the closed-form error's
    # cancellation (±5e-4 on the arc's sums), whose sign and value move with
    # the order of the sums: each final error is four orders below the first
    assert abs(float(te1)) < 1e-4 * float(je0) and abs(float(je1)) < 1e-4 * float(je0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-3, atol=1e-5)
    # and the dense port solve on the same graph
    dout, _, _ = tba.gauss_newton_rounds(tp, te, n, ta, BAConfig(gn_rounds=1,
                                                                gn_iterations_per_round=5))
    np.testing.assert_allclose(tout.numpy(), dout.numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("sep_budget,n_loops", [(24, 3), (2, 6)])
def test_schur_gn_matches_jax(sep_budget, n_loops):
    """sep_budget 24: the Schur path (8 blocks of 4 keyframes, interiors
    eliminated per shard); 2: the separators overflow and every
    iteration takes the dense solve."""
    poses, edges, active, _, n_kf = _make_chain_graph(n_loops=n_loops)
    iters = 4 if sep_budget > 2 else 3
    m = jmesh.make_mesh()
    jout, je0, je1 = jpba.schur_gn(poses, _jax_sharded(edges, m), n_kf, active,
                                   JBAConfig(gn_rounds=1, gn_iterations_per_round=iters), m,
                                   sep_budget=sep_budget)
    mesh = pmesh.make_mesh(8, "cpu")
    tp, te, ta = _torch(poses, edges, active)
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=iters)
    tout, te0, te1 = pba.schur_gn(tp, _port_sharded(te, mesh), n_kf, ta, cfg, mesh,
                                  sep_budget=sep_budget)
    dout, de0, de1 = tba.gauss_newton_rounds(tp, te, n_kf, ta, cfg)
    np.testing.assert_allclose(float(te0), float(je0), rtol=1e-4)
    rtol, atol = (2e-3, 2e-4) if sep_budget > 2 else (1e-3, 1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tout.numpy(), dout.numpy(), rtol=rtol, atol=atol)
    if sep_budget > 2:
        assert abs(float(te1) - float(je1)) < 3e-5 * float(je0)
        assert abs(float(te1) - float(de1)) < 3e-5 * float(de0)


def test_schur_separators_are_the_cross_block_keyframes():
    poses, edges, active, _, n_kf = _make_chain_graph()
    mesh = pmesh.make_mesh(8, "cpu")
    te = edges_from_numpy(edges, "cpu")
    sep = pba._separators(mesh, _port_sharded(te, mesh), n_kf, n_kf // 8).numpy()
    i, j = np.asarray(edges.kf_i), np.asarray(edges.kf_j)
    v = np.asarray(edges.valid)
    want = np.zeros(n_kf, bool)
    cross = v & (i // 4 != j // 4)
    want[i[cross]] = want[j[cross]] = True
    np.testing.assert_array_equal(sep, want)
    assert 0 < sep.sum() < n_kf


@pytest.mark.parametrize("use_schur", [False, True])
def test_ba_rounds_prune_globally_like_jax(use_schur):
    """Three rounds with pruning in between, on the chain with its first
    loop edge corrupted: the outlier is pruned by the GLOBAL median (the
    per-edge means gathered across the shards), as JAX prunes its
    GSPMD-sharded edges; the same mask, errors and poses."""
    poses, edges, active, _, n_kf = _make_chain_graph()
    s_pq = np.asarray(edges.s_pq).copy()
    s_pq[n_kf - 1] -= 50.0 * np.eye(3, dtype=np.float32)
    edges = edges._replace(s_pq=jnp.asarray(s_pq))
    n_e = n_kf - 1 + 3
    jcfg = JBAConfig(gn_rounds=3, gn_iterations_per_round=4)
    m = jmesh.make_mesh()
    jout, jvalid, jerrs = jpba.ba_rounds(poses, edges, n_kf, active, jcfg, m, n_e,
                                         use_schur, 24)
    mesh = pmesh.make_mesh(8, "cpu")
    tp, te, ta = _torch(poses, edges, active)
    tout, tvalid, terrs = pba.ba_rounds(tp, te.head(n_e), n_kf, ta,
                                        BAConfig(gn_rounds=3, gn_iterations_per_round=4),
                                        mesh, use_schur, 24)
    jerrs, terrs = np.asarray(jerrs), terrs.numpy()
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert not tvalid[n_kf - 1] and tvalid[:n_kf - 1].all()
    np.testing.assert_allclose(terrs[0, 0], jerrs[0, 0], rtol=1e-4)
    assert (np.abs(terrs - jerrs).reshape(-1)[1:] < 3e-5 * jerrs[0, 0]).all()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-4)


def test_mesh_collectives_and_edge_padding():
    mesh = pmesh.DeviceMesh(["cpu"] * 3)
    parts = [torch.full((2,), float(k + 1)) for k in range(3)]
    assert all(torch.equal(x, torch.full((2,), 6.0)) for x in mesh.psum(parts))
    assert torch.equal(mesh.pmax(parts)[1], torch.full((2,), 3.0))
    assert torch.equal(mesh.all_gather(parts)[2], torch.tensor([1., 1, 2, 2, 3, 3]))
    np.testing.assert_array_equal(mesh.shard_of(np.arange(7)), [0, 1, 2, 0, 1, 2, 0])
    np.testing.assert_array_equal(mesh.local_row(np.arange(7)), [0, 0, 0, 1, 1, 1, 2])
    e = tba.make_edges(7, "cpu")
    padded = pba.pad_edges_for_mesh(e, 3)
    assert padded.s_w.shape[0] == 9 and not padded.valid[7:].any()
    assert [s.s_w.shape[0] for s in pba.shard_edges(padded, mesh)] == [3, 3, 3]
    assert pmesh.shard_leading(mesh, 9) == [slice(0, 3), slice(3, 6), slice(6, 9)]
    assert pmesh.replicated(mesh, 9) == [slice(0, 9)] * 3
    assert pmesh.pad_to_multiple(7, 3) == 9
    with pytest.raises(ValueError, match="9 cpu devices: 8 visible"):
        pmesh.make_mesh(9, "cpu")
    pmesh.init_distributed()                      # no coordinator: a no-op
    with pytest.raises(NotImplementedError, match="multi-host"):
        pmesh.init_distributed("localhost:1234", 2, 0)
    with pytest.warns(UserWarning, match="n_devices=16 but 8 cpu devices"):
        assert pmesh.config_mesh(16, "cpu", "GCSLAM") is None
    assert pmesh.config_mesh(1, "cpu", "GCSLAM") is None
    assert pmesh.config_mesh(2, "cpu", "GCSLAM").size == 2
    assert pmesh.tsdf_mesh(None, "cpu").size == 8 and pmesh.tsdf_mesh(1, "cpu") is None
    with pytest.warns(UserWarning, match="n_devices=12 but 8 cpu devices"):
        assert pmesh.tsdf_mesh(12, "cpu").size == 8
    assert pmesh.same_device("cpu", "cpu") and not pmesh.same_device("cpu", "cuda")


def test_mesh_rules_warn_with_one_gpu(monkeypatch):
    """On a machine with one GPU, a config asking for several devices
    warns, naming both counts, and runs on one (the pipeline's and
    GCSLAM's rule alike); asking for none says nothing."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.warns(UserWarning, match="n_devices=4 but 1 cuda devices exist; running on one"):
        assert pmesh.tsdf_mesh(4, "cuda") is None
    with pytest.warns(UserWarning, match="n_devices=4 but 1 cuda devices exist; running on one"):
        assert pmesh.config_mesh(4, "cuda", "GCSLAM") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pmesh.tsdf_mesh(None, "cuda") is None
        assert pmesh.config_mesh(1, "cuda", "GCSLAM") is None


def _chain_slam(mesh, n_kf):
    """GCSLAM (tiny config: 32 keyframe slots) holding n_kf keyframes on a
    noisy arc, odometry edges and a loop edge every fifth keyframe, each
    measured with 5 mm of noise; the first loop edge is 0.3 m off, so
    pruning has an outlier to decide on above the float noise floor."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, schur_min_keyframes=16,
                                                          gn_rounds=2))
    slam = TSLAM(cfg, device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    truth = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    for k in range(n_kf):
        a = 0.05 * k
        truth[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        truth[k, :3, 3] = [np.sin(a), 0.0, 1.0 - np.cos(a)]
    for k in range(n_kf):
        slam.keyframes.append(KeyframeRecord(frame_index=k, slot=k, origin_index=0))
        slam.poses[k] = truth[k]
        if k:
            slam.poses[k, :3, 3] += rng.normal(0, 0.02, 3).astype(np.float32)
    pairs = [(k, k + 1) for k in range(n_kf - 1)] + [(k, k + 5) for k in range(0, n_kf - 5, 5)]
    for i, j in pairs:
        rel = np.linalg.inv(truth[i]) @ truth[j]
        rel[:3, 3] += rng.normal(0, 0.005, 3) + (0.3 if (i, j) == (0, 5) else 0.0)
        slam._add_virtual_edge(i, j, rel)
    return slam


@pytest.mark.parametrize("n_kf", [31, 32])
def test_sharded_ba_pads_past_the_pose_array(n_kf):
    """A 3-shard mesh over 32 keyframe slots pads 31 or 32 keyframes to 33,
    one row past the pose array: the padding is identity rows of its own,
    and the Schur step equals the dense one at test_parallel.py's Schur
    tolerances."""
    dense = _chain_slam(None, n_kf)
    shd = _chain_slam(pmesh.DeviceMesh(["cpu"] * 3), n_kf)
    dense._run_ba()
    shd._run_ba()
    assert shd.ba_keyframes == n_kf and len(shd.last_ba_errors) == 2
    assert shd.last_ba_errors[0][1] < shd.last_ba_errors[0][0]
    np.testing.assert_allclose(shd.poses[:n_kf], dense.poses[:n_kf], rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(shd.edges.valid.numpy(), dense.edges.valid.numpy())
    assert not shd.edges.valid[n_kf - 1]          # the corrupted loop edge (0, 5)
