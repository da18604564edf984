"""tools/bench_multichip.py, the port's multi-device benchmark, against
examples/bench_multichip.py on the CPU.

The JAX script's own functions run on its eight CPU devices, with
`sharded_integrate_step` and `make_multichip_full_step` wrapped so that the
rows and outputs of their last call are kept; the port's run on 8 CPU
shards (`make_mesh(8, "cpu")`) with the same draws and the same number of
steps. Tolerances: the pose graph's indices and flags equal, its sums
within rtol 1e-6 (float32 sums of 64 products in another order); the
sharded rows bit for bit against one shard, and against JAX at
test_torch_parallel_tsdf.py's (weight atol 1e-6, sdf atol 1e-4); Schur
within test_parallel.py's Schur tolerances of dense; the map cycle's
n_found, vertex counts and labels equal, as test_torch_multichip.py holds
the dry run.
"""

import numpy as np
import pytest
import torch

from chip_smoke import load_tool
from texturefusion_tpu.models import reconstruction as jrec
from texturefusion_tpu.parallel import sharded_tsdf as jsharded
from texturefusion_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

bm = load_tool("bench_multichip")
jbm = load_tool("bench_multichip", "examples")
CAP = 64


def _keep_last(monkeypatch, module, name):
    """Wrap module.name(...) -> step so that each step's output is kept."""
    made, kept = getattr(module, name), []

    def make(*args, **kw):
        step = made(*args, **kw)

        def recorded(*a, **k):
            out = step(*a, **k)
            kept.append(out)
            return out
        return recorded
    monkeypatch.setattr(module, name, make)
    return kept


@pytest.mark.parametrize("k", [64, 128])
def test_synthetic_pose_graph_matches_jax(k):
    want, n_want = jbm._synthetic_pose_graph(k)
    got, n_got = bm._synthetic_pose_graph(k)
    assert n_got == n_want and got.kf_i.shape[0] == want.kf_i.shape[0] >= n_want
    for name in ("kf_i", "kf_j", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for name in ("s_w", "s_p", "s_q", "s_pp", "s_qq", "s_pq"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)


def test_sharded_tsdf_rows_match_one_shard_and_jax(monkeypatch):
    kept = _keep_last(monkeypatch, jsharded, "sharded_integrate_step")
    assert jbm.bench_sharded_tsdf(8, CAP, n_iters=1) > 0
    jbatch = kept[-1][0]
    eight = bm.bench_sharded_tsdf(pmesh.make_mesh(8, "cpu"), CAP, n_iters=1)
    one = bm.bench_sharded_tsdf(pmesh.make_mesh(1, "cpu"), CAP, n_iters=1)
    assert np.isfinite(eight["steps_s"]) and eight["steps_s"] > 0 and one["steps_s"] > 0
    rows8 = eight["batch"].gather(np.arange(CAP))
    rows1 = one["batch"].gather(np.arange(CAP))
    for a, b in zip(rows8, rows1):
        assert torch.equal(a, b)
    assert rows8[1].sum() > 0 and eight["batch"].per_shard("sharded_step") == [2] * 8
    np.testing.assert_allclose(rows8[1].numpy(), np.asarray(jbatch.weight), atol=1e-6)
    np.testing.assert_allclose(rows8[0].numpy(), np.asarray(jbatch.sdf), atol=1e-4)


def test_distributed_ba_rate_is_finite():
    for n in (1, 8):
        rate = bm.bench_distributed_ba(pmesh.make_mesh(n, "cpu"), n_iters=1)
        assert np.isfinite(rate) and rate > 0


def test_ba_scale_schur_within_tolerance_of_dense():
    rows = bm.bench_ba_scale(pmesh.make_mesh(8, "cpu"), ks=(64,), n_iters=1)
    assert [r["K"] for r in rows] == [64] and rows[0]["n_dev"] == 8
    assert rows[0]["schur_within_tol"] and rows[0]["schur_max_abs_diff"] <= 2e-4
    for key in ("dense_ms_per_gn_iter", "schur_ms_per_gn_iter"):
        assert np.isfinite(rows[0][key]) and rows[0][key] > 0


def test_full_step_matches_jax(monkeypatch):
    kept = _keep_last(monkeypatch, jrec, "make_multichip_full_step")
    assert jbm.bench_full_step(8, n_iters=1) > 0
    _, j_found, j_vcount, j_labels = kept[-1]
    got = bm.bench_full_step(pmesh.make_mesh(8, "cpu"), n_iters=1)
    assert np.isfinite(got["steps_s"]) and got["steps_s"] > 0
    assert got["n_found"] == int(j_found) > 0
    np.testing.assert_array_equal(got["vcount"].numpy(), np.asarray(j_vcount))
    assert int(got["vcount"].sum()) > 0
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(j_labels))


def test_full_step_inputs_are_the_jax_draws():
    x = bm.full_step_inputs(8)
    rng = np.random.default_rng(0)
    want = [(rng.integers(-8, 8, (512, 3)) * 0.16).astype(np.float32),
            rng.uniform(-1, 1, (32, 3)).astype(np.float32),
            rng.uniform(0.5, 3.0, (480, 640)).astype(np.float32)]
    for key, w in zip(("origins", "points", "depth"), want):
        np.testing.assert_array_equal(x[key], w)
    assert x["cap"] == 512 and x["label_kf"].max() < 16 and x["neighbors"].max() < 256
