"""tools/sol_report.py, the port's speed-of-light report, against
examples/sol_report.py on the CPU.

- The tool's inputs are the JAX script's numpy draws (its lines 64-77,
  repeated here in numpy) at the full size and at the reduced one (the
  tiny test camera, 1024 rows, U = 256, 100 real lanes).
- At the reduced size each timed program gives the JAX program's output on
  the same inputs: the TSDF rows and the per-chunk quality at
  test_torch_tsdf.py's tolerances, the discovery exact, the mesh pool as
  test_torch_mesh.py holds it (counts and triangles exact, positions 1e-5,
  packed channels within one step), the tracked step's bundle as
  test_torch_preprocess.py holds it, its registrations and fused keyframe
  and the probe as test_torch_tracked_step.py and test_torch_loopclosure.py
  hold them, with
  the JAX draws injected (test_torch_draws.tracked2_draws, batch_draws).
  The JAX tracked step is that file's `_jax_tracked2` (the Pallas
  bilateral filter in interpret mode).
- The byte counts at the JAX script's shapes equal the bytes_mb of the
  same rows in SOL_REPORT.json: a count of rows and pixels touched, so the
  report reads the same work whatever implements it.
- The report's keys and its row order are fixed.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import load_tool
from test_torch_draws import batch_draws, tracked2_draws
from test_torch_tracked_step import _jax_tracked2
from texturefusion_tpu.config import TSDFConfig as JTSDFConfig
from texturefusion_tpu.config import tiny_test_config as jtiny
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.ops import marching_cubes as jmc
from texturefusion_tpu.ops import tsdf as jtsdf
from texturefusion_tpu.slam import features as jf
from texturefusion_tpu.slam import promote as jpr
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.ops import tsdf as ttsdf
from texturefusion_torch.utils.convert import keypoints_from_numpy

torch.set_num_threads(2)

sol = load_tool("sol_report")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TOL = ((1e-5, 1e-5), (1e-6, 1e-6), (1e-4, 1e-3), (1e-6, 1e-6))
SMALL = dict(h=120, w=160, capacity=1024, n_update=256, n_real=100)


def _jax_script_draws(h, w, capacity, n_update, n_real):
    """examples/sol_report.py:64-77 in numpy."""
    rng = np.random.default_rng(0)
    depth_np = np.clip(rng.normal(2.0, 0.3, (h, w)), 0.3, 5.0).astype(np.float32)
    rgb_np = rng.random((h, w, 3), np.float32)
    quality = rng.random((h, w), np.float32)
    origins = rng.integers(-20, 20, (capacity + 1, 3)).astype(np.float32) * 0.16
    idx_np = np.concatenate([rng.choice(capacity, n_real, replace=False),
                             np.full(n_update - n_real, capacity)]).astype(np.int64)
    return depth_np, rgb_np, quality, origins, idx_np, np.arange(n_update) < n_real


@pytest.mark.parametrize("size", [dict(h=480, w=640, capacity=16384, n_update=1024, n_real=400),
                                  SMALL])
def test_inputs_are_the_jax_scripts_draws(size):
    got = sol.draws(**size)
    want = _jax_script_draws(**size)
    for key, w in zip(("depth", "rgb", "quality", "origins", "idx", "active"), want):
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_reduced_config_is_the_reduced_size():
    config = sol.sol_config(small=True)
    assert (config.camera.height, config.camera.width) == (SMALL["h"], SMALL["w"])
    assert (config.tsdf.capacity, config.tsdf.max_update_chunks) == (1024, 256)
    full = sol.sol_config()
    assert (full.camera.height, full.camera.width, full.camera.far_plane) == (480, 640, 6.0)
    assert (full.tsdf.capacity, full.tsdf.max_update_chunks, full.tsdf.voxel_resolution) == (
        16384, 1024, 0.02)
    assert full.tracking.blur_threshold == 0.0 == config.tracking.blur_threshold


def test_byte_counts_equal_sol_report_json():
    with open(os.path.join(ROOT, "SOL_REPORT.json")) as f:
        tpu = {r["kernel"]: r["bytes_mb"] for r in json.load(f)["kernels"]}
    counts = sol.jax_bytes(480, 640, 400)
    assert set(counts) == set(tpu)
    for name, n_bytes in counts.items():
        assert round(n_bytes / 2 ** 20, 2) == tpu[name], name
    full = {"intr": tcam.Intrinsics.from_config(sol.sol_config().camera), "n_real": 400,
            "config": sol.sol_config()}
    for name in sol.ROWS[:-1]:
        assert round(sol.row_bytes(full, name) / 2 ** 20, 2) == tpu[sol.JAX_NAME[name]], name
    # the probe, which the JAX script leaves at 0: 8 DB rows of 1024 descriptors and flags,
    # 6 keyframes' keypoints
    assert sol.row_bytes(full, sol.ROWS[-1]) == 8 * 1024 * 33 + 6 * 1024 * 66


def test_report_keys_and_row_order_are_fixed(tmp_path):
    rows = sol.run(sol.sol_config(small=True), "cpu", n=1, n_real=100, log=lambda m: None)
    assert [r["kernel"] for r in rows] == list(sol.ROWS)
    assert len(sol.ROWS) == 8
    for r in rows:
        assert tuple(r) == sol.KEYS
        assert r["ms"] > 0 and r["bytes_mb"] > 0 and r["bound_by"] == "bytes"
        # a CPU run gives no device number
        assert r["device_ms"] is r["span_ms"] is r["device_ops"] is r["frac_of_roofline"] is None
        assert r["calls_per_cycle"] is None
    # the K2 rows' data needs a fraction of the JAX formulas' bytes
    assert all(r["needed_mb"] < r["bytes_mb"] / 10 for r in rows[:3])
    path = str(tmp_path / "sol.json")
    sol.write_report(path, rows, {}, "cpu")
    with open(path) as f:
        report = json.load(f)
    assert list(report) == ["device", "peak_hbm_gbs", "kernels", "scaling"]
    assert report["peak_hbm_gbs"] == 3350.0 and report["device"] == "cpu"


def _jax_config():
    tiny = jtiny()
    return tiny.replace(tracking=dataclasses.replace(tiny.tracking, blur_threshold=0.0),
                        tsdf=JTSDFConfig(voxel_resolution=0.02, capacity=1024,
                                         max_update_chunks=256))


@pytest.fixture(scope="module")
def both():
    """The port's inputs at the reduced size with the JAX draws injected,
    and the JAX script's arrays for the same."""
    config = sol.sol_config(small=True)
    inp = sol.make_inputs(config, "cpu", n_real=100)
    jconfig = _jax_config()
    jintr = jcam.Intrinsics.from_config(jconfig.camera)
    key = jax.random.PRNGKey(0)
    tcfg = config.tracking
    inp["tracked_draws"] = tracked2_draws(key, 0, tcfg)
    inp["probe_draws"] = batch_draws(key, sol.N_CAND, tcfg, tcfg.max_features_pad)
    x = {k: jnp.asarray(inp[k].numpy()) for k in ("depth", "rgb", "quality", "origins", "idx",
                                                  "active")}
    x["kp"] = jf.extract_features(jnp.mean(x["rgb"], -1), x["depth"], jconfig.tracking, jintr)
    return inp, jconfig, jintr, x, key


def _fresh_rows(jconfig):
    cfg = jconfig.tsdf
    return jtsdf.ChunkBatch(*jtsdf.make_empty_batch(cfg.capacity + 1, cfg.chunk_size ** 3))


def _rows_match(got, want, cap):
    for (rtol, atol), g, w, name in zip(ROW_TOL, got, want, ("sdf", "weight", "color", "ccnt")):
        np.testing.assert_allclose(g.numpy()[:cap], np.asarray(w)[:cap], rtol=rtol, atol=atol,
                                   err_msg=name)


def _fresh_port(inp):
    """inp with fresh rows."""
    cfg = inp["config"].tsdf
    return {**inp, "batch": ttsdf.make_empty_batch(cfg.capacity + 1, cfg.chunk_size ** 3, "cpu")}


def test_tsdf_programs_match_jax(both):
    inp, jconfig, jintr, x, _ = both
    cfg, n = jconfig.tsdf, inp["n_real"]
    pose = jnp.eye(4)
    one = jnp.float32(1.0)
    # integrate_frame_fused: one K2 call on fresh rows
    p = _fresh_port(inp)
    q, upd = sol.programs(p)[sol.ROWS[0]]()
    jb, jq, ju = jtsdf.integrate_frame_fused(_fresh_rows(jconfig), x["origins"], x["idx"],
                                             x["active"], x["depth"], x["rgb"], x["quality"],
                                             pose, one, jintr, cfg, with_color=True)
    _rows_match(p["batch"], jb, cfg.capacity)
    np.testing.assert_allclose(q.numpy()[:n], np.asarray(jq)[:n], rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(upd.numpy()[:n], np.asarray(ju)[:n])
    assert int(upd.sum()) > 0
    # reintegrate_frame_fused and integrate_depths_batched(6) on those rows
    q, upd = sol.programs(p)[sol.ROWS[1]]()
    jb, jq, ju = jtsdf.reintegrate_frame_fused(jb, x["origins"], x["idx"], x["active"],
                                               x["depth"], x["rgb"], x["quality"], pose, pose,
                                               jintr, cfg)
    _rows_match(p["batch"], jb, cfg.capacity)
    np.testing.assert_array_equal(upd.numpy()[:n], np.asarray(ju)[:n])
    sol.programs(p)[sol.ROWS[2]]()
    jb = jtsdf.integrate_depths_batched(jb, x["origins"], x["idx"], x["active"],
                                        jnp.stack([x["depth"]] * 6), jnp.stack([pose] * 6), one,
                                        jintr, cfg)
    _rows_match(p["batch"], jb, cfg.capacity)


def test_discovery_and_meshing_match_jax(both):
    inp, jconfig, jintr, x, _ = both
    cfg = jconfig.tsdf
    progs = sol.programs(inp)
    jids, jn = jtsdf.candidate_chunks_unique(x["depth"], jnp.eye(4), jintr, cfg, stride=2,
                                             max_out=cfg.max_update_chunks * 4)
    ids, n = progs[sol.ROWS[3]]()
    ids_dev, n_dev = progs[sol.ROWS[4]]()
    assert n == int(n_dev) == int(jn) > 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids_dev.numpy(), np.asarray(jids))
    # meshing after one integration of the same rows on both sides
    p = _fresh_port(inp)
    progs = sol.programs(p)
    progs[sol.ROWS[0]]()
    jb, _, _ = jtsdf.integrate_frame_fused(_fresh_rows(jconfig), x["origins"], x["idx"],
                                           x["active"], x["depth"], x["rgb"], x["quality"],
                                           jnp.eye(4), jnp.float32(1.0), jintr, cfg)
    vc, tc = progs[sol.ROWS[5]]()
    m_idx = x["idx"][:sol.MESH_LANES]
    jpool, jv, jt = jmc.mesh_chunks_pooled(
        jmc.make_mesh_pool(cfg.capacity, 256, 384), *jb, m_idx,
        jnp.tile(m_idx[:, None], (1, 8)), x["origins"][m_idx],
        jnp.arange(m_idx.shape[0]) < inp["n_real"], cfg.chunk_size, cfg.voxel_resolution)
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jt))
    pool, rows = progs["mesh_pool"], inp["idx"][:inp["n_real"]].numpy()
    np.testing.assert_array_equal(pool.vcount.numpy()[rows], np.asarray(jpool.vcount)[rows])
    np.testing.assert_array_equal(pool.tris.numpy()[rows], np.asarray(jpool.tris)[rows])
    np.testing.assert_allclose(pool.verts.numpy()[rows], np.asarray(jpool.verts)[rows],
                               atol=1e-5)
    for name in ("col_packed", "nrm_packed"):
        got = pool.__getattribute__(name).numpy()[rows].view(np.uint8).astype(int)
        want = np.asarray(getattr(jpool, name))[rows].view(np.uint8).astype(int)
        assert np.abs(got - want).max() <= 1, name


def test_tracked_step_matches_jax(both):
    inp, jconfig, _, x, key = both
    tcfg = inp["config"].tracking
    # the references the JAX script passes: keypoints of the mean-rgb image
    kp = inp["kp"]
    jkp = keypoints_from_numpy(x["kp"], "cpu")
    np.testing.assert_array_equal(kp.valid.numpy(), jkp.valid.numpy())
    np.testing.assert_allclose(kp.uv.numpy(), jkp.uv.numpy(), atol=1e-4, rtol=0)
    got = sol.programs(inp)[sol.ROWS[6]]()
    kf_w = (x["depth"] > 0).astype(jnp.float32)
    want = _jax_tracked2(inp["packed"].numpy(), x["kp"], x["kp"], x["depth"], kf_w, key, 0,
                         jconfig.tracking)
    # the bundle at test_torch_preprocess.py's tolerances: on this random rgb XLA's fused
    # grey sum differs by 2 ulps on the 0-255 scale (3.05e-5) at 0.1% of the pixels
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0][0]), atol=0, rtol=1e-5)
    np.testing.assert_allclose(got[0][3].numpy(), np.asarray(want[0][3]), atol=0, rtol=1e-6)
    np.testing.assert_array_equal(got[1].valid.numpy(), np.asarray(want[1].valid))
    assert int(got[1].valid.sum()) > 0
    for which in (2, 3):
        assert bool(got[which].success) == bool(want[which].success)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=1e-4, rtol=1e-4)
    same_w = got[6].numpy() == np.asarray(want[6])
    assert same_w.mean() >= 0.999
    np.testing.assert_allclose(got[5].numpy()[same_w], np.asarray(want[5])[same_w], atol=1e-4)
    assert tcfg.blur_threshold == 0.0


def test_promote_probe_matches_jax(both):
    inp, jconfig, jintr, x, key = both
    tcfg = jconfig.tracking
    got = sol.programs(inp)[sol.ROWS[7]]()
    db = jpr.KeypointDB(jconfig.ba.max_keyframes, tcfg.max_features_pad)
    for s in range(sol.KF_ROWS):
        db.add(s, x["kp"])
    desc = jnp.zeros((jconfig.ba.max_keyframes, tcfg.max_features_pad, 8), jnp.uint32)
    dvalid = jnp.zeros((jconfig.ba.max_keyframes, tcfg.max_features_pad), bool)
    want = jpr.promote_probe(db.kp, desc, dvalid,
                             jnp.arange(jconfig.ba.max_keyframes, dtype=jnp.int32),
                             jnp.int32(8), jnp.int32(7), x["kp"], jnp.zeros(21, jnp.float32),
                             jnp.asarray(False), key, tcfg.salient_score_threshold,
                             jconfig.ba.huber_delta, tcfg, jintr, sol.N_CAND)
    np.testing.assert_array_equal(got.cand_slots.numpy(), np.asarray(want.cand_slots))
    np.testing.assert_array_equal(got.cand_ok.numpy(), np.asarray(want.cand_ok))
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.fetch.numpy(), np.asarray(want.fetch), atol=1e-4, rtol=1e-4)
