"""GCSLAM's synchronous tracking state machine, port against JAX.

Both packages track the same rendered frames (tiny_test_config) with the
JAX package in its synchronous configuration (defer_promote=False) and
the JAX key path replayed as the port's RANSAC draws. Tolerances: the
same keyframe decisions, keyframe, edge and origin counts; every frame
pose within 1e-3 m / 1e-3 of the JAX trajectory (the two agree to ~1e-5
here; the margin covers float32 solves in another order).
Port-only cases follow tests/test_gcslam.py and tests/test_origins.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws
from texturefusion_tpu.config import ParallelConfig, tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.eval import loop_closure as jeval
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.io import tum as jtum
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.slam.gcslam import GCSLAM as JSLAM
from texturefusion_torch.eval import loop_closure as teval
from texturefusion_torch.io import tum as ttum
from texturefusion_torch.slam import fastba
from texturefusion_torch.slam.gcslam import GCSLAM as TSLAM

torch.set_num_threads(2)

BASE = tiny_test_config()
CFG = BASE.replace(tracking=dataclasses.replace(BASE.tracking, defer_promote=False))
JI = jcam.Intrinsics.from_config(CFG.camera)
POSE_TOL = 1e-3


def _render(poses):
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    grays = [np.asarray(jpre.rgb_to_gray(jnp.asarray(c)) * 255.0) for c in rgbs]
    return np.stack(poses), depths, grays


def _run_both(poses, depths, grays, final_ba=False, config=CFG):
    js = JSLAM(config)
    ts = TSLAM(config, device="cpu", draw_fn=JaxKeyDraws())
    for i, (d, g) in enumerate(zip(depths, grays)):
        js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
        ts.update_frame(torch.tensor(g), torch.tensor(d), timestamp=float(i))
    if final_ba:
        js.final_ba()
        ts.final_ba()
    return js, ts


@pytest.fixture(scope="module")
def orbit():
    poses, depths, grays = _render(jsyn.orbit_trajectory(10))
    return (poses, depths, grays) + _run_both(poses, depths, grays)


@pytest.fixture(scope="module")
def loop():
    """30 frames of a loop at radius 0.6 m: keyframe promotions, edges,
    BA and the promotion probe on every new keyframe."""
    poses, depths, grays = _render(jsyn.loop_trajectory(30, radius=0.6))
    return (poses, depths, grays) + _run_both(poses, depths, grays, final_ba=True)


def _same_decisions(js, ts):
    assert len(ts.frames) == len(js.frames)
    assert [f.is_keyframe for f in ts.frames] == [f.is_keyframe for f in js.frames]
    assert [f.tracking_success for f in ts.frames] == [f.tracking_success for f in js.frames]
    assert [f.keyframe_slot for f in ts.frames] == [f.keyframe_slot for f in js.frames]
    assert len(ts.keyframes) == len(js.keyframes)
    assert ts.origin_count == js.origin_count
    assert ts.n_edges == js.n_edges
    np.testing.assert_allclose(ts.trajectory(), js.trajectory(), atol=POSE_TOL, rtol=0)


def test_orbit_matches_jax(orbit):
    poses, _, _, js, ts = orbit
    _same_decisions(js, ts)
    assert all(f.tracking_success for f in ts.frames)
    assert ts.origin_count == 1
    assert jtum.ate_rmse(js.trajectory(), poses) < 0.02
    assert ttum.ate_rmse(ts.trajectory(), poses) < 0.02


def test_loop_with_promotions_matches_jax(loop):
    _, _, _, js, ts = loop
    _same_decisions(js, ts)
    assert len(ts.keyframes) >= 5 and ts.n_edges >= len(ts.keyframes) - 1
    n = ts.n_edges
    np.testing.assert_array_equal(ts.edges.kf_i[:n].numpy(), np.asarray(js.edges.kf_i)[:n])
    np.testing.assert_array_equal(ts.edges.kf_j[:n].numpy(), np.asarray(js.edges.kf_j)[:n])
    np.testing.assert_array_equal(ts.edges.valid[:n].numpy(), np.asarray(js.edges.valid)[:n])
    np.testing.assert_allclose(ts.edges.s_w[:n].numpy(), np.asarray(js.edges.s_w)[:n],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.stack(ts.last_ba_errors),
                               np.stack([np.asarray(e) for e in js.last_ba_errors]),
                               rtol=1e-3, atol=1e-3)   # Σw‖x−y‖² cancels from ~1e3-sized moments
    e0, e1 = ts.last_ba_errors[-1]
    assert e1 <= e0 * CFG.ba.rollback_error_growth + 1e-3


def test_keyframes_attach_and_ba_ran(loop):
    _, _, _, _, ts = loop
    for f in ts.frames:
        assert 0 <= f.keyframe_slot < len(ts.keyframes)
    assert ts.last_ba_errors


def test_static_camera_single_keyframe(orbit):
    _, depths, grays, _, _ = orbit
    slam = TSLAM(CFG, device="cpu")
    for i in range(4):
        slam.update_frame(torch.tensor(grays[0]), torch.tensor(depths[0]), timestamp=float(i))
    assert len(slam.keyframes) == 1
    for p in slam.trajectory():
        assert np.abs(p - np.eye(4)).max() < 1e-2


def test_lost_tracking_starts_new_origin_then_merges():
    poses, depths, grays = _render(jsyn.orbit_trajectory(6))
    slam = TSLAM(CFG, device="cpu")
    blank = torch.zeros((JI.height, JI.width))

    def feed(i, is_blank=False):
        if is_blank:
            return slam.update_frame(blank, blank, timestamp=float(i))
        return slam.update_frame(torch.tensor(grays[i]), torch.tensor(depths[i]),
                                 timestamp=float(i))

    feed(0)
    feed(1)
    for _ in range(4):            # the sensor is covered: forced failures
        feed(0, is_blank=True)
    assert slam.origin_count >= 2
    assert len({k.origin_index for k in slam.keyframes}) >= 2
    for i in range(6):            # the scene again: closure back to origin 0 merges
        feed(i)
    assert 0 in {k.origin_index for k in slam.keyframes}
    assert sum(f.origin_index == 0 for f in slam.frames) > len(slam.frames) // 2


def _sharded_ba_run(loop, n_devices, schur_min_keyframes=None):
    """Both packages on the loop with BA's edges sharded over n_devices of
    their eight CPU devices: the same decisions and final BA, positions
    within POSE_TOL, the same pruned edges."""
    _, depths, grays, _, _ = loop
    config = CFG.replace(parallel=ParallelConfig(n_devices=n_devices))
    if schur_min_keyframes is not None:
        config = config.replace(ba=dataclasses.replace(config.ba,
                                                       schur_min_keyframes=schur_min_keyframes))
    js, ts = _run_both(None, depths, grays, final_ba=True, config=config)
    assert ts.mesh is not None and ts.mesh.size == n_devices
    _same_decisions(js, ts)
    assert ts.ba_keyframes == len(ts.keyframes) >= 5
    n = ts.n_edges
    np.testing.assert_array_equal(ts.edges.valid[:n].numpy(), np.asarray(js.edges.valid)[:n])
    np.testing.assert_allclose(np.stack(ts.last_ba_errors),
                               np.stack([np.asarray(e) for e in js.last_ba_errors]),
                               rtol=1e-3, atol=1e-3)


def test_unported_ba_branches_raise(loop):
    """Multi-device BA was the unported branch that raised at the first
    BA; it is ported: with n_devices = 2 the port shards BA's edges over
    two CPU shards (distributed GN below schur_min_keyframes) as the JAX
    package does over two of its devices, and matches it."""
    _sharded_ba_run(loop, 2)


@pytest.mark.parametrize("schur_min", [None, 2])
def test_sharded_ba_matches_jax(loop, schur_min):
    """Eight shards: distributed GN (tiny config, below
    schur_min_keyframes) and, with the threshold at 2, Schur GN at every
    BA. The JAX package pads the keyframes to its bucket (32) and the port
    to a multiple of the shard count, so their separator sets differ; the
    exact Schur step is the dense step either way."""
    _sharded_ba_run(loop, 8, schur_min)


def test_ba_past_schur_min_keyframes_matches_jax(loop):
    """On one device, BA from schur_min_keyframes on is ported: with the
    threshold at 2, the JAX package runs its Schur BA (a 1-device mesh) at
    every keyframe, and the port its dense BA; the two agree within this
    file's tolerances, with the same final BA."""
    _, depths, grays, _, _ = loop
    config = CFG.replace(ba=dataclasses.replace(CFG.ba, schur_min_keyframes=2))
    js = JSLAM(config)
    ts = TSLAM(config, device="cpu", draw_fn=JaxKeyDraws())
    for i, (d, g) in enumerate(zip(depths, grays)):
        js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
        ts.update_frame(torch.tensor(g), torch.tensor(d), timestamp=float(i))
    js.final_ba()
    ts.final_ba()
    _same_decisions(js, ts)
    assert ts.ba_keyframes == len(ts.keyframes) >= 5
    np.testing.assert_allclose(np.stack(ts.last_ba_errors),
                               np.stack([np.asarray(e) for e in js.last_ba_errors]),
                               rtol=1e-3, atol=1e-3)


def test_add_edge_preintegrates_a_registration(orbit):
    _, depths, grays, _, _ = orbit
    slam = TSLAM(CFG, device="cpu")
    for i in (0, 1):
        slam.update_frame(torch.tensor(grays[i]), torch.tensor(depths[i]), timestamp=float(i))
    kp0, kp1 = slam.frames[0].keypoints, slam._prev_kp
    res = slam._register(kp0, kp1)
    slam._add_edge(0, 0, kp0, kp1, res)
    assert slam.n_edges == 1 and slam._edge_has[0] and bool(slam.edges.valid[0])
    want = fastba.preintegrate_from_registration(
        kp0.points3d[res.match_idx], kp1.points3d, res.inliers.float(), res.pose,
        CFG.ba.huber_delta)
    for got, w in zip(slam.edges[2:8], want):
        np.testing.assert_array_equal(got[0].numpy(), w.numpy())
    assert torch.equal(slam._edge_midx[0], res.match_idx)


def test_stale_keyframe_result_raises(orbit):
    _, depths, grays, _, _ = orbit
    slam = TSLAM(CFG, device="cpu")
    slam.update_frame(torch.tensor(grays[0]), torch.tensor(depths[0]))
    kp = slam.frames[0].keypoints
    res = slam._register(kp, kp)
    with pytest.raises(NotImplementedError, match="stale"):
        slam.update_frame(torch.tensor(grays[1]), torch.tensor(depths[1]), kp=kp, res=res,
                          res_kf_slot=3)


def test_ate_and_loop_closure_eval_match_jax(loop):
    poses, _, _, js, ts = loop
    rng = np.random.default_rng(0)
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.01, (len(poses), 3)).astype(np.float32)
    assert ttum.ate_rmse(noisy, poses) == pytest.approx(jtum.ate_rmse(noisy, poses), rel=1e-12)
    rot, t = ttum.align_umeyama(noisy, poses)
    jrot, jt = jtum.align_umeyama(noisy, poses)
    np.testing.assert_array_equal(rot, jrot)
    np.testing.assert_array_equal(t, jt)
    kf_gt = poses[[k.frame_index for k in ts.keyframes]]
    truth = teval.ground_truth_pairs(kf_gt)
    assert truth == jeval.ground_truth_pairs(kf_gt)
    det = teval.detected_pairs_from_slam(ts)
    assert det == jeval.detected_pairs_from_slam(js)
    assert teval.precision_recall(det, truth) == jeval.precision_recall(det, truth)
    assert teval.precision_recall([], set())["precision"] == 1.0
