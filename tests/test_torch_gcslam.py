"""GCSLAM's tracking state machine, port against JAX.

Both packages track the same rendered frames (tiny_test_config) with the
JAX key path replayed as the port's RANSAC draws: the synchronous
configuration (defer_promote=False), then the pipelined tracker's parts,
deferred promotion (defer_promote=True, with its new-origin fallback),
the stale-reference path with its refinement, and the pending BA poses
against keyframe_pose_peek. On the JAX side every fetch lands at once
(`jax_pipelined_tracker`), so both run the same decisions. The JAX
package's deferred probe takes the keyframe it has just adopted as its
candidate 0 (ROADMAP fault 16, shown below); the port probes against the
superseded keyframe, and the comparison repairs the JAX side the same
way. Tolerances: the same keyframe decisions, keyframe, edge and origin
counts; every frame pose within 1e-3 m / 1e-3 of the JAX trajectory (the
two agree to ~1e-5 here; the margin covers float32 solves in another
order). Port-only cases follow tests/test_gcslam.py and
tests/test_origins.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws, round_draws
from texturefusion_tpu.config import ParallelConfig, tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.eval import loop_closure as jeval
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.io import tum as jtum
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.slam.gcslam import GCSLAM as JSLAM
from texturefusion_tpu.utils import async_fetch as jfetch
from texturefusion_torch.eval import loop_closure as teval
from texturefusion_torch.io import tum as ttum
from texturefusion_torch.slam import fastba, gcslam
from texturefusion_torch.slam.features import extract_features
from texturefusion_torch.slam.gcslam import GCSLAM as TSLAM
from texturefusion_torch.slam.matching import register_frames
from texturefusion_torch.utils import async_fetch as tfetch

torch.set_num_threads(2)

BASE = tiny_test_config()
CFG = BASE.replace(tracking=dataclasses.replace(BASE.tracking, defer_promote=False))
DEFER = BASE          # defer_promote=True, refine_stale=True: the defaults
JI = jcam.Intrinsics.from_config(CFG.camera)
POSE_TOL = 1e-3


class LandedFetch:
    """A JAX fetch handle whose value is read when it is made."""

    def __init__(self, tree, **_):
        self._value = jax.device_get(tree)

    def done(self):
        return True

    def result(self):
        return self._value


def jax_pipelined_tracker(mp, repair_fault16=True):
    """Patch the JAX package (for one monkeypatch context) so that its
    pipelined tracker runs the port's decisions: every fetch lands at once
    (its call sites import fetch_async when they run); with
    `repair_fault16` a deferred probe's candidate 0 is the superseded
    keyframe (the keyframe adopted just before is set aside while the
    probe dispatches). Both record the frames whose promotion was deferred
    (`deferred`) and the stale-finalized frames (`stale_frames`)."""
    mp.setattr(jfetch, "fetch_async", LandedFetch)
    promote_dispatch = JSLAM._promote_dispatch
    dispatch_probe = JSLAM._dispatch_probe
    update_frame_stale = JSLAM._update_frame_stale

    def counted_promote_dispatch(self, frame, *args, **kw):
        self.deferred = getattr(self, "deferred", []) + [frame.index]
        self._probing_parent = repair_fault16
        try:
            return promote_dispatch(self, frame, *args, **kw)
        finally:
            self._probing_parent = False

    def parent_dispatch_probe(self, *args, **kw):
        if not getattr(self, "_probing_parent", False):
            return dispatch_probe(self, *args, **kw)
        adopted = self.keyframes.pop()
        try:
            return dispatch_probe(self, *args, **kw)
        finally:
            self.keyframes.append(adopted)

    def recorded_update_frame_stale(self, frame, *args, **kw):
        self.stale_frames = getattr(self, "stale_frames", []) + [frame.index]
        return update_frame_stale(self, frame, *args, **kw)

    mp.setattr(JSLAM, "_promote_dispatch", counted_promote_dispatch)
    mp.setattr(JSLAM, "_dispatch_probe", parent_dispatch_probe)
    mp.setattr(JSLAM, "_update_frame_stale", recorded_update_frame_stale)


def count_port_deferrals(mp):
    """Record the frames whose promotion the port deferred (`deferred`)."""
    promote_dispatch = TSLAM._promote_dispatch

    def counted(self, frame, *args, **kw):
        self.deferred = getattr(self, "deferred", []) + [frame.index]
        return promote_dispatch(self, frame, *args, **kw)

    mp.setattr(TSLAM, "_promote_dispatch", counted)


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
def orbit30():
    """30 orbit frames: promotions whose tracked registration succeeded,
    deferred under defer_promote."""
    return _render(jsyn.orbit_trajectory(30))


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


@pytest.mark.parametrize("n,lo,cap,want", [(1, 32, 512, 32), (31, 32, 512, 32),
                                             (32, 32, 512, 32), (33, 32, 512, 64),
                                             (300, 32, 512, 512), (513, 32, 512, 512),
                                             (33, 32, 48, 48), (129, 128, 4096, 256),
                                             (4096, 128, 4096, 4096)])
def test_ba_buckets(n, lo, cap, want):
    """BA's keyframe and edge buckets: the JAX package's, capped at the
    pose and edge capacity."""
    assert gcslam._next_bucket(n, lo, cap) == want


def test_ba_at_growing_buckets_matches_jax(loop, monkeypatch):
    """Floors of 4 keyframes and 8 edges, so the buckets grow over the loop:
    every BA of the port runs at the buckets of its keyframe and edge
    counts, identity rows past the keyframes and invalid edges past the
    store, and both packages make the same decisions, poses and final BA
    within this file's tolerances."""
    _, depths, grays, _, _ = loop
    config = CFG.replace(ba=dataclasses.replace(CFG.ba, kf_bucket_floor=4, edge_bucket_floor=8))
    counts, calls, optimize, run_ba = [], [], fastba.optimize, TSLAM._run_ba

    def counted_run_ba(self):
        counts.append((len(self.keyframes), self.n_edges))
        return run_ba(self)

    def recorded(poses, edges, n_kf, active, cfg):
        n_active = int(active.sum())
        calls.append(counts[-1] + (poses.shape[0], edges.s_w.shape[0], n_kf, n_active,
                                   bool(active[:n_active].all()),
                                   bool((poses[n_active:] == torch.eye(4)).all()),
                                   bool(edges.valid[counts[-1][1]:].any())))
        return optimize(poses, edges, n_kf, active, cfg)

    monkeypatch.setattr(TSLAM, "_run_ba", counted_run_ba)
    monkeypatch.setattr(fastba, "optimize", recorded)
    js, ts = _run_both(None, depths, grays, final_ba=True, config=config)
    _same_decisions(js, ts)
    n = ts.n_edges
    np.testing.assert_array_equal(ts.edges.valid[:n].numpy(), np.asarray(js.edges.valid)[:n])
    assert not ts.edges.valid[n:].any()
    np.testing.assert_allclose(np.stack(ts.last_ba_errors),
                               np.stack([np.asarray(e) for e in js.last_ba_errors]),
                               rtol=1e-3, atol=1e-3)
    rows = sorted({c[2] for c in calls})
    assert len(rows) >= 2 and rows[0] == 4, rows
    for n_kf, n_edges, n_rows, n_edge_rows, n_opt, n_active, head, identity, past in calls:
        assert n_rows == n_opt == gcslam._next_bucket(n_kf, 4, CFG.ba.max_keyframes)
        assert n_edge_rows == gcslam._next_bucket(n_edges, 8, CFG.ba.max_edges)
        assert n_active == n_kf and head and identity and not past


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


def _two_keyframes(depths, grays, config):
    """Both packages fed the frames until they hold a second keyframe;
    returns (js, ts, index of the next frame)."""
    js = JSLAM(config)
    ts = TSLAM(config, device="cpu", draw_fn=JaxKeyDraws())
    for i, (d, g) in enumerate(zip(depths, grays)):
        js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
        ts.update_frame(torch.tensor(g), torch.tensor(d), timestamp=float(i))
        if len(ts.keyframes) == 2:
            assert len(js.keyframes) == 2
            return js, ts, i + 1
    raise AssertionError("no second keyframe")


@pytest.mark.parametrize("branch", ["success", "chained", "held"])
def test_stale_keyframe_result_matches_jax(loop, branch):
    """A frame registered against keyframe 0 after keyframe 1 was adopted
    (the pipelined tracker's stale reference), in each branch of the
    stale path: the registration succeeded (the pose re-anchored by
    composition), failed with a frame-to-frame result (chained), or
    failed with none (the previous pose held). Then its re-registration
    against keyframe 1 (refine_stale), adopted when consumed."""
    _, depths, grays, _, _ = loop
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        js, ts, j = _two_keyframes(depths, grays, CFG)
        intr = ts.intr
        kp = extract_features(torch.tensor(grays[j]), torch.tensor(depths[j]), CFG.tracking, intr)

        def registered(kp_ref, seed):
            res = register_frames(kp_ref, kp, round_draws(jax.random.PRNGKey(seed), CFG.tracking,
                                                          CFG.tracking.max_features_pad),
                                  CFG.tracking, intr)
            return res, res.stats.numpy()

        res, vs_kf1 = registered(ts.frames[ts.keyframes[1].frame_index].keypoints, 5)
        _, vs_prev = registered(ts._prev_kp, 6)
        assert vs_kf1[0] > 0.5 and vs_prev[0] > 0.5
        # a successful registration against keyframe 0: the one against
        # keyframe 1 carried into keyframe 0's frame
        vs_kf0 = vs_kf1.copy()
        vs_kf0[5:21] = (np.linalg.inv(ts.keyframe_pose_peek(0)) @ ts.keyframe_pose_peek(1)
                        @ vs_kf1[5:21].reshape(4, 4)).reshape(-1)
        failed = np.zeros(21, np.float32)
        stats, stats_ff = {"success": (vs_kf0, None), "chained": (failed, vs_prev),
                           "held": (failed, failed)}[branch]
        prev_rel = ts.frames[-1].rel_to_keyframe.copy()
        # `res` only marks the result as given: with its stats passed, neither reads it
        jf = js.update_frame(jnp.asarray(grays[j]), jnp.asarray(depths[j]), timestamp=float(j),
                             res=res, res_kf_slot=0, stats=stats, stats_ff=stats_ff)
        tf = ts.update_frame(torch.tensor(grays[j]), torch.tensor(depths[j]),
                             timestamp=float(j), res=res, res_kf_slot=0, stats=stats,
                             stats_ff=stats_ff)
        assert ts.stale_frames == js.stale_frames == [j]
        assert tf.keyframe_slot == jf.keyframe_slot == 1 and not tf.is_keyframe
        assert tf.tracking_success == jf.tracking_success == (branch != "held")
        assert ts.fail_count == js.fail_count
        np.testing.assert_allclose(tf.rel_to_keyframe, jf.rel_to_keyframe, atol=POSE_TOL)
        want = {"success": np.linalg.inv(ts.keyframe_pose_peek(1)) @ ts.keyframe_pose_peek(0)
                @ vs_kf0[5:21].reshape(4, 4),
                "chained": prev_rel @ vs_prev[5:21].reshape(4, 4), "held": prev_rel}[branch]
        np.testing.assert_allclose(tf.rel_to_keyframe, want, atol=1e-5)
        if branch == "success":
            np.testing.assert_allclose(want, vs_kf1[5:21].reshape(4, 4), atol=1e-5)
        assert ts.refine_dispatched == js.refine_dispatched == 1
        ts.consume_pending_refine(force=True)
        js.consume_pending_refine(force=True)
        assert ts.refine_adopted == js.refine_adopted == 1
        assert tf.tracking_success and jf.tracking_success
        np.testing.assert_allclose(tf.rel_to_keyframe, jf.rel_to_keyframe, atol=POSE_TOL)
        np.testing.assert_allclose(ts.trajectory(), js.trajectory(), atol=POSE_TOL, rtol=0)


@pytest.fixture(scope="module")
def deferred(orbit30):
    """Both packages on the orbit with deferred promotion."""
    poses, depths, grays = orbit30
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        count_port_deferrals(mp)
        js, ts = _run_both(poses, depths, grays, final_ba=True, config=DEFER)
    return js, ts


def test_deferred_promotion_matches_jax(deferred, orbit30):
    js, ts = deferred
    _same_decisions(js, ts)
    assert ts.deferred == js.deferred and len(ts.deferred) >= 2
    n = ts.n_edges
    np.testing.assert_array_equal(ts.edges.kf_i[:n].numpy(), np.asarray(js.edges.kf_i)[:n])
    np.testing.assert_array_equal(ts.edges.kf_j[:n].numpy(), np.asarray(js.edges.kf_j)[:n])
    np.testing.assert_array_equal(ts.edges.valid[:n].numpy(), np.asarray(js.edges.valid)[:n])
    assert ts._pending_promote is None and js._pending_promote is None
    assert ttum.ate_rmse(ts.trajectory(), orbit30[0]) < 0.02


def test_jax_deferred_probe_adds_self_edges(deferred, orbit30):
    """ROADMAP fault 16: the JAX package's deferred probe dispatches after
    the new keyframe is adopted, so its candidate 0 is that keyframe: the
    tracked registration goes in as an edge from the keyframe to itself,
    and the superseded keyframe is ranked as any other candidate. The
    port's edges never join a keyframe to itself."""
    _, depths, grays = orbit30
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp, repair_fault16=False)
        js = JSLAM(DEFER)
        for i, (d, g) in enumerate(zip(depths, grays)):
            js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
    n = js.n_edges
    kf_i, kf_j = np.asarray(js.edges.kf_i)[:n], np.asarray(js.edges.kf_j)[:n]
    assert len(js.deferred) >= 2 and (kf_i == kf_j).sum() >= 2
    ts = deferred[1]
    assert (ts.edges.kf_i[:ts.n_edges] != ts.edges.kf_j[:ts.n_edges]).all()


def test_deferred_promotion_without_results_starts_an_origin(orbit30):
    """consume_pending_promote on a probe with no successful candidate
    (its tracked registration failed re-validation): the keyframe starts
    a new map origin and enters the DB, in both packages; tracking goes
    on through the multi-origin path alike."""
    _, depths, grays = orbit30
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        js = JSLAM(DEFER)
        ts = TSLAM(DEFER, device="cpu", draw_fn=JaxKeyDraws())
        for i, (d, g) in enumerate(zip(depths, grays)):
            js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
            ts.update_frame(torch.tensor(g), torch.tensor(d), timestamp=float(i))
            if ts._pending_promote is not None:
                break
        assert js._pending_promote is not None
        n = ts._pending_promote["n_cand"] * 25
        js._pending_promote["handle"] = LandedFetch(jnp.zeros(n))
        ts._pending_promote["handle"] = tfetch.fetch_async(torch.zeros(n))
        kf = ts._pending_promote["kf_slot"]
        rows = len(ts.db)
        js.consume_pending_promote()
        ts.consume_pending_promote()
        assert ts.origin_count == js.origin_count == 2
        assert ts.keyframes[kf].origin_index == js.keyframes[kf].origin_index == 1
        fr = ts.frames[ts.keyframes[kf].frame_index]
        assert not fr.tracking_success and fr.origin_index == 1
        assert len(ts.db) == len(js.db) == rows + 1
        for k in range(i + 1, min(i + 7, len(depths))):
            js.update_frame(jnp.asarray(grays[k]), jnp.asarray(depths[k]), timestamp=float(k))
            ts.update_frame(torch.tensor(grays[k]), torch.tensor(depths[k]), timestamp=float(k))
        _same_decisions(js, ts)
        assert [f.origin_index for f in ts.frames] == [f.origin_index for f in js.frames]


def test_ba_poses_pending_until_read_as_in_jax(orbit30):
    """After a BA both packages hold its poses pending: keyframe_pose_peek
    returns the poses BA started from, the first read of `poses` adopts
    BA's, and a keyframe adopted meanwhile keeps its own pose."""
    _, depths, grays = orbit30
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        js = JSLAM(CFG)
        ts = TSLAM(CFG, device="cpu", draw_fn=JaxKeyDraws())
        for i, (d, g) in enumerate(zip(depths, grays)):
            js.update_frame(jnp.asarray(g), jnp.asarray(d), timestamp=float(i))
            ts.update_frame(torch.tensor(g), torch.tensor(d), timestamp=float(i))
            if len(ts.keyframes) == 3:
                break
    assert ts._poses_pending is not None and js._poses_pending is not None
    n = len(ts.keyframes)
    before = np.stack([ts.keyframe_pose_peek(s) for s in range(n)])
    np.testing.assert_allclose(before, np.stack([js.keyframe_pose_peek(s) for s in range(n)]),
                               atol=POSE_TOL)
    extra = np.eye(4, dtype=np.float32)
    extra[:3, 3] = (1.0, 2.0, 3.0)
    ts._promote_keyframe(ts.frames[-1], ts.frames[-1].keypoints, extra)
    after = ts.poses[:n + 1].copy()
    np.testing.assert_allclose(after[:n], js.poses[:n], atol=POSE_TOL)
    assert np.abs(after[:n] - before).max() > 1e-6          # BA moved the keyframes
    np.testing.assert_array_equal(after[n], extra)
    assert ts._poses_pending is None
    np.testing.assert_array_equal(np.stack([ts.keyframe_pose_peek(s) for s in range(n + 1)]),
                                  after)


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
