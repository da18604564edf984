"""The fusion-side deferrals, port against the JAX package.

The scenario: TexturedPipeline on 20 orbit frames of tests/test_pipeline.py's
scene at the tiny config with ParallelConfig(async_fusion=False,
pipeline_depth=2): the JAX package's defaults otherwise, so the cycle
results are consumed a cycle late (async_cycle_results), the discovery is
prefetched at each promotion, and the tracker is the default one. Both
sides take the same draws (tests/test_torch_draws.py) and see every fetch
landed at once (the port's CPU fetches land by themselves; on the JAX side
test_torch_gcslam.jax_pipelined_tracker, which also repairs its fault 16);
the JAX side runs the TPU kernel's bilateral step in interpret mode, and a
test-side subclass syncs its pending BA poses before each cycle, as the
port's cycle does (the JAX package's drift pass peeks them).

Tolerances of tests/test_torch_pipelined.py: the same keyframes, stale
frames and refinement counts, positions within 1 mm, the same chunk ids,
weight mass within 0.1%, vertex counts within 1%. The deferrals count
alike: prefetches used, deferred and missed, the deferred integrations by
slot and cycle, the chunk ids GC frees, the texture dispatches skipped.
The labels agree on >= 99% of the meshed chunks, as in
tests/test_torch_textured_pipeline.py's 11-frame run.

Unit tests, each against the JAX function: the mesh counts applied as a
ready prefix in dispatch order, never to a slot dropped after its remesh
(a handle that never lands); gc_consume's re-check (same chunk, no
observation, not integrated since) and its stale-generation re-probe;
retract_observations over queued entries; a prefetch gone stale (its
recorded pose moved past 0.75 of a chunk, as a BA correction would move
it) integrating a cycle later over the set discovered at the current
pose; a texture dispatch skipped while a cycle is pending, with its carry.
Eight CPU shards give the one-device run bit for bit, labels and exported
bytes included (tests/test_torch_textured_sharded.py's form).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws, tracked2_draws
from test_torch_gcslam import LandedFetch, jax_pipelined_tracker
from test_torch_pipeline import JI, SCENE, _pallas_bilateral
from texturefusion_tpu.config import ParallelConfig as JParallelConfig
from texturefusion_tpu.config import tiny_test_config as jax_tiny_config
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.fusion.mesher import IncrementalMesher as JMesher
from texturefusion_tpu.fusion.pipeline import TexturedPipeline as JTextured
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.texture.manager import TextureManager as JTexture
from texturefusion_tpu.utils import async_fetch as jfetch
from texturefusion_tpu.utils.stopwatch import STOPWATCH as JSTOPWATCH
from texturefusion_torch import TexturedPipeline
from texturefusion_torch.fusion.chunkmap import TSDFVolume as TVolume
from texturefusion_torch.fusion.mesher import IncrementalMesher as TMesher
from texturefusion_torch.io import tum
from texturefusion_torch.texture.manager import TextureManager as TTexture
from texturefusion_torch.utils import async_fetch as tfetch
from texturefusion_torch.utils.stopwatch import STOPWATCH as TSTOPWATCH

torch.set_num_threads(2)

N_FRAMES = 20
CFG = jax_tiny_config().replace(parallel=JParallelConfig(async_fusion=False, pipeline_depth=2))
N_STALE = 12          # frames of the stale-prefetch run: three keyframes
STALE_SLOT = 1        # the keyframe whose prefetch goes stale
DISCO_COUNTS = ("disco_pref_used", "disco_pref_defer", "disco_pref_miss")


def _record(pipe):
    """Log a pipeline's deferrals: the deferred integrations after each
    cycle, each keyframe integration (slot, sign, cycle), the chunk ids of
    each drop (GC here), the texture dispatches skipped."""
    pipe.log = {"deferred": [], "integrated": [], "freed": [], "skipped": 0}
    pipe.chunk_sets = {}
    drop, dispatch = pipe.mesher.drop, pipe.texture.update_dispatch

    def recorded_drop(slots):
        ids = pipe.volume.ids[np.atleast_1d(np.asarray(slots, np.int64))]
        pipe.log["freed"].append(sorted(map(tuple, ids.tolist())))
        drop(slots)

    def counted_dispatch(*a, **kw):
        pipe.log["skipped"] += pipe.texture._pending_cycle is not None
        return dispatch(*a, **kw)

    pipe.mesher.drop = recorded_drop
    pipe.texture.update_dispatch = counted_dispatch


class Logged:
    """The logging half of both sides' test pipelines; with `stale_slot`,
    that keyframe's recorded prefetch pose is moved 0.5 m before its cycle
    (what a BA correction past 0.75 of a chunk would do)."""

    stale_slot = None

    def _integrate_keyframe(self, st, sign, prefetched=None, **kw):
        self.log["integrated"].append((st.kf_slot, sign, len(self.log["deferred"])))
        super()._integrate_keyframe(st, sign, prefetched=prefetched, **kw)
        if sign > 0:    # the chunk ids integrated, before GC recycles any slot
            self.chunk_sets.setdefault(st.kf_slot, []).append(sorted(self._chunk_ids(st)))

    def _cycle(self, finished_slot):
        if finished_slot == self.stale_slot and finished_slot in self._disco_prefetch:
            pre, pose = self._disco_prefetch[finished_slot]
            moved = np.array(pose, copy=True)
            moved[:3, 3] += np.asarray([0.5, 0.0, 0.0], moved.dtype)
            self._disco_prefetch[finished_slot] = (pre, moved)
        super().fusion_cycle(finished_slot)
        self.log["deferred"].append(sorted(self._deferred_integration))


class JaxDeferred(Logged, JTextured):
    def __init__(self, config, stale_slot=None):
        super().__init__(config)
        self.stale_slot = stale_slot
        _record(self)

    def fusion_cycle(self, finished_slot):
        self.slam._sync_poses()         # the port's cycle adopts BA's pending poses
        self._cycle(finished_slot)

    def _chunk_ids(self, st):
        return map(tuple, self.volume.ids[st.integrated_slots].tolist())


class PortDeferred(Logged, TexturedPipeline):
    def __init__(self, config, stale_slot=None):
        super().__init__(config, device="cpu", draw_fn=JaxKeyDraws(),
                         frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                              config.tracking))
        self.stale_slot = stale_slot
        _record(self)

    def fusion_cycle(self, finished_slot):
        self._cycle(finished_slot)

    def _chunk_ids(self, st):
        return map(tuple, st.integrated_ids.tolist())


@pytest.fixture(scope="module")
def seq():
    poses = jsyn.orbit_trajectory(N_FRAMES)
    depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
    return poses, depths, rgbs


def _run_both(seq, n, stale_slot=None, cfg=CFG):
    """Both packages on the first n frames: (JAX pipeline, its counts,
    port pipeline, its counts)."""
    _, depths, rgbs = seq
    out = []
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            for cls, sw, arr in ((JaxDeferred, JSTOPWATCH, jnp.asarray),
                                 (PortDeferred, TSTOPWATCH, np.asarray)):
                sw.reset()
                pipe = cls(cfg, stale_slot=stale_slot)
                for i in range(n):
                    pipe.process_frame(arr(depths[i]), arr(rgbs[i]), timestamp=float(i))
                pipe.finish()
                out += [pipe, {k: sw.counts[k] for k in DISCO_COUNTS}]
        finally:
            jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def runs(seq):
    return _run_both(seq, N_FRAMES)


@pytest.fixture(scope="module")
def stale_runs(seq):
    return _run_both(seq, N_STALE, stale_slot=STALE_SLOT)


def _ids(vol):
    return {tuple(r) for r in vol.ids[vol.used].tolist()}


def _same_run(jp, tp, n):
    js, ts = jp.slam, tp.slam
    assert [f.is_keyframe for f in ts.frames] == [f.is_keyframe for f in js.frames]
    assert len(ts.keyframes) == len(js.keyframes) >= 3
    assert ts.stale_frames == js.stale_frames
    assert ts.refine_dispatched == js.refine_dispatched
    assert ts.refine_adopted == js.refine_adopted
    assert tp.stats["frames"] == jp.stats["frames"] == n
    dist = np.abs(tp.trajectory()[:, :3, 3] - jp.trajectory()[:, :3, 3]).max()
    assert dist <= 1e-3, dist
    assert _ids(tp.volume) == _ids(jp.volume)
    assert tp.stats["reintegrations"] == jp.stats["reintegrations"]
    s = tp.volume.active_slots()
    tw, jw = tp.volume.batch.weight.numpy()[s], np.asarray(jp.volume.batch.weight)[s]
    assert abs(tw.sum() - jw.sum()) <= 1e-3 * jw.sum()
    nt, nj = len(tp.mesher.full_mesh()[0]), len(jp.mesher.full_mesh()[0])
    assert nj > 500 and abs(nt - nj) <= 0.01 * nj, (nt, nj)
    assert tp.log == jp.log
    assert tp.chunk_sets == jp.chunk_sets


def test_deferred_pipeline_matches_jax(runs, seq):
    jp, jcounts, tp, tcounts = runs
    _same_run(jp, tp, N_FRAMES)
    assert tcounts == jcounts
    assert jcounts["disco_pref_used"] >= 3
    assert any(tp.log["freed"])               # GC freed chunks, a cycle late
    assert not tp._deferred_integration and tp._gc_pending is None
    assert not tp.volume._pending_obs and not tp.mesher._pending_counts
    assert tp.texture._pending_cycle is None
    assert tum.ate_rmse(tp.trajectory(), np.stack(seq[0])) < 0.03


def _labels_by_id(pipe):
    ids = pipe.volume.ids
    return {tuple(ids[s].tolist()): t.label for s, t in pipe.texture.chunk_tex.items()
            if pipe.mesher.tcount[s] > 0}


def test_deferred_labels_match_jax(runs):
    jp, _, tp, _ = runs
    t, j = _labels_by_id(tp), _labels_by_id(jp)
    common = sorted(t.keys() & j.keys())
    assert len(common) >= 0.99 * len(j) and len(common) > 20
    assert np.mean([t[c] == j[c] for c in common]) >= 0.99
    assert len({t[c] for c in common}) >= 2
    assert tp.texture.kf_stack.present == jp.texture.kf_stack.present


def test_a_stale_prefetch_integrates_a_cycle_later(stale_runs, seq):
    """The keyframe whose prefetch went stale is not integrated in its own
    cycle: a discovery at its current pose is dispatched, and the next
    cycle integrates it over that set, before its drift pass."""
    jp, jcounts, tp, tcounts = stale_runs
    _same_run(jp, tp, N_STALE)
    assert tcounts == jcounts and jcounts["disco_pref_defer"] == 1
    deferred = [i for i, d in enumerate(tp.log["deferred"]) if STALE_SLOT in d]
    assert len(deferred) == 1
    first = [c for s, sign, c in tp.log["integrated"] if s == STALE_SLOT and sign > 0][0]
    assert first == deferred[0] + 1
    assert tp.kf_states[STALE_SLOT].integrated and tp.chunk_sets[STALE_SLOT]


class PosesOfDeferral(PortDeferred):
    """Records the stale keyframe's pose at the cycle that defers it, at
    the consume that integrates it, and the pose it was integrated at; a
    BA correction of 2 cm along x lands just before that consume."""

    def _consume_deferred_integration(self, force=False):
        if self.stale_slot in self._deferred_integration:
            self.slam.poses[self.stale_slot][:3, 3] += np.asarray([0.02, 0.0, 0.0], np.float32)
        super()._consume_deferred_integration(force=force)

    def fusion_cycle(self, finished_slot):
        super().fusion_cycle(finished_slot)
        if finished_slot == self.stale_slot and finished_slot in self._deferred_integration:
            self.deferral_pose = np.array(self._deferred_integration[finished_slot][1])

    def _integrate_keyframe(self, st, sign, prefetched=None, **kw):
        first = st.kf_slot == self.stale_slot and sign > 0 and not hasattr(self, "first_pose")
        if first:
            self.pose_at_consume = self.slam.keyframe_pose(st.kf_slot)
        super()._integrate_keyframe(st, sign, prefetched=prefetched, **kw)
        if first:
            self.first_pose = np.array(st.integrated_pose)


def test_a_deferred_integration_runs_at_its_discovery_pose(seq):
    """Fault 22 (the JAX package's, repaired in the port): a keyframe whose
    stale prefetch was replaced by a discovery at its pose then is
    integrated a cycle later over that set, so at that pose too. The JAX
    package integrates it at the keyframe's pose at the consume, which a
    BA between the two cycles may have moved, over a set discovered for
    the other pose."""
    _, depths, rgbs = seq
    tp = PosesOfDeferral(CFG, stale_slot=STALE_SLOT)
    for i in range(N_STALE):
        tp.process_frame(np.asarray(depths[i]), np.asarray(rgbs[i]), timestamp=float(i))
    tp.finish()
    assert np.abs(tp.pose_at_consume - tp.deferral_pose).max() > 0.01
    np.testing.assert_array_equal(tp.first_pose, tp.deferral_pose)


def test_a_stale_prefetch_in_a_synchronous_cycle_fault_19(seq):
    """Fault 19: with async_cycle_results=False the JAX package's cycle
    defers a stale prefetch's keyframe as the deferred cycle does, but
    only the deferred cycle consumes deferred integrations, so that
    keyframe is never integrated, not even by finish(). The port's
    synchronous cycle integrates it at once, over the chunks discovered at
    its current pose."""
    cfg = CFG.replace(parallel=dataclasses.replace(CFG.parallel, async_cycle_results=False))
    jp, jcounts, tp, tcounts = _run_both(seq, 8, stale_slot=0, cfg=cfg)
    assert jcounts["disco_pref_defer"] == tcounts["disco_pref_defer"] == 1
    assert not jp.kf_states[0].integrated and 0 in jp._deferred_integration
    assert all(jp.kf_states[s].integrated for s in jp.kf_states if s > 0)
    assert tp.kf_states[0].integrated and not tp._deferred_integration
    assert [c for s, sign, c in tp.log["integrated"] if s == 0 and sign > 0] == [0]


class TNever:
    """A port fetch handle whose copy never lands until it is read."""

    def __init__(self, value):
        self._handle = tfetch.fetch_async(value)

    def done(self):
        return False

    def result(self):
        return self._handle.result()


class JNever(LandedFetch):
    def done(self):
        return False


def _volumes():
    cfg = jax_tiny_config()
    return TVolume(cfg, device="cpu"), JVolume(cfg)


def test_counts_apply_as_a_ready_prefix_and_never_to_a_dropped_slot():
    (tv, jv) = _volumes()
    tm, jm = TMesher(tv), JMesher(jv)
    rng = np.random.default_rng(0)
    batches = [np.asarray(s, np.int64) for s in ([1, 2, 3], [2, 4], [3, 5, 6])]
    counts = [(rng.integers(1, 50, len(s)).astype(np.int32),
               rng.integers(1, 80, len(s)).astype(np.int32)) for s in batches]
    for m, landed, never, conv in ((tm, tfetch.fetch_async, TNever, torch.as_tensor),
                                   (jm, LandedFetch, JNever, jnp.asarray)):
        m._pending_counts = [
            (seq, s, (never if seq == 2 else landed)((conv(vc), conv(tc))))
            for seq, (s, (vc, tc)) in enumerate(zip(batches, counts), 1)]
        m._seq = 3
        assert m.consume_counts(ready_only=True) == 3       # the prefix before the never-landed
        assert len(m._pending_counts) == 2
        m.drop([5])                                         # after the third remesh's dispatch
        m.consume_counts()
    np.testing.assert_array_equal(tm.vcount, jm.vcount)
    np.testing.assert_array_equal(tm.tcount, jm.tcount)
    want = np.zeros_like(tm.vcount)
    for s, (vc, _) in zip(batches, counts):
        want[s] = vc
    want[5] = 0
    np.testing.assert_array_equal(tm.vcount, want)


def _integrate(tv, jv, seq, i, kf):
    poses, depths, rgbs = seq
    d, c, pose = depths[i], rgbs[i], np.asarray(poses[i], np.float32)
    q = np.full(d.shape, 0.5, np.float32)
    tv.integrate_frame(torch.as_tensor(d), torch.as_tensor(c), torch.as_tensor(q), pose,
                       keyframe_id=kf)
    jv.integrate_frame(jnp.asarray(d), jnp.asarray(c), jnp.asarray(q), jnp.asarray(pose),
                       keyframe_id=kf)


def test_gc_consume_rechecks_and_reprobes_as_jax(seq, monkeypatch):
    monkeypatch.setattr(jfetch, "fetch_async", LandedFetch)
    tv, jv = _volumes()
    ids = np.asarray([[x, 7, 7] for x in range(6)], np.int32)
    new_id = np.asarray([[9, 9, 9]], np.int32)
    for vol in (tv, jv):
        vol.new_since_gc.clear()
        slots = vol.allocate(ids)
        vol.set_obs_row(int(slots[0]), {0: 1.0})            # observed: never a candidate
        pend = vol.gc_dispatch()
        assert pend["cand"].tolist() == slots[1:].tolist()
        never = dict(pend, occ=JNever(jnp.zeros(len(slots) - 1)) if vol is jv else
                     TNever(torch.zeros(len(slots) - 1)))
        assert vol.gc_consume(never) is never               # in flight: handed back
        vol.release(slots[1:2])                             # recycled for another chunk
        vol.allocate(new_id)
        vol._mark_dirty(slots[2:3])                         # integrated since the probe
        vol.set_obs_row(int(slots[3]), {1: 0.5})            # observed since the probe
        pend["defer_ok"] = False
        vol.freed = vol.gc_consume(pend)
        assert vol.freed.tolist() == slots[4:].tolist()
        assert int(slots[2]) in vol.new_since_gc
    assert tv.freed.tolist() == jv.freed.tolist()
    assert tv.new_since_gc == jv.new_since_gc
    np.testing.assert_array_equal(tv.used, jv.used)


def test_retract_applies_that_keyframes_queued_entries(seq, monkeypatch):
    monkeypatch.setattr(jfetch, "fetch_async", LandedFetch)
    tv, jv = _volumes()
    _integrate(tv, jv, seq, 0, kf=0)
    _integrate(tv, jv, seq, 1, kf=1)
    assert len(tv._pending_obs) == len(jv._pending_obs) >= 2
    touched = tv.retract_observations(0)
    assert sorted(touched) == sorted(jv.retract_observations(0)) and touched
    assert [p[2] for p in tv._pending_obs] == [p[2] for p in jv._pending_obs]
    assert {p[2] for p in tv._pending_obs} == {1}
    assert not tv._obs_mask[:, 1].any()                     # keyframe 1's still queued
    tq, tm = tv.obs_arrays()
    jq, jm = jv.obs_arrays()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-2)
    assert tm[:, 1].any() and not tm[:, 0].any()


def test_texture_dispatch_skipped_while_a_cycle_is_pending():
    cfg = jax_tiny_config()
    for tm, never in ((TTexture(cfg, device="cpu"), TNever(torch.zeros(1))),
                      (JTexture(cfg), JNever(jnp.zeros(1)))):
        tm._carry = {1}
        tm._pending_cycle = {"out": never}
        tm.update_dispatch(None, None, {}, newest_kf=0, remeshed={5, 7})
        tm.update_consume(force=False)
        assert tm._pending_cycle["out"] is never and tm._carry == {1, 5, 7}


@pytest.fixture(scope="module")
def shard_pair(seq):
    """The port alone on 11 frames with the deferrals, on 8 CPU shards and
    on one device."""
    _, depths, rgbs = seq
    out = []
    for sharded in (True, False):
        cfg = CFG.replace(parallel=dataclasses.replace(CFG.parallel, tsdf_sharded=sharded,
                                                       n_devices=8))
        pipe = PortDeferred(cfg)
        for i in range(11):
            pipe.process_frame(depths[i], rgbs[i], timestamp=float(i))
        pipe.finish()
        out.append(pipe)
    return out


def test_eight_shards_equal_one_device(shard_pair, tmp_path):
    shd, ref = shard_pair
    assert shd.volume.sharded and shd.volume.mesh.size == 8 and not ref.volume.sharded
    np.testing.assert_array_equal(shd.trajectory(), ref.trajectory())
    assert shd.log == ref.log
    cap = ref.volume.cfg.capacity
    np.testing.assert_array_equal(shd.volume.used[:cap], ref.volume.used)
    np.testing.assert_array_equal(shd.mesher.vcount[:cap], ref.mesher.vcount[:cap])
    tex = {s: (t.label, t.wrong, t.uv16) for s, t in shd.texture.chunk_tex.items()}
    rtex = {s: (t.label, t.wrong, t.uv16) for s, t in ref.texture.chunk_tex.items()}
    assert tex.keys() == rtex.keys() and len(tex) > 20
    for s in tex:
        assert tex[s][:2] == rtex[s][:2]
        assert (tex[s][2] is None) == (rtex[s][2] is None)
        if tex[s][2] is not None:
            np.testing.assert_array_equal(tex[s][2], rtex[s][2])
    for p, name in ((shd, "shd"), (ref, "ref")):
        p.export_textured(str(tmp_path / name))
    for ext in ("obj", "mtl", "png"):
        got = (tmp_path / "shd" / f"model.{ext}").read_bytes()
        assert got and got == (tmp_path / "ref" / f"model.{ext}").read_bytes(), ext
