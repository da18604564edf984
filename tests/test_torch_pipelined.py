"""The pipelined tracker of ReconstructionPipeline, port against JAX.

ParallelConfig(pipelined_tracking=True, pipeline_depth=1, 2, 3,
async_fusion=False, async_cycle_results=False) with deferred promotion and
the stale-frame refinement (TrackingConfig defaults) on 20 orbit frames of
tests/test_pipeline.py's scene at the tiny config: frames dispatched before
a promotion is decided finalize against the superseded keyframe, their
re-registrations are adopted, promotions consume their probe a frame
later. Both sides take the same draws (tests/test_torch_draws.py); on the
JAX side every fetch lands at once and its deferred probe is repaired as
the port's (test_torch_gcslam.jax_pipelined_tracker, ROADMAP fault 16),
and both discover chunks at integration, the JAX side at synced poses
(test_torch_pipeline.JaxSyncPipeline, PortSyncPipeline), with the TPU
kernel's bilateral step. Tolerances of test_torch_pipeline.py's run with local frames: the
same keyframes, origins, stale-finalized frames and refinement counts,
every frame position within 1 mm, the same chunk ids, weight mass within
0.1% and vertex counts within 1%.

The ride bound is the port's own: with fetches that never land, frames
wait up to max(depth + 1, pipeline_max_ride) in flight and finalize in
order; flush_tracking drains them.

The port's fusion cycle adopts a pending BA round before its drift pass,
where the JAX package's peeks; the last test runs the JAX pipeline both
ways and shows what the peek changes on this sequence.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_draws import JaxKeyDraws, tracked2_draws
from test_torch_gcslam import count_port_deferrals, jax_pipelined_tracker
from test_torch_pipeline import JI, SCENE, JaxSyncPipeline, PortSyncPipeline, _pallas_bilateral
from texturefusion_tpu.config import ParallelConfig as JParallelConfig
from texturefusion_tpu.config import tiny_test_config as jax_tiny_config
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_torch.config import ParallelConfig, tiny_test_config
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline as TPipeline
from texturefusion_torch.io import tum
from texturefusion_torch.utils import async_fetch as tfetch

torch.set_num_threads(2)

N_FRAMES = 20


def _config(depth):
    return jax_tiny_config().replace(parallel=JParallelConfig(
        async_fusion=False, pipelined_tracking=True, pipeline_depth=depth,
        async_cycle_results=False))


@pytest.fixture(scope="module")
def seq():
    poses = jsyn.orbit_trajectory(N_FRAMES)
    depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
    return poses, depths, rgbs


@pytest.fixture(scope="module", params=[1, 2, 3])
def runs(request, seq):
    """Both packages at one pipeline_depth."""
    cfg = _config(request.param)
    _, depths, rgbs = seq
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        count_port_deferrals(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            jp = JaxSyncPipeline(cfg)
            for i, (d, c) in enumerate(zip(depths, rgbs)):
                jp.process_frame(jnp.asarray(d), jnp.asarray(c), timestamp=float(i))
            jp.finish()
        finally:
            jax.clear_caches()
        tp = PortSyncPipeline(cfg, device="cpu", draw_fn=JaxKeyDraws(),
                       frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                            cfg.tracking))
        for i, (d, c) in enumerate(zip(depths, rgbs)):
            tp.process_frame(d, c, timestamp=float(i))
        tp.finish()
    return jp, tp


def _ids(vol):
    return {tuple(r) for r in vol.ids[vol.used].tolist()}


def test_pipelined_tracker_matches_jax(runs, seq):
    jp, tp = runs
    js, ts = jp.slam, tp.slam
    assert [f.is_keyframe for f in ts.frames] == [f.is_keyframe for f in js.frames]
    assert len(ts.keyframes) == len(js.keyframes) >= 4
    assert [f.origin_index for f in ts.frames] == [f.origin_index for f in js.frames]
    assert ts.origin_count == js.origin_count == 1
    assert ts.n_edges == js.n_edges
    assert tp.stats["frames"] == jp.stats["frames"] == N_FRAMES
    assert tp.stats["keyframes"] == jp.stats["keyframes"]
    assert ts.deferred == js.deferred and len(ts.deferred) >= 2
    assert ts.stale_frames == js.stale_frames and ts.stale_frames
    assert ts.refine_dispatched == js.refine_dispatched
    assert ts.refine_adopted == js.refine_adopted >= 1
    dist = np.abs(tp.trajectory()[:, :3, 3] - jp.trajectory()[:, :3, 3]).max()
    assert dist <= 1e-3, dist
    assert tum.ate_rmse(tp.trajectory(), np.stack(seq[0])) < 0.03


def test_pipelined_map_matches_jax(runs):
    jp, tp = runs
    assert _ids(tp.volume) == _ids(jp.volume)
    assert tp.stats["reintegrations"] == jp.stats["reintegrations"]
    tv, jv = tp.volume, jp.volume
    s = tv.active_slots()
    tw, jw = tv.batch.weight.numpy()[s], np.asarray(jv.batch.weight)[s]
    assert abs(tw.sum() - jw.sum()) <= 1e-3 * jw.sum()
    nt, nj = len(tp.mesher.full_mesh()[0]), len(jp.mesher.full_mesh()[0])
    assert nj > 500 and abs(nt - nj) <= 0.01 * nj, (nt, nj)


class NeverLanded:
    """A port fetch handle that reports its copy in flight until read."""

    def __init__(self, tensor):
        self._handle = tfetch.DeviceFetch(tensor)

    def done(self):
        return False

    def result(self):
        return self._handle.result()


@pytest.mark.parametrize("ride", [0, 5])
def test_frames_ride_up_to_the_bound_and_finalize_in_order(ride, monkeypatch):
    depth, n = 2, 16
    bound = max(depth + 1, ride)
    cfg = tiny_test_config().replace(parallel=ParallelConfig(
        pipeline_depth=depth, pipeline_max_ride=ride))
    _, packed = chip_smoke._orbit_frames(cfg, n)
    monkeypatch.setattr(tfetch, "fetch_async", NeverLanded)
    pipe = TPipeline(cfg, device="cpu")
    for i, frame in enumerate(packed):
        pipe.process_frame(frame, timestamp=float(i))
        assert len(pipe._inflight) <= bound, i
        assert [f.timestamp for f in pipe.slam.frames] == list(range(i + 1 - len(pipe._inflight)))
    # the frames dispatched before the first keyframe have no stats to wait
    # for; past them, frames ride to the bound
    assert len(pipe._inflight) == pipe.max_inflight == bound
    assert pipe.rode >= 1
    pipe.flush_tracking()
    assert not pipe._inflight
    assert [f.timestamp for f in pipe.slam.frames] == list(range(n))
    assert pipe.slam.stale_frames
    # refinements that never land wait for a forced consume; deferred
    # promotions are consumed after their 3-frame grace
    assert pipe.slam._pending_refine and pipe.slam.refine_adopted == 0
    assert pipe.slam.promote_late >= 1
    pipe.finish()
    assert not pipe.slam._pending_refine and pipe.slam._pending_promote is None
    assert pipe.slam.refine_adopted >= 1


class JaxPeekingPipeline(JaxSyncPipeline):
    """JaxSyncPipeline whose fusion cycle reads the BA poses as the JAX
    package's own does: the drift pass peeks them, a pending BA round is
    not adopted first. Records, at each cycle, the largest translation (m)
    between an integrated keyframe's peeked pose and its pending BA pose:
    the correction that the peek leaves to a later cycle."""

    def fusion_cycle(self, finished_slot):
        self._disco_prefetch.clear()
        missed = 0.0
        pending = self.slam._poses_pending
        if pending is not None:
            handle, bucket, n_kf = pending
            fetched = np.asarray(handle.result()).reshape(bucket, 4, 4)[:n_kf]
            slots = [s for s, st in self.kf_states.items() if st.integrated and s < n_kf]
            if slots:
                missed = float(np.abs(fetched[slots, :3, 3]
                                      - self.slam._poses_np[slots, :3, 3]).max())
        self.missed = getattr(self, "missed", []) + [missed]
        super(JaxSyncPipeline, self).fusion_cycle(finished_slot)


def test_drift_pass_sync_against_the_jax_peek(seq):
    """The port's fusion cycle adopts a pending BA round before its drift
    pass; the JAX package's drift pass peeks (ROADMAP, deviations). Both
    JAX variants at depth 2, same draws: the tracking is the same; the
    peek leaves a BA correction of an integrated keyframe to a later cycle
    (6.1e-6 m here, under the drift pass's threshold), so on this sequence
    the maps are the same too."""
    cfg = _config(2)
    _, depths, rgbs = seq
    pipes = []
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        for cls in (JaxSyncPipeline, JaxPeekingPipeline):
            jax.clear_caches()
            try:
                p = cls(cfg)
                for i, (d, c) in enumerate(zip(depths, rgbs)):
                    p.process_frame(jnp.asarray(d), jnp.asarray(c), timestamp=float(i))
                p.finish()
            finally:
                jax.clear_caches()
            pipes.append(p)
    synced, peeked = pipes
    np.testing.assert_array_equal(synced.trajectory(), peeked.trajectory())
    assert 0 < max(peeked.missed) < 1e-4, peeked.missed
    assert synced.stats["reintegrations"] == peeked.stats["reintegrations"]
    assert _ids(synced.volume) == _ids(peeked.volume)
    np.testing.assert_array_equal(np.asarray(synced.volume.batch.weight),
                                  np.asarray(peeked.volume.batch.weight))
    np.testing.assert_array_equal(np.asarray(synced.volume.batch.sdf),
                                  np.asarray(peeked.volume.batch.sdf))
