"""The map's lifecycle in the port: TSDFVolume's GC, observation
retraction and local-frame depth passes against the JAX package's
volume, and the ChunkStreamer (as tests/test_streaming_eval.py and
tests/test_streaming_pipeline.py hold the JAX one).

Both volumes integrate the same rendered frames (tiny_test_config, the
JAX package's renderer) with the same slot order, so rows, observation
tables and freed slots line up slot for slot. Tolerances: rows as
tests/test_torch_slice.py (1e-4; colour 1e-2), quality rtol 1e-4 /
atol 1e-2. The local frames' drift reintegration is held against two
JAX passes, -1 at the old poses then +1 at the new (each with one sign,
where JAX's batched pass is right): the port's single pass sums the
same terms, and differs only where the sequential passes reset a voxel
whose weight fell to 0 between them and by the 1e-4 regulariser of the
running average (sdf 1e-4). The last test shows JAX fault 17 (an
offloaded chunk exported with a mesh its rows no longer hold) and the
port's repair.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.core import se3 as jse3
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_torch.fusion.chunkmap import TSDFVolume as TVolume
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline
from texturefusion_torch.fusion.streaming import ChunkStreamer

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
ROW_TOL = (1e-4, 1e-4, 1e-2, 1e-4)


def _rows(vol):
    s = vol.active_slots()
    return [np.asarray(a)[s] if not isinstance(a, torch.Tensor) else a.numpy()[s]
            for a in vol.batch]


def _same_volumes(tv, jv, sdf_atol=1e-4):
    np.testing.assert_array_equal(tv.used, jv.used)
    np.testing.assert_array_equal(tv.ids[tv.used], jv.ids[jv.used])
    for t, j, atol, name in zip(_rows(tv), _rows(jv), (sdf_atol,) + ROW_TOL[1:],
                                ("sdf", "weight", "color", "color_count")):
        np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=name)
    jq, jm = jv.obs_arrays()
    tq, tm = tv.obs_arrays()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-2)


@pytest.fixture(scope="module")
def lifecycle():
    """Keyframe 0 (colour) and three local frames, depth only, in both
    packages, then one GC pass."""
    poses = jsyn.orbit_trajectory(6)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    q = np.random.default_rng(0).random(depths[0].shape).astype(np.float32)
    jv, tv = JVolume(CFG), TVolume(CFG, device="cpu")
    jslots = jv.integrate_frame(jnp.asarray(depths[0]), jnp.asarray(rgbs[0]), jnp.asarray(q),
                                jnp.asarray(poses[0]), keyframe_id=0)
    tslots = tv.integrate_frame(torch.as_tensor(depths[0]), torch.as_tensor(rgbs[0]),
                                torch.as_tensor(q), poses[0], keyframe_id=0)
    np.testing.assert_array_equal(tslots, jslots)
    local = [1, 3, 5]
    jv.integrate_local_depths([jnp.asarray(depths[i]) for i in local],
                              [poses[i] for i in local], jslots)
    tv.integrate_local_depths([torch.as_tensor(depths[i]) for i in local],
                              [poses[i] for i in local], tslots)
    n_before = tv.n_active()
    freed = (tv.gc_new_chunks(), jv.gc_new_chunks())
    return dict(jv=jv, tv=tv, slots=tslots, poses=poses, depths=depths, rgbs=rgbs, q=q,
                local=local, freed=freed, n_before=n_before)


def test_local_depths_and_gc_match_jax(lifecycle):
    tv, jv = lifecycle["tv"], lifecycle["jv"]
    tfreed, jfreed = lifecycle["freed"]
    np.testing.assert_array_equal(np.sort(tfreed), np.sort(jfreed))
    assert 0 < len(tfreed) < lifecycle["n_before"]
    assert not tv.new_since_gc
    _same_volumes(tv, jv)
    # every chunk left holds weight; the freed slots were reset
    w = tv.batch.weight
    assert bool((w[tv.active_slots()].abs().sum(-1) > 0).all())
    assert bool((w[tfreed] == 0).all()) and bool((tv.batch.sdf[tfreed] == 999.0).all())
    assert tv.free == jv.free


def test_retraction_and_reintegration_match_jax(lifecycle):
    """retract_observations, then reintegrate_frame over the recorded slots
    at a pose moved 1 cm, in both packages."""
    tv, jv = lifecycle["tv"], lifecycle["jv"]
    d, c, q, p0 = (lifecycle[k] for k in ("depths", "rgbs", "q", "poses"))
    d, c, p0 = d[0], c[0], p0[0]
    slots = tv.active_slots()
    assert sorted(tv.retract_observations(0)) == sorted(jv.retract_observations(0))
    assert not tv.obs_arrays()[1][:, 0].any()
    p1 = p0.copy()
    p1[:3, 3] += np.asarray([0.01, 0.0, 0.0], np.float32)
    jv.reintegrate_frame(jnp.asarray(d), jnp.asarray(c), jnp.asarray(q), jnp.asarray(p0),
                         jnp.asarray(p1), 0, slots)
    tv.reintegrate_frame(torch.as_tensor(d), torch.as_tensor(c), torch.as_tensor(q), p0, p1, 0,
                         slots)
    jv.flush_observations()
    _same_volumes(tv, jv)
    assert tv.obs_arrays()[1][:, 0].any()


def test_local_depth_reintegration_matches_sequential_jax_passes(lifecycle):
    tv, jv = lifecycle["tv"], lifecycle["jv"]
    local, poses, depths = lifecycle["local"], lifecycle["poses"], lifecycle["depths"]
    slots = tv.active_slots()
    corr = np.asarray(jse3.se3_exp(jnp.asarray([0.006, 0, 0, 0, 0.0087, 0], jnp.float32)))
    old = [poses[i] for i in local]
    new = [(p @ corr).astype(np.float32) for p in old]
    before = tv.batch.sdf.clone()
    jd = [jnp.asarray(depths[i]) for i in local]
    jv.integrate_local_depths(jd, old, slots, sign=-1.0)
    jv.integrate_local_depths(jd, new, slots, sign=1.0)
    tv.reintegrate_local_depths([torch.as_tensor(depths[i]) for i in local], old, new, slots)
    _same_volumes(tv, jv, sdf_atol=1e-4)
    assert int((tv.batch.sdf != before).sum()) > 1000


def _same_obs(t: dict, j: dict) -> None:
    """The same {key: quality} entries, qualities to the summation order."""
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], dict):
            _same_obs(t[k], j[k])
        else:
            assert t[k] == pytest.approx(j[k], rel=1e-4, abs=1e-2)


def test_observation_table_views_match_jax(lifecycle):
    tv, jv = lifecycle["tv"], lifecycle["jv"]
    _same_obs(tv.observations, jv.observations)
    q, m = tv.obs_arrays()
    s = int(np.nonzero(m[:, 0] & (q[:, 0] > 0))[0][0])
    _same_obs(tv.obs_row(s), jv.obs_row(s))
    snap = tv.observations
    for vol in (tv, jv):
        vol.poison_observation(s, 0)
        vol.poison_observation(s, 7)           # absent: nothing to poison
    _same_obs(tv.obs_row(s), jv.obs_row(s))
    assert tv.obs_row(s).get(0) == np.float32(-1e11) and 7 not in tv.obs_row(s)
    tv.observations = snap
    assert tv.observations == snap
    tv.set_obs_row(s, {2: 0.5})
    assert tv.obs_row(s) == {2: 0.5}
    tv.observations = snap


def test_streaming_offload_restore_roundtrip():
    """tests/test_streaming_eval.py's round trip: radius 0 offloads every
    chunk; five restored chunks come back with their rows and
    observation entries, into fresh slots."""
    intr = jcam.Intrinsics.from_config(CFG.camera)
    pose = jsyn.orbit_trajectory(1)[0]
    depth, rgb = jsyn.render_frame(jsyn.BoxRoomScene(), intr, jnp.asarray(pose))
    vol = TVolume(CFG, device="cpu")
    vol.integrate_frame(torch.as_tensor(np.array(depth)), torch.as_tensor(np.array(rgb)),
                        torch.zeros(depth.shape), pose, keyframe_id=0)
    n0 = vol.n_active()
    by_id = {tuple(vol.ids[s].tolist()): (vol.batch.sdf[s].clone(), vol.obs_row(s))
             for s in vol.active_slots().tolist()}
    streamer = ChunkStreamer(vol, max_resident=8, offload_radius=0.0)
    assert streamer.offload_cold(pose[:3, 3]) == n0
    assert vol.n_active() == 0 and streamer.n_cold() == n0
    assert not vol.obs_arrays()[1].any()
    restore = np.asarray(list(by_id)[:5], np.int32)
    assert streamer.ensure_resident(restore) == 5
    assert vol.n_active() == 5 and streamer.n_cold() == n0 - 5
    for cid in map(tuple, restore.tolist()):
        s = vol.slot_of[cid]
        assert torch.equal(vol.batch.sdf[s], by_id[cid][0])
        assert vol.obs_row(s) == by_id[cid][1]
        assert s in vol.dirty_mesh
    assert streamer.ensure_resident(restore) == 0          # resident already
    assert (streamer.offloaded, streamer.restored) == (n0, 5)


def test_streaming_budget_evicts_farthest():
    vol = TVolume(CFG, device="cpu")
    slots = vol.allocate(np.asarray([[i, 0, 0] for i in range(20)], np.int32))
    vol.batch.weight[torch.as_tensor(slots)] = 1.0
    streamer = ChunkStreamer(vol, max_resident=10, offload_radius=1e9)
    assert streamer.offload_cold(np.zeros(3)) == 10
    assert sorted(vol.ids[vol.active_slots()][:, 0].tolist()) == list(range(10))


@pytest.fixture(scope="module")
def sweep():
    """tests/test_streaming_pipeline.py's sweep (24 orbit frames over 2.4
    rad, a 1 m offload radius, a 0.05 MB keyframe budget) with 60 resident
    chunks at most, below the ~120 the sweep holds, so chunks go cold;
    and the same frames without streaming."""
    cfg = CFG.replace(tsdf=dataclasses.replace(
        CFG.tsdf, max_resident_chunks=60, streaming_radius=1.0,
        keyframe_device_budget_mb=0.05))
    intr = jcam.Intrinsics.from_config(cfg.camera)
    poses = jsyn.orbit_trajectory(24, angle_range=2.4)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), intr, poses)
    pipe = ReconstructionPipeline(cfg, device="cpu")
    peaks = []
    for i in range(len(poses)):
        pipe.process_frame(depths[i], rgbs[i], timestamp=float(i))
        peaks.append(pipe.volume.n_active())
    pipe.finish()
    ref = ReconstructionPipeline(CFG, device="cpu")
    for i in range(len(poses)):
        ref.process_frame(depths[i], rgbs[i], timestamp=float(i))
    ref.finish()
    return cfg, pipe, peaks, ref


def test_streaming_pipeline_bounds_residency(sweep):
    cfg, pipe, peaks, ref = sweep
    assert pipe.streamer is not None and pipe.volume.streamer is pipe.streamer
    assert max(peaks) <= cfg.tsdf.max_resident_chunks + cfg.tsdf.max_update_chunks
    assert pipe.streamer.offloaded > 0
    released = [st for st in pipe.kf_states.values()
                if st.integrated and st.depth_weight is None]
    assert released, "no keyframe released its refinement weight"
    verts = pipe.mesher.full_mesh()[0]
    assert len(verts) > 200 and np.isfinite(verts).all()
    assert pipe.mesher.frozen
    n_ref = len(ref.mesher.full_mesh()[0])
    assert abs(len(verts) - n_ref) <= 0.05 * n_ref, (len(verts), n_ref)


def test_streaming_pipeline_keeps_offloaded_surface(sweep):
    """Frozen meshes of chunks that are still offloaded export beside the
    resident ones; a restored chunk exports from its new slot only."""
    _, pipe, _, _ = sweep
    frozen_out = [cid for cid in pipe.mesher.frozen if pipe.volume.slot_of.get(cid) is None]
    n_resident = sum(len(m[0]) for m in pipe.mesher.meshes.values())
    n_frozen = sum(len(pipe.mesher.frozen[c][0]) for c in frozen_out)
    assert len(pipe.mesher.full_mesh()[0]) == n_resident + n_frozen
    assert set(frozen_out) <= set(pipe.streamer.cold)


def _offload_restore_empty_offload(vol, mesher, streamer, to_dev, depth, rgb, pose):
    """The pipeline's streaming steps on one frame's chunks: integrate and
    mesh; offload them all and freeze their meshes (as fusion_cycle does);
    restore them and de-integrate the frame, so that their meshes empty;
    offload and freeze again. Returns the vertex counts exported after
    the first offload and after the second."""
    slots = vol.integrate_frame(to_dev(depth), to_dev(rgb), to_dev(np.zeros_like(depth)),
                                to_dev(pose), keyframe_id=0)
    ids = vol.ids[slots].copy()
    counts = []
    for step in range(2):
        mesher.update_meshes()
        before = vol.active_slots()
        streamer.offload_cold(pose[:3, 3])
        mesher.freeze(np.setdiff1d(before, vol.active_slots()))
        counts.append(len(mesher.full_mesh()[0]))
        if step == 0:
            assert streamer.ensure_resident(ids) == len(ids)
            vol.integrate_frame(to_dev(depth), to_dev(rgb), to_dev(np.zeros_like(depth)),
                                to_dev(pose), keyframe_id=0, sign=-1.0,
                                slots=vol.lookup(ids))
    return counts


def test_an_emptied_chunk_offloaded_again_exports_no_old_mesh_fault_17():
    """JAX fault 17: IncrementalMesher.freeze stores the mesh of each
    offloaded chunk that has one, and leaves the entry of one that has
    none. A chunk offloaded with a mesh, restored, emptied (a drift
    reintegration de-integrates it) and offloaded again is exported with
    the mesh of its first offload. The port's mesher forgets a chunk's
    frozen mesh when the streamer restores it (ChunkStreamer.on_restore,
    wired by ReconstructionPipeline)."""
    from texturefusion_tpu.fusion.mesher import IncrementalMesher as JMesher
    from texturefusion_tpu.fusion.streaming import ChunkStreamer as JStreamer
    from texturefusion_torch.fusion.mesher import IncrementalMesher as TMesher
    pose = jsyn.orbit_trajectory(1)[0]
    depth, rgb = (np.array(a) for a in jsyn.render_frame(jsyn.BoxRoomScene(), JI,
                                                         jnp.asarray(pose)))
    jv = JVolume(CFG)
    jm, js = JMesher(jv), JStreamer(jv, max_resident=8, offload_radius=0.0)
    jv.streamer = js
    jcounts = _offload_restore_empty_offload(jv, jm, js, jnp.asarray, depth, rgb, pose)
    tv = TVolume(CFG, device="cpu")
    tm, ts = TMesher(tv), ChunkStreamer(tv, max_resident=8, offload_radius=0.0)
    tv.streamer, ts.on_restore = ts, tm.thaw
    tcounts = _offload_restore_empty_offload(tv, tm, ts, torch.as_tensor, depth, rgb, pose)
    assert jcounts[0] == tcounts[0] > 1000
    assert jcounts[1] == jcounts[0]          # the old meshes, exported again
    assert tcounts[1] == 0
    pipe = ReconstructionPipeline(CFG.replace(tsdf=dataclasses.replace(
        CFG.tsdf, max_resident_chunks=8)), device="cpu")
    assert pipe.streamer.on_restore == pipe.mesher.thaw
