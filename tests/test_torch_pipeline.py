"""ReconstructionPipeline, port against the JAX package.

The sequence of tests/test_pipeline.py (tiny_test_config, 10 orbit
frames rendered by the JAX package) goes through both pipelines in the
synchronous settings: defer_promote=False and ParallelConfig(
async_fusion=False, pipelined_tracking=False, async_cycle_results=False).
Both sides take the same random draws (the JAX key path replayed,
tests/test_torch_draws.py) and discover a keyframe's chunks when they
integrate it: the JAX side is a test-side subclass whose discovery
prefetch is cleared before each fusion cycle and never refreshed, and
whose BA poses are synced first (the port has no pending pose fetch).
Its bilateral step is the TPU kernel in interpret mode, which the port
follows (ROADMAP fault 3.2), patched in for this file only.

Tolerances: the same keyframe decisions; every frame position within
1 mm; the same chunk ids at the same slots; rows within 1e-5 on at
least 99.9% of the voxels that either side observed (colour 1e-3, the
accumulators run in byte scale): the port's bilateral filter differs
from the TPU kernel's by up to 2e-6 m, which can move a voxel at the
edge of the band or of a pixel (1 of ~7,400 here); the same observation
entries, quality rtol 1e-4 / atol 1e-2; vertex counts within 0.2% (a
flipped voxel moves a vertex or two). The row-for-row run keeps
local_frames_per_keyframe = 0 (the JAX package's batched local-frame
pass mis-counts touched voxels where signed weights cancel, ROADMAP
fault 6); the run with local frames compares trajectories, keyframes and
chunk sets exactly and the map on aggregates.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws, tracked2_draws
from texturefusion_tpu.config import ParallelConfig, tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.fusion import dynamics as jdyn
from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline as JPipeline
from texturefusion_tpu.io import ply as jply
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import pallas_kernels
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops.simplify import simplify_by_clustering as jsimplify
from texturefusion_torch.fusion import dynamics as tdyn
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline as TPipeline
from texturefusion_torch.io import ply as tply
from texturefusion_torch.io import tum
from texturefusion_torch.ops.simplify import simplify_by_clustering as tsimplify

torch.set_num_threads(2)

BASE = tiny_test_config()
SYNC = ParallelConfig(async_fusion=False, pipelined_tracking=False, async_cycle_results=False)
CFG = BASE.replace(tracking=dataclasses.replace(BASE.tracking, defer_promote=False),
                   parallel=SYNC)
CFG0 = CFG.replace(tsdf=dataclasses.replace(CFG.tsdf, local_frames_per_keyframe=0))
JI = jcam.Intrinsics.from_config(CFG.camera)
SCENE = jsyn.BoxRoomScene()
N_FRAMES = 10


class JaxSyncPipeline(JPipeline):
    """The JAX pipeline discovering each keyframe's chunks at integration,
    at synced poses."""

    def _refresh_disco_prefetch(self):
        pass

    def fusion_cycle(self, finished_slot):
        self._disco_prefetch.clear()
        self.slam._sync_poses()
        super().fusion_cycle(finished_slot)


def _pallas_bilateral(depth, radius=4, sigma_space=4.5, sigma_range=0.03):
    return pallas_kernels.bilateral_filter_pallas(depth, radius=radius,
                                                  sigma_space=sigma_space,
                                                  sigma_range=sigma_range)


@pytest.fixture(scope="module")
def seq():
    poses = jsyn.orbit_trajectory(N_FRAMES)
    depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
    return poses, depths, rgbs


def _port(cfg, depths, rgbs, **kw):
    pipe = TPipeline(cfg, device="cpu", draw_fn=JaxKeyDraws(),
                     frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                          cfg.tracking), **kw)
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        pipe.process_frame(d, c, timestamp=float(i))
    pipe.finish()
    return pipe


def _jax(cfg, depths, rgbs):
    pipe = JaxSyncPipeline(cfg)
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        pipe.process_frame(jnp.asarray(d), jnp.asarray(c), timestamp=float(i))
    pipe.finish()
    return pipe


@pytest.fixture(scope="module")
def runs(seq):
    """Both packages, without and with local frames; the JAX side with the
    TPU kernel's bilateral step (the jit caches are cleared around the
    patch so that no other test sees it)."""
    _, depths, rgbs = seq
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            out = {cfg_name: (_jax(cfg, depths, rgbs), _port(cfg, depths, rgbs))
                   for cfg_name, cfg in (("rows", CFG0), ("locals", CFG))}
        finally:
            jax.clear_caches()
    return out


def _same_tracking(j, t, poses):
    assert [f.is_keyframe for f in t.slam.frames] == [f.is_keyframe for f in j.slam.frames]
    assert len(t.slam.keyframes) == len(j.slam.keyframes) >= 1
    assert t.stats["frames"] == j.stats["frames"] == N_FRAMES
    assert t.stats["keyframes"] == j.stats["keyframes"]
    dist = np.abs(t.trajectory()[:, :3, 3] - j.trajectory()[:, :3, 3]).max()
    assert dist <= 1e-3, dist
    assert tum.ate_rmse(t.trajectory(), np.stack(poses)) < 0.02


def _ids(vol):
    return {tuple(r) for r in vol.ids[vol.used].tolist()}


def test_pipeline_matches_jax_row_for_row(runs, seq):
    jp, tp = runs["rows"]
    _same_tracking(jp, tp, seq[0])
    jv, tv = jp.volume, tp.volume
    assert tv.n_active() > 10
    np.testing.assert_array_equal(tv.used, jv.used)
    np.testing.assert_array_equal(tv.ids[tv.used], jv.ids[jv.used])
    s = tv.active_slots()
    jrows = [np.asarray(a)[s] for a in jv.batch]
    trows = [a.numpy()[s] for a in tv.batch]
    seen = (trows[1] > 0) | (jrows[1] > 0)
    assert seen.sum() > 1000
    for t, j, (rtol, atol), name in zip(trows, jrows, ((1e-5, 1e-5), (0, 1e-5), (1e-5, 1e-3),
                                                       (0, 1e-5)),
                                        ("sdf", "weight", "color", "color_count")):
        close = np.isclose(t, j, rtol=rtol, atol=atol)
        if t.ndim == 3:
            close = close.all(-1)
        assert close[seen].mean() >= 0.999, (name, close[seen].mean())
    jq, jm = jv.obs_arrays()
    tq, tm = tv.obs_arrays()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-2)
    assert tm.sum() > 0
    nt, nj = len(tp.mesher.full_mesh()[0]), len(jp.mesher.full_mesh()[0])
    assert nj > 500 and abs(nt - nj) <= 0.002 * nj, (nt, nj)


def test_pipeline_with_local_frames_matches_jax(runs, seq):
    jp, tp = runs["locals"]
    _same_tracking(jp, tp, seq[0])
    assert _ids(tp.volume) == _ids(jp.volume)
    assert any(st.local_depths for st in tp.kf_states.values())
    tv, jv = tp.volume, jp.volume
    s = tv.active_slots()
    tw, jw = tv.batch.weight.numpy()[s], np.asarray(jv.batch.weight)[s]
    assert abs(tw.sum() - jw.sum()) <= 1e-3 * jw.sum()
    nt, nj = len(tp.mesher.full_mesh()[0]), len(jp.mesher.full_mesh()[0])
    assert abs(nt - nj) <= 0.01 * nj
    poses = seq[0]
    verts = tp.mesher.full_mesh()[0] @ poses[0][:3, :3].T + poses[0][:3, 3]
    err = np.abs(np.asarray(SCENE.sdf(jnp.asarray(verts))))
    assert np.median(err) < CFG.tsdf.voxel_resolution


def _bad_pose_run(make):
    """tests/test_pipeline.py:102-150: keyframe 0 integrated 17 cm off,
    then its pose corrected and one more fusion cycle."""
    pipe, feed = make()
    feed(pipe)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] += np.asarray([0.12, -0.06, 0.1], np.float32)
    pipe.slam.poses[0] = bad
    pipe.fusion_cycle(0)
    st = pipe.kf_states[0]
    assert st.integrated
    np.testing.assert_allclose(st.integrated_pose, bad)
    pipe.slam.poses[0] = np.eye(4, dtype=np.float32)
    pipe.fusion_cycle(0)
    assert pipe.stats["reintegrations"] >= 1
    np.testing.assert_allclose(st.integrated_pose, np.eye(4, dtype=np.float32))
    ref, feed = make()
    feed(ref)
    ref.fusion_cycle(0)
    return pipe, ref


def test_bad_pose_reintegration_both_packages(seq):
    _, depths, rgbs = seq

    def port():
        return TPipeline(CFG, device="cpu"), lambda p: p.process_frame(depths[0], rgbs[0])

    def jaxp():
        return JPipeline(CFG), lambda p: p.process_frame(jnp.asarray(depths[0]),
                                                         jnp.asarray(rgbs[0]))

    out = {}
    for name, make in (("port", port), ("jax", jaxp)):
        fixed, ref = _bad_pose_run(make)
        v_fix, v_ref = fixed.mesher.full_mesh()[0], ref.mesher.full_mesh()[0]
        assert len(v_ref) > 50
        np.testing.assert_allclose(v_fix.mean(0), v_ref.mean(0), atol=0.02)
        np.testing.assert_allclose(np.percentile(v_fix, [5, 95], axis=0),
                                   np.percentile(v_ref, [5, 95], axis=0), atol=0.05)
        w_fix = float(np.abs(np.asarray(fixed.volume.batch.weight)).sum())
        w_ref = float(np.abs(np.asarray(ref.volume.batch.weight)).sum())
        assert abs(w_fix - w_ref) / max(w_ref, 1.0) < 0.05
        out[name] = fixed
    tp, jp = out["port"], out["jax"]
    assert tp.stats["reintegrations_reuse"] == 1
    # ROADMAP Queue 3 fault 7: JAX's reuse pass writes into the slots that
    # GC released after the first integration (their rows are not reset
    # when a later allocation hands them out); the port re-creates those
    # chunks by id, and GC frees them again, reset, where they stay empty
    jw_rows = np.abs(np.asarray(jp.volume.batch.weight)[:-1]).sum(-1)
    ghosts = (~jp.volume.used) & (jw_rows > 0)
    assert ghosts.any()
    t_free = torch.as_tensor(~tp.volume.used)
    assert float(tp.volume.batch.weight[:-1][t_free].abs().sum()) == 0.0
    # the two corrected maps, JAX's released slots included: weight mass
    # within 3% (each is within 5% of its own correct-pose map above)
    tw = float(tp.volume.batch.weight.abs().sum())
    assert abs(tw - jw_rows.sum()) <= 0.03 * jw_rows.sum(), (tw, jw_rows.sum())


def test_async_fusion_matches_sync():
    """The fusion thread (async_fusion=True) on 30 orbit frames, which
    promote keyframes and so run fusion cycles on the worker: the same
    trajectory and keyframes as the synchronous pipeline, and a map that
    passes tests/test_pipeline.py's checks and agrees with the
    synchronous one in vertex count (within 2%: a cycle reads its
    keyframe's pose when it runs, which a later BA may already have
    moved)."""
    poses = jsyn.orbit_trajectory(30)
    depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
    runs = {}
    for name, on in (("sync", False), ("async", True)):
        cfg = CFG.replace(parallel=dataclasses.replace(SYNC, async_fusion=on))
        pipe = TPipeline(cfg, device="cpu")
        for i, (d, c) in enumerate(zip(depths, rgbs)):
            pipe.process_frame(d, c, timestamp=float(i))
        if on:
            assert pipe._fusion_future is not None      # a cycle went to the worker
        pipe.finish()
        pipe.close()
        runs[name] = pipe
    sync, pipe = runs["sync"], runs["async"]
    assert pipe.stats["keyframes"] == sync.stats["keyframes"] >= 3
    np.testing.assert_allclose(pipe.trajectory(), sync.trajectory(), atol=1e-6, rtol=0)
    assert tum.ate_rmse(pipe.trajectory(), np.stack(poses)) < 0.02
    verts, n_sync = pipe.mesher.full_mesh()[0], len(sync.mesher.full_mesh()[0])
    assert len(verts) > 500 and abs(len(verts) - n_sync) <= 0.02 * n_sync
    verts_w = verts @ poses[0][:3, :3].T + poses[0][:3, 3]
    err = np.abs(np.asarray(SCENE.sdf(jnp.asarray(verts_w))))
    assert np.median(err) < CFG.tsdf.voxel_resolution


def test_exports(runs, tmp_path):
    """export_mesh (welded and raw), save_trajectory (the JAX writer's
    text), save_stats."""
    jp, tp = runs["locals"]
    raw = tp.export_mesh(str(tmp_path / "raw.ply"), weld=False)
    n = tp.export_mesh(str(tmp_path / "mesh.ply"))
    assert 0 < n < raw == len(tp.mesher.full_mesh()[0])
    v, f, c, nrm = tply.load_ply(str(tmp_path / "mesh.ply"))
    assert len(v) == n and len(f) > 0 and c.shape == (n, 3)
    tp.save_trajectory(str(tmp_path / "traj.txt"))
    lines = open(tmp_path / "traj.txt").read().strip().splitlines()
    assert len(lines) == N_FRAMES and all(len(ln.split()) == 8 for ln in lines)
    jply.save_trajectory_tum(str(tmp_path / "jtraj.txt"),
                             [f.timestamp for f in tp.slam.frames], tp.trajectory())
    assert open(tmp_path / "traj.txt").read() == open(tmp_path / "jtraj.txt").read()
    tp.save_stats(str(tmp_path / "stats"))
    stat = open(tmp_path / "stats" / "stat.txt").read()
    assert "frames: 10" in stat and "chunks_active" in stat and "preprocess" in stat
    chunk = open(tmp_path / "stats" / "chunk.txt").read().split()
    assert chunk[0] == "chunks_created" and int(chunk[3]) == tp.volume.n_active()
    mem = tp.memory_stats()
    assert mem["chunks_active"] == tp.volume.n_active() and mem["device_tsdf_mb"] > 0


def test_trajectory_writer_matches_jax(tmp_path):
    """save_trajectory_tum on random poses, rotations of every quaternion
    branch: the same text as the JAX package's writer."""
    rng = np.random.default_rng(0)
    poses = []
    for k in range(12):
        q = rng.normal(size=4)
        q[k % 4] += 3.0                      # a dominant component of each kind
        q /= np.linalg.norm(q)
        x, y, z, w = q
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        p = np.eye(4, dtype=np.float32)
        p[:3, :3], p[:3, 3] = rot, rng.normal(size=3)
        poses.append(p)
    ts = np.linspace(0, 1.1, len(poses))
    tply.save_trajectory_tum(str(tmp_path / "t.txt"), ts, poses)
    jply.save_trajectory_tum(str(tmp_path / "j.txt"), ts, poses)
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()


def test_dynamics_matches_jax():
    rng = np.random.default_rng(1)
    from texturefusion_tpu.core import se3 as jse3
    xi = rng.normal(0, 0.05, (16, 6)).astype(np.float32)
    a = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x))) for x in xi])
    b = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x * 0.9))) for x in xi])
    np.testing.assert_array_equal(tdyn.pose_drift_costs(a, b), jdyn.pose_drift_costs(a, b))
    for k in (0, 1, 2, 8):
        costs = rng.exponential(2e-4, k).astype(np.float32)
        for m in (1, 2, 4):
            assert tdyn.select_keyframes_to_update(costs, m) == \
                jdyn.select_keyframes_to_update(costs, m)
    assert tdyn.select_keyframes_to_update(np.full(5, 1e-6), 3) == []


def test_simplify_matches_jax(runs):
    _, tp = runs["locals"]
    v, f, c, n = tp.mesher.full_mesh()
    for cell in (0.0125, 0.05):
        got = tsimplify(v, f, cell, c, n)
        want = jsimplify(v, f, cell, c, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tsimplify(v[:0], f[:0], 0.01)[0].shape == (0, 3)


def test_pipeline_entry_point_defaults_and_refusals():
    """The sharded TSDF was refused; it is ported: tsdf_sharded on the CPU
    shards the rows over its eight virtual devices, as the JAX package
    shards over its eight host devices (the sharded run's parity is
    tests/test_torch_parallel_tsdf.py). Texturing a sharded pool was
    refused too; it is ported: TexturedPipeline builds the 8-shard volume,
    with texture state of capacity + 1 rows, one for each pool row (the
    textured sharded run's parity is tests/test_torch_textured_sharded.py)."""
    import inspect

    from texturefusion_torch.fusion.pipeline import TexturedPipeline
    for cls in (TPipeline, TexturedPipeline):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    sharded = CFG.replace(parallel=dataclasses.replace(SYNC, tsdf_sharded=True))
    pipe = TPipeline(sharded, device="cpu")
    assert pipe.volume.sharded and pipe.volume.mesh.size == 8
    assert (pipe.volume.cfg.capacity + 1) % 8 == 0
    textured = TexturedPipeline(sharded, device="cpu")
    textured.texture._ensure_state(textured.mesher)
    cap = textured.volume.cfg.capacity
    assert textured.volume.sharded and textured.volume.mesh.size == 8
    assert textured.texture._labels_dev.shape == (cap + 1,) == (textured.mesher.pool_rows.n_rows,)
    assert textured.texture._stats_dev.shape[0] == textured.texture._failed_dev.shape[0] == cap + 1
    assert os.path.basename(tply.__file__) == "ply.py"
