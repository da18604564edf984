"""utils/checkpoint.py: save, load and resume the port's pipeline.

- Exact resume: tiny_test_config on 16 orbit frames (five keyframes, loop
  closure), with two keyframe poses moved by a few centimetres at fixed
  fusion cycles (one before the checkpoint, one after), so that drift
  reintegration runs on both sides of it; GC frees slots on both sides
  too. Saved at frame 8 and continued in a fresh pipeline, the run equals
  the uninterrupted one exactly: poses, TSDF rows, slot map, keyframes,
  edges and the reintegration counts (the resumed run reuses the recorded
  chunk set, where a checkpoint without it, as the JAX package writes,
  takes the full path and draws other RANSAC hypotheses: faults 11, 12).
- The assertions of tests/test_checkpoint_cli.py's two checkpoint tests,
  on the port.
- A JAX checkpoint (the JAX package's synchronous pipeline, 8 frames)
  carried into the port by utils/convert.restore_jax_checkpoint: the TSDF
  rows and slot map equal the JAX ones, and the port resumes from it.
  The same run confirms faults 11 and 12 in the JAX checkpoint.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import CFG as SYNC_CFG
from test_torch_pipeline import JaxSyncPipeline
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.utils import checkpoint as jcheckpoint
from texturefusion_torch.config import tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline
from texturefusion_torch.io import synthetic, tum
from texturefusion_torch.ops.preprocess import pack_frame
from texturefusion_torch.utils import checkpoint, convert

torch.set_num_threads(2)

CFG = tiny_test_config()
INTR = cam.Intrinsics.from_config(CFG.camera)
N, CUT = 16, 8
# finished keyframe slot -> its pose's move before that fusion cycle (m)
MOVES = {1: (0.03, -0.01, 0.02), 3: (-0.02, 0.02, 0.01)}


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_trajectory(N, angle_range=3.0)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), INTR, poses,
                                             device="cpu")
    return [pack_frame((d * CFG.camera.depth_scale).astype(np.uint16),
                       (c * 255).astype(np.uint8)) for d, c in zip(depths, rgbs)]


class Moved(ReconstructionPipeline):
    """Moves keyframe 0's pose before the fusion cycles of MOVES, as a BA
    correction would: the next cycle reintegrates the keyframes it
    drifted. Depends only on the slot, so both runs move alike."""

    def fusion_cycle(self, finished_slot):
        if finished_slot in MOVES:
            self.slam.poses[0][:3, 3] += np.asarray(MOVES[finished_slot], np.float32)
        super().fusion_cycle(finished_slot)


def _feed(pipe, packed, start=0):
    for i, f in enumerate(packed, start):
        pipe.process_frame(f, timestamp=float(i), host_packed=f)


def _resumed(frames, tmp_path, drop=()):
    pipe = Moved(CFG, device="cpu")
    _feed(pipe, frames[:CUT])
    path = str(tmp_path / "mid.ckpt")
    checkpoint.save_pipeline(pipe, path)
    if drop:
        # what the JAX package's checkpoint lacks (faults 11 and 12)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files if k not in drop}
        with open(path + ".meta", "rb") as f:
            meta = pickle.load(f)
        for st in meta["kf_states"].values():
            st.pop("integrated_ids", None)
        np.savez(path, **arrays)
    resumed = Moved(CFG, device="cpu")
    checkpoint.load_pipeline(resumed, path) if not drop else \
        checkpoint.restore_pipeline_state(resumed, arrays, meta)
    _feed(resumed, frames[CUT:], CUT)
    resumed.finish()
    return pipe, resumed


@pytest.fixture(scope="module")
def whole(frames):
    pipe = Moved(CFG, device="cpu")
    _feed(pipe, frames)
    pipe.finish()
    return pipe


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())
    for x, y in zip(a.volume.batch, b.volume.batch):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.volume.ids, b.volume.ids)
    np.testing.assert_array_equal(a.volume.used, b.volume.used)
    assert a.volume.slot_of == b.volume.slot_of
    assert len(a.slam.keyframes) == len(b.slam.keyframes)
    assert a.slam.n_edges == b.slam.n_edges
    for x, y in zip(a.slam.edges, b.slam.edges):
        assert torch.equal(x, y)
    assert a.stats == b.stats


def test_resume_equals_the_uninterrupted_run(frames, whole, tmp_path):
    before, resumed = _resumed(frames, tmp_path)
    st = whole.stats
    assert st["keyframes"] >= 5 and whole.slam.n_edges >= 5
    # reintegration on both sides of the checkpoint, GC too
    assert before.stats["reintegrations_reuse"] >= 1
    assert st["reintegrations_reuse"] > before.stats["reintegrations_reuse"]
    assert before.volume.released
    _assert_same_run(whole, resumed)


def test_a_checkpoint_without_the_chunk_sets_and_draws_diverges(frames, whole, tmp_path):
    """The JAX package's checkpoint content (no integrated chunk sets, no
    generator state): the resumed run takes the full reintegration path
    where the uninterrupted run reuses the chunk set (fault 11), and its
    RANSAC draws differ (fault 12)."""
    _, resumed = _resumed(frames, tmp_path, drop=("gen_state",))
    assert resumed.stats["reintegrations_full"] > whole.stats["reintegrations_full"]
    assert not np.array_equal(resumed.trajectory(), whole.trajectory())


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint_cli.py::test_checkpoint_roundtrip on the port."""
    poses = synthetic.orbit_trajectory(6)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), INTR, poses,
                                             device="cpu")
    pipe = ReconstructionPipeline(CFG, device="cpu")
    for i in range(4):
        pipe.process_frame(depths[i], rgbs[i], timestamp=float(i))
    ckpt = str(tmp_path / "state.ckpt")
    checkpoint.save_pipeline(pipe, ckpt)
    assert sorted(os.listdir(tmp_path)) == ["state.ckpt", "state.ckpt.meta"]
    with open(ckpt + ".meta", "rb") as f:
        meta = pickle.load(f)

    def no_tensors(x):
        if isinstance(x, dict):
            return all(no_tensors(v) for v in x.values()) and all(no_tensors(k) for k in x)
        if isinstance(x, (list, tuple, set)):
            return all(no_tensors(v) for v in x)
        return not isinstance(x, torch.Tensor)

    assert no_tensors(meta)

    pipe2 = ReconstructionPipeline(CFG, device="cpu")
    checkpoint.load_pipeline(pipe2, ckpt)
    assert torch.equal(pipe.volume.batch.sdf, pipe2.volume.batch.sdf)
    assert pipe2.volume.slot_of == pipe.volume.slot_of
    assert len(pipe2.slam.frames) == len(pipe.slam.frames)
    assert pipe2.slam.n_edges == pipe.slam.n_edges
    assert torch.equal(pipe.slam._row_to_slot, pipe2.slam._row_to_slot)
    assert torch.equal(pipe.slam.kp_db.kp.desc, pipe2.slam.kp_db.kp.desc)
    assert bool(pipe2.slam.kp_db.kp.valid.any())
    for i in range(4, 6):
        pipe2.process_frame(depths[i], rgbs[i], timestamp=float(i))
    pipe2.finish()
    assert pipe2.stats["frames"] == 6
    traj = pipe2.trajectory()
    assert traj.shape == (6, 4, 4) and np.isfinite(traj).all()
    meta.pop("format")
    with open(ckpt + ".meta", "wb") as f:
        pickle.dump(meta, f)
    with pytest.raises(ValueError, match="format"):
        checkpoint.load_pipeline(ReconstructionPipeline(CFG, device="cpu"), ckpt)


def test_checkpoint_resume_loop_closure(frames, tmp_path):
    """tests/test_checkpoint_cli.py::test_checkpoint_resume_loop_closure on
    the port: keyframes promote after the resume, register against the
    restored keyframes (new edges), and tracking holds one map origin."""
    pipe = ReconstructionPipeline(CFG, device="cpu")
    _feed(pipe, frames[:CUT])
    ckpt = str(tmp_path / "mid.ckpt")
    checkpoint.save_pipeline(pipe, ckpt)
    kf_before, edges_before = len(pipe.slam.keyframes), pipe.slam.n_edges
    pipe2 = ReconstructionPipeline(CFG, device="cpu")
    checkpoint.load_pipeline(pipe2, ckpt)
    _feed(pipe2, frames[CUT:], CUT)
    pipe2.finish()
    assert len(pipe2.slam.keyframes) > kf_before
    assert pipe2.slam.n_edges > edges_before
    assert pipe2.slam.origin_count == 1


def test_streaming_map_is_refused(tmp_path):
    cfg = CFG.replace(tsdf=dataclasses.replace(CFG.tsdf, max_resident_chunks=64))
    with pytest.raises(NotImplementedError, match="streaming"):
        checkpoint.save_pipeline(ReconstructionPipeline(cfg, device="cpu"),
                                 str(tmp_path / "s.ckpt"))
    assert not os.listdir(tmp_path)


def _numpy(x):
    """A JAX checkpoint's meta as the port reads it: every jax array
    converted with np.asarray."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    if isinstance(x, jax.Array):
        return np.asarray(x)
    return x


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    poses = jsyn.orbit_trajectory(N, angle_range=3.0)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), INTR, poses)
    jpipe = JaxSyncPipeline(SYNC_CFG)
    for i in range(CUT):
        jpipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]), timestamp=float(i))
    path = str(tmp_path / "jax.ckpt")
    jcheckpoint.save_pipeline(jpipe, path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    with open(path + ".meta", "rb") as f:
        meta = _numpy(pickle.load(f))

    # JAX fault 11: the chunk set each keyframe was integrated over is not
    # saved; fault 12: nor the draw key, the frame counter or the
    # previous frame's keypoints
    integrated = [s for s, st in jpipe.kf_states.items() if st.integrated]
    assert integrated and all(jpipe.kf_states[s].integrated_slots is not None
                              for s in integrated)
    assert all("integrated_slots" not in st for st in meta["kf_states"].values())
    jres = JaxSyncPipeline(SYNC_CFG)
    jcheckpoint.load_pipeline(jres, path)
    assert all(jres.kf_states[s].integrated_slots is None for s in integrated)
    assert not np.array_equal(np.asarray(jres.slam._key), np.asarray(jpipe.slam._key))
    assert jres._dispatch_count == 0 and jpipe._dispatch_count == CUT
    assert jres._kp_prev is None and jpipe._kp_prev is not None

    port = ReconstructionPipeline(SYNC_CFG, device="cpu")
    convert.restore_jax_checkpoint(port, arrays, meta)
    for name, t in zip(("sdf", "weight", "color", "color_count"), port.volume.batch):
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jpipe.volume.batch, name)))
    np.testing.assert_array_equal(port.volume.ids, jpipe.volume.ids)
    np.testing.assert_array_equal(port.volume.used, jpipe.volume.used)
    assert port.volume.slot_of == jpipe.volume.slot_of
    np.testing.assert_array_equal(port.trajectory(), jpipe.trajectory())
    kf_before, edges_before = len(port.slam.keyframes), port.slam.n_edges
    for i in range(CUT, N):
        port.process_frame(depths[i], rgbs[i], timestamp=float(i))
    port.finish()
    assert len(port.slam.keyframes) > kf_before and port.slam.n_edges > edges_before
    assert port.slam.origin_count == 1
    assert tum.ate_rmse(port.trajectory(), np.stack(poses)) < 0.02
