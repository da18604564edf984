"""The ground-truth-pose slice end to end, port against JAX.

Four 160×120 frames of `orbit_trajectory`, rendered by the JAX package,
go through the demo path (examples/demo_synthetic.py without --slam:
clamp + bilateral, normals, quality, TSDFVolume.integrate_frame, then
IncrementalMesher.update_meshes and full_mesh) in both packages. The
JAX side uses the TPU kernel `bilateral_filter_pallas` (interpret mode)
as its bilateral step, which is what the port's filter follows.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.fusion.mesher import IncrementalMesher as JMesher
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.models.reconstruction import frame_step as jstep
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops import tsdf as jtsdf
from texturefusion_tpu.ops.pallas_kernels import bilateral_filter_pallas
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.fusion.chunkmap import TSDFVolume as TVolume
from texturefusion_torch.fusion.mesher import IncrementalMesher as TMesher
from texturefusion_torch.io import ply as tply
from texturefusion_torch.io import synthetic as tsyn
from texturefusion_torch.models.reconstruction import frame_step as tstep
from texturefusion_torch.ops import preprocess as tpre
from texturefusion_torch.ops import tsdf as ttsdf

torch.set_num_threads(2)

CONFIG = tiny_test_config()
N_FRAMES = 4


@pytest.fixture(scope="module")
def runs():
    ji = jcam.Intrinsics.from_config(CONFIG.camera)
    ti = tcam.Intrinsics.from_config(CONFIG.camera)
    scene = jsyn.BoxRoomScene()
    poses = jsyn.orbit_trajectory(N_FRAMES)
    depths, rgbs = jsyn.render_sequence(scene, ji, poses)

    jvol = JVolume(CONFIG)
    jmesh = JMesher(jvol)
    tvol = TVolume(CONFIG, device="cpu")
    tmesh = TMesher(tvol)
    for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
        dj, cj = jnp.asarray(d), jnp.asarray(c)
        dpre = bilateral_filter_pallas(jpre.depth_clamp(dj, ji.near, ji.far))
        nrm = jpre.extract_normal_map(dpre, ji)
        q = jpre.observation_quality_map(cj, dpre, nrm, ji)
        jvol.integrate_frame(dpre, cj, q, jnp.asarray(p), keyframe_id=i)

        dt, ct = torch.as_tensor(d), torch.as_tensor(c)
        dpre = tpre.frame_preprocess(dt, ti)
        nrm = tpre.extract_normal_map(dpre, ti)
        q = tpre.observation_quality_map(ct, dpre, nrm, ti)
        tvol.integrate_frame(dpre, ct, q, p, keyframe_id=i)
    jmesh.update_meshes()
    tmesh.update_meshes()
    return dict(jvol=jvol, tvol=tvol, jmesh=jmesh.full_mesh(),
                tmesh=tmesh.full_mesh(), scene=scene, poses=poses, depths=depths)


def _rows_by_id(vol, batch):
    slots = vol.active_slots()
    ids = [tuple(int(x) for x in vol.ids[s]) for s in slots]
    return ids, slots, [np.asarray(a)[slots] for a in batch]


def test_same_chunks_allocated(runs):
    jids, _, _ = _rows_by_id(runs["jvol"], runs["jvol"].batch)
    tids, _, _ = _rows_by_id(runs["tvol"], runs["tvol"].batch)
    assert len(tids) > 50
    assert set(tids) == set(jids)


def test_chunk_rows_match(runs):
    jids, _, jrows = _rows_by_id(runs["jvol"], runs["jvol"].batch)
    tids, _, trows = _rows_by_id(runs["tvol"], [a.numpy() for a in runs["tvol"].batch])
    order = [jids.index(c) for c in tids]
    for name, t, j, atol in zip(("sdf", "weight", "color", "color_count"), trows, jrows,
                                (1e-4, 1e-4, 1e-2, 1e-4)):
        np.testing.assert_allclose(t, j[order], atol=atol, rtol=0, err_msg=name)
    assert (trows[1] > 0).sum() > 1000


def test_observation_quality_recorded(runs):
    jq, jm = runs["jvol"].obs_arrays()
    tq, tm = runs["tvol"].obs_arrays()
    # slots are handed out in the same order, so the tables line up
    np.testing.assert_array_equal(runs["tvol"].ids, runs["jvol"].ids)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-2)
    assert tm.sum() > 0


def test_full_mesh_matches(runs):
    jv, jf, _, _ = runs["jmesh"]
    tv, tf, tc, tn = runs["tmesh"]
    assert len(tv) == len(jv) > 1000
    assert len(tf) == len(jf)
    np.testing.assert_allclose(np.sort(tv, axis=0), np.sort(jv, axis=0), atol=1e-4, rtol=0)
    # the demo's own geometric check: vertices on the analytic surface
    err = np.abs(np.asarray(runs["scene"].sdf(jnp.asarray(tv))))
    assert np.median(err) < CONFIG.tsdf.voxel_resolution
    assert np.isfinite(tc).all() and np.isfinite(tn).all()


def test_ply_written_and_reloads(runs, tmp_path):
    v, f, c, n = runs["tmesh"]
    path = os.path.join(tmp_path, "fused.ply")
    tply.save_ply(path, v, f, c, n)
    v2, f2, c2, n2 = tply.load_ply(path)
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_allclose(n2, n, atol=1e-6)
    assert c2.dtype == np.uint8 and c2.shape == (len(v), 3)


def test_port_render_matches_jax(runs):
    ti = tcam.Intrinsics.from_config(CONFIG.camera)
    for p, dj in zip(runs["poses"][::3], runs["depths"][::3]):
        dt, _ = tsyn.render_frame(tsyn.BoxRoomScene(), ti, torch.as_tensor(p))
        close = np.abs(dt.numpy() - dj) <= 1e-4
        assert close.mean() >= 0.99, close.mean()


def test_port_render_colours_match_jax():
    """The texture hash turns one ulp of its argument into another cell
    colour, so the port rounds it as the JAX package's compiled renderer
    does (FMA-contracted). In bench.py's room (whose walls do not sit on
    a texture-cell boundary, unlike the default room's z = 2 wall) the
    uint8 colours of both renderers agree on ≥ 99.5% of the values and
    never differ by more than one level."""
    ji = jcam.Intrinsics.from_config(CONFIG.camera)
    ti = tcam.Intrinsics.from_config(CONFIG.camera)
    room = dict(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))
    poses = jsyn.loop_trajectory(120, radius=1.5)[:60:20]
    _, jrgb = jsyn.render_sequence(jsyn.BoxRoomScene(**room), ji, poses)
    _, trgb = tsyn.render_sequence(tsyn.BoxRoomScene(**room), ti, poses, device="cpu")
    diff = np.abs((trgb * 255).astype(np.uint8).astype(int)
                  - (jrgb * 255).astype(np.uint8).astype(int))
    assert (diff == 0).mean() >= 0.995, (diff == 0).mean()
    assert diff.max() <= 1


def test_frame_step_matches_jax():
    """models.reconstruction.frame_step (the driver's entry() step) on
    chunks that project well inside the image, where the two bilateral
    border rules cannot differ: rows and chunk quality agree."""
    cfg = CONFIG.tsdf
    ji = jcam.Intrinsics.from_config(CONFIG.camera)
    ti = tcam.Intrinsics.from_config(CONFIG.camera)
    rng = np.random.default_rng(5)
    depth = (2.0 + rng.normal(0, 0.005, (ji.height, ji.width))).astype(np.float32)
    rgb = rng.random((ji.height, ji.width, 3)).astype(np.float32)
    ids = np.asarray([(x, y, z) for x in range(-2, 2) for y in range(-1, 1)
                      for z in (4,)], np.int32)
    origins = (ids * cfg.chunk_size * cfg.voxel_resolution).astype(np.float32)
    active = np.ones(len(ids), bool)
    pose = np.eye(4, dtype=np.float32)
    jb, jq, jn = jstep(jnp.asarray(depth), jnp.asarray(rgb),
                       jtsdf.make_empty_batch(len(ids), 512), jnp.asarray(origins),
                       jnp.asarray(active), jnp.asarray(pose), ji, cfg)
    tb, tq, tn = tstep(torch.as_tensor(depth), torch.as_tensor(rgb),
                       ttsdf.make_empty_batch(len(ids), 512, "cpu"), torch.as_tensor(origins),
                       torch.as_tensor(active), torch.as_tensor(pose), ti, cfg)
    for name, t, j, atol in zip(("sdf", "weight", "color", "color_count"), tb, jb,
                                (1e-4, 0, 1e-2, 0)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0,
                                   err_msg=name)
    assert (tb.weight > 0).sum() > 1000
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(tn.numpy()[6:-6, 6:-6], np.asarray(jn)[6:-6, 6:-6],
                               atol=5e-4, rtol=0)
