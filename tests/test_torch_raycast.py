"""ops/raycast.py and TSDFVolume.sdf_at of the port against the JAX package.

tests/test_raycast.py's volume (tiny_test_config, three orbit frames
rendered and fused by the JAX package) is carried into the port with
utils/convert.volume_state_from_numpy. From the first frame's pose and a
novel pose between frames: the hit masks agree on at least 99.5% of the
pixels (a ray that grazes the band's edge can end either side of the
hit test, and 128 steps of float32 sums accumulate differently), depth
within 1e-4 m and colours within 1e-3 where both hit, and normals within
1e-3 on at least 99.9% of those pixels (a normal is a normalised
difference of two samples: where the gradient is small, float
differences grow).
refine_depth_to_isosurface and sdf_at (and its validity test, sdf <
RESET_SDF / 2, which differs from the raycaster's |sdf| < RESET_SDF / 2
on purpose, as in the JAX package) within 1e-5 on the same points.
Then test_raycast.py's three assertions on the port's own fused volume.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import raycast as jraycast
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion import chunkmap
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.io import synthetic
from texturefusion_torch.ops import raycast
from texturefusion_torch.ops.tsdf import RESET_SDF
from texturefusion_torch.utils import convert

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
INTR = cam.Intrinsics.from_config(CFG.camera)
HIT_AGREE = 0.995
NORMALS_AGREE = 0.999


@pytest.fixture(scope="module")
def volumes():
    poses = jsyn.orbit_trajectory(3)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    jvol = JVolume(CFG)
    for p, d, c in zip(poses, depths, rgbs):
        jvol.integrate_frame(jnp.asarray(d), jnp.asarray(c), jnp.zeros_like(jnp.asarray(d)),
                             jnp.asarray(p), keyframe_id=0)
    b = jvol.batch
    tvol = convert.volume_state_from_numpy(
        CFG, np.asarray(b.sdf), np.asarray(b.weight), np.asarray(b.color),
        np.asarray(b.color_count), np.asarray(jvol.origins), jvol.ids, jvol.used, device="cpu")
    return jvol, tvol, poses, depths, rgbs


def _novel(poses):
    """A pose between the first two frames, turned a little."""
    p = poses[0].copy()
    p[:3, 3] = 0.5 * (poses[0][:3, 3] + poses[1][:3, 3])
    a = 0.05
    rot = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    p[:3, :3] = p[:3, :3] @ rot
    return p.astype(np.float32)


@pytest.mark.parametrize("which", ["frame0", "novel"])
def test_raycast_matches_jax(volumes, which):
    jvol, tvol, poses, _, _ = volumes
    pose = poses[0] if which == "frame0" else _novel(poses)
    j = jraycast.raycast_volume(jvol, pose)
    t = raycast.raycast_volume(tvol, pose)
    jh, th = np.asarray(j.hit), t.hit.numpy()
    assert jh.mean() > 0.5
    assert (jh == th).mean() >= HIT_AGREE, (jh == th).mean()
    both = jh & th
    np.testing.assert_allclose(t.depth.numpy()[both], np.asarray(j.depth)[both], rtol=0, atol=1e-4)
    n_err = np.abs(t.normals.numpy()[both] - np.asarray(j.normals)[both]).max(-1)
    assert (n_err <= 1e-3).mean() >= NORMALS_AGREE, (n_err <= 1e-3).mean()
    np.testing.assert_allclose(t.color.numpy()[both], np.asarray(j.color)[both],
                               rtol=0, atol=1e-3)
    assert (t.depth.numpy()[~th] == 0).all()


def test_refine_depth_to_isosurface_matches_jax(volumes):
    jvol, tvol, poses, depths, _ = volumes
    rng = np.random.default_rng(0)
    d = depths[1] + np.where(depths[1] > 0, rng.normal(0, 0.01, depths[1].shape), 0)
    d = d.astype(np.float32)
    jt, tt = jvol._slot_table(), tvol._slot_table()
    want = np.asarray(jraycast.refine_depth_to_isosurface(
        jvol.batch.sdf, jvol.batch.weight, jt.table, jt.lo, jt.trash, jnp.asarray(d),
        jnp.asarray(poses[1]), JI, CFG.tsdf))
    got = raycast.refine_depth_to_isosurface(
        tvol.batch.sdf, tvol.batch.weight, tt.table, tt.lo, tt.trash, torch.as_tensor(d),
        torch.as_tensor(poses[1]), INTR, CFG.tsdf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    valid = depths[1] > 0
    # the snap moves the noisy samples towards the fused surface
    assert np.abs(got - depths[1])[valid].mean() < np.abs(d - depths[1])[valid].mean()


def test_sdf_at_matches_jax(volumes):
    jvol, tvol, poses, depths, _ = volumes
    rng = np.random.default_rng(1)
    # points on and around the first frame's surface, and far outside the map
    u, v = rng.integers(0, CFG.camera.width, 4000), rng.integers(0, CFG.camera.height, 4000)
    z = depths[0][v, u] + rng.normal(0, 0.05, 4000)
    pc = np.stack([(u - JI.cx) * z / JI.fx, (v - JI.cy) * z / JI.fy, z], -1)
    pw = pc @ poses[0][:3, :3].T + poses[0][:3, 3]
    pw = np.concatenate([pw, rng.uniform(-20, 20, (200, 3))]).astype(np.float32)
    js, jok = (np.asarray(a) for a in jvol.sdf_at(jnp.asarray(pw)))
    ts, tok = (a.numpy() for a in tvol.sdf_at(torch.as_tensor(pw)))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert tok.mean() > 0.2 and not tok[-200:].any()
    assert (ts[~tok] == RESET_SDF).all()


def test_sdf_validity_differs_from_the_raycaster_as_in_jax(volumes):
    """sample_sdf_trilinear tests sdf < RESET_SDF / 2, raycast._sample
    |sdf| < RESET_SDF / 2: a point whose corners are all far behind the
    surface (-RESET_SDF) counts for the first and not the second."""
    _, tvol, _, _, _ = volumes
    sdf = tvol.batch.sdf.clone()
    slot = int(tvol.active_slots()[0])
    sdf[slot] = -RESET_SDF
    w = torch.ones_like(tvol.batch.weight)
    table = tvol._slot_table()
    origin = torch.as_tensor(tvol.ids[slot] * CFG.tsdf.chunk_size * CFG.tsdf.voxel_resolution,
                             dtype=torch.float32)
    p = (origin + 3.7 * CFG.tsdf.voxel_resolution)[None]
    s1, ok1 = chunkmap.sample_sdf_trilinear(sdf, w, table, p, CFG.tsdf.chunk_size,
                                            CFG.tsdf.voxel_resolution)
    s2, ok2, _ = raycast._sample(table, sdf, w, None, None, p, CFG.tsdf.chunk_size,
                                 CFG.tsdf.voxel_resolution)
    assert bool(ok1[0]) and float(s1[0]) == pytest.approx(-RESET_SDF)
    assert not bool(ok2[0]) and float(s2[0]) == RESET_SDF


@pytest.fixture(scope="module")
def port_volume():
    poses = synthetic.orbit_trajectory(3)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), INTR, poses, device="cpu")
    vol = TSDFVolume(CFG, device="cpu")
    for p, d, c in zip(poses, depths, rgbs):
        d, c = torch.as_tensor(d), torch.as_tensor(c)
        vol.integrate_frame(d, c, torch.zeros_like(d), p, keyframe_id=0)
    return vol, poses, depths, rgbs


def test_raycast_matches_input_depth(port_volume):
    vol, poses, depths, _ = port_volume
    res = raycast.raycast_volume(vol, poses[0])
    hit, d_ray = res.hit.numpy(), res.depth.numpy()
    both = hit & (depths[0] > 0)
    assert both.mean() > 0.5, both.mean()
    err = np.abs(d_ray[both] - depths[0][both])
    assert np.median(err) < CFG.tsdf.voxel_resolution, np.median(err)


def test_raycast_normals_unit_and_facing(port_volume):
    vol, poses, _, _ = port_volume
    res = raycast.raycast_volume(vol, poses[0])
    n = res.normals.numpy()[res.hit.numpy()]
    assert (np.abs(np.linalg.norm(n, axis=-1) - 1.0) < 1e-3).mean() > 0.95
    view_w = poses[0][:3, :3] @ np.asarray([0, 0, 1.0])
    assert ((n @ view_w) < 0.5).mean() > 0.9


def test_raycast_colors_populated(port_volume):
    vol, poses, _, rgbs = port_volume
    res = raycast.raycast_volume(vol, poses[0])
    hit = res.hit.numpy()
    col = res.color.numpy()[hit]
    assert col.max() > 0.2
    corr = np.corrcoef(col.mean(-1), rgbs[0][hit].mean(-1))[0, 1]
    assert corr > 0.5, corr


def test_turntable_tool(tmp_path):
    """tools/turntable.py on the CPU at one view of its orbit: it hits more
    than half its pixels (the tool's PASS rule) and is written as a PNG."""
    import importlib.util
    import os

    from texturefusion_torch.io import png
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("turntable",
                                                  os.path.join(root, "tools", "turntable.py"))
    turntable = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(turntable)
    out = str(tmp_path / "turn")
    assert turntable.main(["--frames", "1", "--out", out, "--device", "cpu"]) == 0
    assert os.listdir(out) == ["turn_000.png"]
    assert png.read_png(os.path.join(out, "turn_000.png")).shape == (240, 320, 3)
