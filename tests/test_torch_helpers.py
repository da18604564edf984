"""Functions the main path does not call, port against JAX: the
frame-by-frame depth integration, three preprocessing helpers, the
perturbed-pose generator, the chunk-grid helpers and scaled intrinsics.

Tolerances: integer and boolean outputs exactly; float images and poses
within 1e-5 (float32 on both sides); the TSDF rows at
test_torch_tsdf.py's row tolerances. test_refine_misc.py's,
test_tsdf.py::test_batched_local_integration_matches_scan's and
test_camera.py::test_scaled_intrinsics' assertions are repeated on the
port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.core import geometry as jgeo
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops import tsdf as jtsdf
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.core import geometry as tgeo
from texturefusion_torch.io import synthetic as tsyn
from texturefusion_torch.ops import preprocess as tpre
from texturefusion_torch.ops import tsdf as ttsdf

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
TI = tcam.Intrinsics.from_config(CFG.camera)


@pytest.fixture(scope="module")
def frames():
    poses = jsyn.orbit_trajectory(4)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    return np.stack(poses).astype(np.float32), depths, rgbs


def _wall_rows(cap=64):
    ext = CFG.tsdf.chunk_size * CFG.tsdf.voxel_resolution
    origins = np.zeros((cap + 1, 3), np.float32)
    for k, (x, y) in enumerate((x, y) for x in range(-4, 4) for y in range(-2, 2)):
        origins[k] = [x * ext, y * ext, 1.8]
    return origins


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_integrate_depths_scan_matches_jax(frames, sign):
    poses, depths, _ = frames
    cap, n_vox = 64, CFG.tsdf.chunk_size ** 3
    origins = _wall_rows(cap)
    idx = np.arange(32, dtype=np.int64)
    jb = jtsdf.make_empty_batch(cap + 1, n_vox)
    tb = ttsdf.make_empty_batch(cap + 1, n_vox, "cpu")
    if sign < 0:     # de-integrate from a map that holds the frames
        jb = jtsdf.integrate_depths_scan(jb, jnp.asarray(origins), jnp.asarray(idx),
                                         jnp.ones(32, bool), jnp.asarray(depths),
                                         jnp.asarray(poses), jnp.float32(1.0), JI, CFG.tsdf)
        for dst, src in zip(tb, jb):
            dst.copy_(torch.tensor(np.asarray(src)))
    want = jtsdf.integrate_depths_scan(jb, jnp.asarray(origins), jnp.asarray(idx),
                                       jnp.ones(32, bool), jnp.asarray(depths),
                                       jnp.asarray(poses[::-1].copy()), jnp.float32(sign), JI,
                                       CFG.tsdf)
    ttsdf.integrate_depths_scan(tb, torch.tensor(origins), torch.tensor(idx), None,
                                torch.tensor(depths), torch.tensor(poses[::-1].copy()), sign,
                                TI, CFG.tsdf)
    for got, w, (rtol, atol) in zip(tb, want, ((1e-5, 1e-5), (1e-6, 1e-6), (1e-4, 1e-3),
                                               (1e-6, 1e-6))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=rtol, atol=atol)
    assert float(tb.weight.abs().sum()) > 0 or sign < 0


def test_batched_local_integration_matches_scan_on_the_port(frames):
    """test_tsdf.py::test_batched_local_integration_matches_scan: the
    F-frame pass against the frame-by-frame scan."""
    poses, depths, _ = frames
    cap, n_vox = 64, CFG.tsdf.chunk_size ** 3
    origins, idx = torch.tensor(_wall_rows(cap)), torch.arange(32)
    a = ttsdf.make_empty_batch(cap + 1, n_vox, "cpu")
    b = ttsdf.make_empty_batch(cap + 1, n_vox, "cpu")
    d, p = torch.tensor(depths), torch.tensor(poses)
    ttsdf.integrate_depths_scan(a, origins, idx, None, d, p, 1.0, TI, CFG.tsdf)
    ttsdf.integrate_depths_batched(b, origins, idx, None, d, p, 1.0, TI, CFG.tsdf)
    assert float(b.weight.sum()) > 0
    np.testing.assert_allclose(b.weight.numpy(), a.weight.numpy(), atol=1e-4)
    mask = a.weight.numpy() > 0
    np.testing.assert_allclose(b.sdf.numpy()[mask], a.sdf.numpy()[mask], atol=1e-3)


def test_preprocess_helpers_match_jax(frames):
    _, depths, rgbs = frames
    depth, rgb = depths[1], rgbs[1]
    normals = np.asarray(jpre.extract_normal_map(jnp.asarray(depth), JI))
    want = np.asarray(jpre.color_valid_flag(jnp.asarray(depth), jnp.asarray(normals), JI))
    got = tpre.color_valid_flag(torch.tensor(depth), torch.tensor(normals), TI).numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tpre.devignette(torch.tensor(rgb), TI).numpy(),
                               np.asarray(jpre.devignette(jnp.asarray(rgb), JI)), atol=1e-6)
    holes = depth.copy()
    holes[40:60, 70:90] = 0.0
    holes[:, 100:] *= 0.7
    for it in (1, 2, 3):
        np.testing.assert_array_equal(
            tpre.remove_boundary_depth(torch.tensor(holes), it).numpy(),
            np.asarray(jpre.remove_boundary_depth(jnp.asarray(holes), it)))


def test_refine_misc_assertions_hold_on_the_port():
    """test_refine_misc.py's devignette and remove_boundary_depth checks."""
    out = tpre.devignette(torch.full((TI.height, TI.width, 3), 0.5), TI).numpy()
    cy, cx = TI.height // 2, TI.width // 2
    assert abs(out[cy, cx, 0] - 0.5) < 0.01
    assert out[0, 0, 0] > out[cy, cx, 0]
    d = np.full((32, 32), 2.0, np.float32)
    d[:, 16:] = 1.0
    out = tpre.remove_boundary_depth(torch.tensor(d)).numpy()
    assert (out[:, 14:18] == 0).any()
    assert (out[:, :8] > 0).all() and (out[:, 24:] > 0).all()


def test_perturbed_poses_match_jax(frames):
    poses = list(frames[0])
    for seed in (0, 3):
        got = tsyn.perturbed_poses(poses, 0.02, 0.01, seed=seed)
        want = jsyn.perturbed_poses(poses, 0.02, 0.01, seed=seed)
        np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5)
        assert np.abs(np.stack(got) - np.stack(poses)).max() > 1e-3


def test_chunk_grid_helpers_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-600, 600, (200, 3)).astype(np.int32)
    for size in (1024, 4097):
        np.testing.assert_array_equal(tgeo.chunk_id_hash(ids, size), jgeo.chunk_id_hash(ids, size))
    np.testing.assert_allclose(tgeo.chunk_origin(torch.tensor(ids), 0.4).numpy(),
                               np.asarray(jgeo.chunk_origin(jnp.asarray(ids), 0.4)), rtol=1e-7)
    for s in (4, 8):
        np.testing.assert_array_equal(tgeo.voxel_coords_in_chunk(s), jgeo.voxel_coords_in_chunk(s))
    lo = rng.uniform(-1, 0, (5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeo.aabb_corners(torch.tensor(lo), torch.tensor(hi)).numpy(),
                               np.asarray(jgeo.aabb_corners(jnp.asarray(lo), jnp.asarray(hi))),
                               atol=1e-7)
    np.testing.assert_array_equal(tgeo.neighbor_offsets_corner7(), jgeo.neighbor_offsets_corner7())
    # the mesher's corner-neighbour table is the same set, in block-LUT bit order
    from texturefusion_torch.fusion.mesher import IncrementalMesher
    assert {tuple(r) for r in IncrementalMesher._CORNER_OFFS.tolist()} == \
        {tuple(r) for r in tgeo.neighbor_offsets_corner7().tolist()}


def test_scaled_intrinsics_match_jax():
    for f in (0.5, 0.25, 2.0):
        got, want = TI.scaled(f), JI.scaled(f)
        assert got == tcam.Intrinsics(*want)
    half = TI.scaled(0.5)
    assert half.width == TI.width // 2 and abs(half.fx - TI.fx * 0.5) < 1e-6
