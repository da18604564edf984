"""Parity of the port's TSDF voxel update and chunk discovery with JAX.

The four setups of tests/test_pallas_voxel.py (a noisy wall at z = 2 m in
front of a 128×96 camera): sign +1 from a fresh volume, +1 and -1 on a
pre-integrated volume, and depth only. The port's plain in-place update
(the CPU path, and the oracle of the CUDA kernel) is held against JAX's
`integrate_frame_fused` and against the TPU kernel `integrate_rows_pallas`
in interpret mode, with that file's tolerances. Rows are compared on
[:capacity]: every padding lane names the trash row.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import CameraConfig, PipelineConfig, TSDFConfig
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.core import se3 as jse3
from texturefusion_tpu.ops import tsdf as jtsdf
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.ops import tsdf as ttsdf

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
from pallas_voxel_kernel import integrate_rows_pallas  # noqa: E402

torch.set_num_threads(2)

CONFIG = PipelineConfig(
    camera=CameraConfig(width=128, height=96, fx=100.0, fy=100.0,
                        cx=63.5, cy=47.5, far_plane=6.0),
    tsdf=TSDFConfig(voxel_resolution=0.05, capacity=64, max_update_chunks=16))
CFG = CONFIG.tsdf
# sdf, weight, color, color_count: (rtol, atol) of test_pallas_voxel.py
ROW_TOL = ((1e-5, 1e-5), (1e-6, 1e-6), (1e-4, 1e-3), (1e-6, 1e-6))
ROW_NAMES = ("sdf", "weight", "color", "color_count")


def _setup(pre_integrated, seed=0):
    """numpy inputs: rows, origins, idx, active, depth, rgb, quality, pose."""
    h, w = CONFIG.camera.height, CONFIG.camera.width
    v = CFG.chunk_size ** 3
    s1 = CFG.capacity + 1
    rng = np.random.default_rng(seed)
    d = np.full((h, w), 2.0, np.float32)
    d += rng.normal(0, 0.02, d.shape).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    rgb = rng.random((h, w, 3)).astype(np.float32)
    quality = rng.random((h, w)).astype(np.float32)
    rows = [np.full((s1, v), ttsdf.RESET_SDF, np.float32), np.zeros((s1, v), np.float32),
            np.zeros((s1, v, 3), np.float32), np.zeros((s1, v), np.float32)]
    if pre_integrated:
        rows[0] = rng.normal(0, 0.05, (s1, v)).astype(np.float32)
        rows[1] = rng.integers(0, 4, (s1, v)).astype(np.float32)
        rows[2] = rng.random((s1, v, 3)).astype(np.float32) * 90
        rows[3] = rows[1].copy()
    ids = np.asarray([(x, y, 4) for x in range(-2, 2) for y in range(-1, 2)], np.int32)
    n, u = len(ids), 16
    idx = np.concatenate([np.arange(n), np.full(u - n, CFG.capacity)]).astype(np.int64)
    origins = np.zeros((s1, 3), np.float32)
    origins[:n] = ids * (CFG.chunk_size * CFG.voxel_resolution)
    active = np.arange(u) < n
    return rows, origins, idx, active, d, rgb, quality, np.eye(4, dtype=np.float32)


def _port(rows, origins, idx, active, d, rgb, quality, pose, sign, with_color):
    t = torch.as_tensor
    batch = ttsdf.ChunkBatch(*(t(a.copy()) for a in rows))
    q, upd = ttsdf.integrate_frame_fused(
        batch, t(origins), t(idx), t(active), t(d), t(rgb), t(quality), t(pose),
        sign, tcam.Intrinsics.from_config(CONFIG.camera), CFG, with_color=with_color)
    return [a.numpy() for a in batch], q.numpy(), upd.numpy()


def _jax_fused(rows, origins, idx, active, d, rgb, quality, pose, sign, with_color):
    j = jnp.asarray
    out, q, upd = jtsdf.integrate_frame_fused(
        jtsdf.ChunkBatch(*(j(a) for a in rows)), j(origins), j(idx.astype(np.int32)),
        j(active), j(d), j(rgb), j(quality), j(pose), jnp.float32(sign),
        jcam.Intrinsics.from_config(CONFIG.camera), CFG, with_color=with_color)
    return [np.asarray(a) for a in out], np.asarray(q), np.asarray(upd)


def _pallas(rows, origins, idx, active, d, rgb, quality, pose, sign, with_color):
    j = jnp.asarray
    scale = 255.0 if with_color else 1.0
    img = jnp.stack([j(d), j(rgb[..., 0]) * scale, j(rgb[..., 1]) * scale,
                     j(rgb[..., 2]) * scale, j(quality)])
    w2c = jse3.inverse(j(pose)).reshape(-1)
    *out, q, upd = integrate_rows_pallas(
        *(j(a) for a in rows), j(origins)[idx], j(idx.astype(np.int32)),
        j(active.astype(np.int32)), img, w2c, jnp.asarray([sign], jnp.float32),
        jcam.Intrinsics.from_config(CONFIG.camera), CFG, with_color=with_color,
        win=32, interpret=True)
    return [np.asarray(a) for a in out], np.asarray(q), np.asarray(upd)


def _compare(got, ref, n_real, with_color):
    cap = CFG.capacity
    for name, g, r, (rtol, atol) in zip(ROW_NAMES, got[0], ref[0], ROW_TOL):
        np.testing.assert_allclose(g[:cap], r[:cap], rtol=rtol, atol=atol, err_msg=name)
    if with_color:
        np.testing.assert_allclose(got[1][:n_real], ref[1][:n_real], rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(got[2][:n_real], ref[2][:n_real])


CASES = [(1.0, False, True), (1.0, True, True), (-1.0, True, True), (1.0, True, False)]
CASE_IDS = ["plus_fresh", "plus_pre", "minus_pre", "depth_only"]


@pytest.mark.parametrize("oracle", ["jax_fused", "pallas_interpret"])
@pytest.mark.parametrize("sign,pre,with_color", CASES, ids=CASE_IDS)
def test_plain_update_matches_jax(oracle, sign, pre, with_color):
    inputs = _setup(pre)
    n_real = int(inputs[3].sum())
    got = _port(*inputs, sign, with_color)
    ref = (_jax_fused if oracle == "jax_fused" else _pallas)(*inputs, sign, with_color)
    _compare(got, ref, n_real, with_color)
    assert got[2][:n_real].any()          # the wall really updated voxels
    if not with_color:                    # depth-only leaves colour untouched
        np.testing.assert_array_equal(got[0][2], inputs[0][2])


def test_trash_lanes_leave_real_rows_alone():
    """Padding lanes report nothing and write only the trash row."""
    rows, origins, idx, active, d, rgb, quality, pose = _setup(True)
    active[:] = False
    got = _port(rows, origins, idx, active, d, rgb, quality, pose, 1.0, True)
    for g, r in zip(got[0], rows):
        np.testing.assert_array_equal(g[:CFG.capacity], r[:CFG.capacity])
    assert not got[2].any() and (got[1] == 0).all()


def _discovery_inputs(seed):
    rng = np.random.default_rng(seed)
    h, w = CONFIG.camera.height, CONFIG.camera.width
    d = (1.5 + rng.uniform(0, 1.5, (h, w))).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.2, 3)]).astype(np.float32)
    pose = np.array(jse3.se3_exp(jnp.asarray(xi)))
    return d, pose


@pytest.mark.parametrize("seed,stride,max_out", [(0, 1, 4096), (1, 2, 4096), (2, 1, 64)])
def test_candidate_chunks_unique_matches_jax(seed, stride, max_out):
    d, pose = _discovery_inputs(seed)
    ids_j, n_j = jtsdf.candidate_chunks_unique(
        jnp.asarray(d), jnp.asarray(pose), jcam.Intrinsics.from_config(CONFIG.camera),
        CFG, stride=stride, max_out=max_out)
    ids_t, n_t = ttsdf.candidate_chunks_unique(
        torch.as_tensor(d), torch.as_tensor(pose),
        tcam.Intrinsics.from_config(CONFIG.camera), CFG, stride=stride, max_out=max_out)
    assert n_t == int(n_j) > 0
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    if max_out == 64:
        assert n_t == max_out             # overflow: the budget filled


def test_candidate_coords_match_jax():
    d, pose = _discovery_inputs(3)
    ids_j, m_j = jtsdf.candidate_chunk_coords(
        jnp.asarray(d), jnp.asarray(pose), jcam.Intrinsics.from_config(CONFIG.camera), CFG)
    ids_t, m_t = ttsdf.candidate_chunk_coords(
        torch.as_tensor(d), torch.as_tensor(pose),
        tcam.Intrinsics.from_config(CONFIG.camera), CFG)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_truncation_distance_matches_jax():
    z = np.linspace(0.1, 6.0, 50).astype(np.float32)
    np.testing.assert_allclose(ttsdf.truncation_distance(torch.as_tensor(z), CFG).numpy(),
                               np.asarray(jtsdf.truncation_distance(jnp.asarray(z), CFG)),
                               rtol=1e-6, atol=0)
    assert jax.devices()[0].platform == "cpu"
