"""Parity of the port's core (se3, camera, geometry) with the JAX package.

Inputs are made with numpy from a seed and handed to both packages;
outputs agree within atol 1e-5 (float32 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import CameraConfig
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.core import geometry as jgeo
from texturefusion_tpu.core import se3 as jse3
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.core import geometry as tgeo
from texturefusion_torch.core import se3 as tse3

torch.set_num_threads(2)

ATOL = 1e-5
CAM = CameraConfig(width=64, height=48, fx=60.0, fy=62.0, cx=31.5, cy=23.5,
                   far_plane=6.0, d0=-0.03, d1=0.005, d2=0.001, d3=-0.002)


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _twists(seed=0, n=16):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    xi[0] = 0.0                       # the Taylor branch at the identity
    xi[1, 3:] = 1e-5
    return xi


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp", "hat"])
def test_exp_maps_match_jax(fn):
    xi = _twists()
    arg = xi if fn == "se3_exp" else xi[:, 3:]
    _close(getattr(tse3, fn)(torch.as_tensor(arg)), getattr(jse3, fn)(jnp.asarray(arg)))


def test_log_inverse_compose_transform_match_jax():
    xi = _twists(1)
    pj = jse3.se3_exp(jnp.asarray(xi))
    pt = torch.as_tensor(np.array(pj))
    _close(tse3.se3_log(pt), jse3.se3_log(pj), atol=1e-4)
    _close(tse3.inverse(pt), jse3.inverse(pj))
    _close(tse3.compose(pt, tse3.inverse(pt)), jse3.compose(pj, jse3.inverse(pj)))
    pts = np.random.default_rng(2).normal(0, 2, (16, 50, 3)).astype(np.float32)
    _close(tse3.transform_points(pt, torch.as_tensor(pts)),
           jse3.transform_points(pj, jnp.asarray(pts)))
    _close(tse3.rotate_points(pt, torch.as_tensor(pts)),
           jse3.rotate_points(pj, jnp.asarray(pts)))
    _close(tse3.quaternion_from_matrix(pt[:, :3, :3]),
           jse3.quaternion_from_matrix(pj[:, :3, :3]))
    q = np.array(jse3.quaternion_from_matrix(pj[:, :3, :3]))
    _close(tse3.matrix_from_quaternion(torch.as_tensor(q)),
           jse3.matrix_from_quaternion(jnp.asarray(q)))
    b = tse3.se3_exp(torch.as_tensor(_twists(3)))
    _close(tse3.pose_distance(pt, b), jse3.pose_distance(pj, jnp.asarray(b.numpy())),
           atol=1e-4)


def test_camera_projection_matches_jax():
    ji = jcam.Intrinsics.from_config(CAM)
    ti = tcam.Intrinsics.from_config(CAM)
    assert tuple(ti) == tuple(ji)
    rng = np.random.default_rng(4)
    pts = rng.uniform([-1, -1, 0.3], [1, 1, 3], (200, 3)).astype(np.float32)
    uv_t, z_t = tcam.project(ti, torch.as_tensor(pts))
    uv_j, z_j = jcam.project(ji, jnp.asarray(pts))
    _close(uv_t, uv_j, atol=1e-4)
    _close(z_t, z_j)
    u, v, d = (torch.as_tensor(a) for a in (pts[:, 0] * 40, pts[:, 1] * 30, pts[:, 2]))
    _close(tcam.unproject(ti, u, v, d), jcam.unproject(ji, *(jnp.asarray(a.numpy())
                                                             for a in (u, v, d))))
    depth = rng.uniform(0.5, 3.0, (CAM.height, CAM.width)).astype(np.float32)
    _close(tcam.backproject_depth_map(ti, torch.as_tensor(depth)),
           jcam.backproject_depth_map(ji, jnp.asarray(depth)))
    for a, b in zip(tcam.pixel_grid(ti), jcam.pixel_grid(ji)):
        _close(a, b)
    _close(tcam.in_image(ti, uv_t, 1.0), jcam.in_image(ji, uv_j, 1.0))


def test_distortion_matches_jax():
    ji = jcam.Intrinsics.from_config(CAM)
    ti = tcam.Intrinsics.from_config(CAM)
    assert ti.has_distortion
    rng = np.random.default_rng(5)
    uv = rng.uniform([0, 0], [CAM.width, CAM.height], (300, 2)).astype(np.float32)
    _close(tcam.undistort_points(ti, torch.as_tensor(uv)),
           jcam.undistort_points(ji, jnp.asarray(uv)), atol=1e-4)
    x, y = rng.uniform(-0.6, 0.6, (2, 300)).astype(np.float32)
    for a, b in zip(tcam.distort_normalized(ti, torch.as_tensor(x), torch.as_tensor(y)),
                    jcam.distort_normalized(ji, jnp.asarray(x), jnp.asarray(y))):
        _close(a, b)


@pytest.mark.parametrize("chunk,res", [(8, 0.02), (8, 0.05), (4, 0.03)])
def test_geometry_matches_jax(chunk, res):
    np.testing.assert_array_equal(tgeo.voxel_centroids(chunk, res),
                                  jgeo.voxel_centroids(chunk, res))
    pts = np.random.default_rng(6).uniform(-3, 3, (500, 3)).astype(np.float32)
    ext = chunk * res
    np.testing.assert_array_equal(tgeo.world_to_chunk(torch.as_tensor(pts), ext).numpy(),
                                  np.asarray(jgeo.world_to_chunk(jnp.asarray(pts), ext)))
    np.testing.assert_array_equal(tgeo.neighbor_offsets_6(), jgeo.neighbor_offsets_6())
