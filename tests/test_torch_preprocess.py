"""Parity of the port's preprocessing with the JAX package.

The port's bilateral filter follows the TPU kernel (out-of-image taps
weigh 0), so its oracle is `bilateral_filter_pallas` in interpret mode on
the whole image. JAX's own `preprocess_bundle` on the CPU runs the XLA
bilateral, which replicates edges instead; against it the port agrees on
the interior [6:-6, 6:-6] (the 4-pixel filter border plus the normal and
Sobel stencils).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops.pallas_kernels import bilateral_filter_pallas
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.io import synthetic as tsyn
from texturefusion_torch.ops import preprocess as tpre

torch.set_num_threads(2)

CFG = tiny_test_config()
DEPTH_SCALE = 5000.0


def _holey_depth(seed, shape=(120, 160)):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.05] = 0.0
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bilateral_matches_pallas_whole_image(seed):
    d = _holey_depth(seed)
    ref = np.asarray(bilateral_filter_pallas(jnp.asarray(d)))
    got = tpre.bilateral_filter(torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert ((got == 0) == (ref == 0)).all()


def test_plain_bilateral_preserves_edges():
    d = np.full((48, 64), 2.0, np.float32)
    d[:, 32:] = 1.0
    got = tpre.bilateral_filter(torch.as_tensor(d)).numpy()
    assert abs(got[24, 30] - 2.0) < 1e-3
    assert abs(got[24, 34] - 1.0) < 1e-3
    np.testing.assert_allclose(got, np.asarray(bilateral_filter_pallas(jnp.asarray(d))),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def packed_frame():
    """A rendered 160×120 frame with sensor-like noise, packed to uint8."""
    intr = tcam.Intrinsics.from_config(CFG.camera)
    pose = tsyn.orbit_trajectory(3)[1]
    d, c = tsyn.render_frame(tsyn.BoxRoomScene(), intr, torch.as_tensor(pose))
    d, c = d.numpy(), c.numpy()
    rng = np.random.default_rng(3)
    d = np.where(d > 0, d + rng.normal(0, 0.01, d.shape).astype(np.float32) * d, 0.0)
    return tpre.pack_frame((d * DEPTH_SCALE).astype(np.uint16), (c * 255).astype(np.uint8))


def _jax_chain_with_pallas(packed, intr):
    """JAX preprocess_bundle's chain, with the TPU kernel as its bilateral."""
    p = jnp.asarray(packed)
    depth_raw = (p[..., 0].astype(jnp.float32)
                 + p[..., 1].astype(jnp.float32) * 256.0) / DEPTH_SCALE
    rgb = p[..., 2:5].astype(jnp.float32) / 255.0
    depth = bilateral_filter_pallas(jpre.depth_clamp(depth_raw, intr.near, intr.far))
    normals = jpre.extract_normal_map(depth, intr)
    refined = jpre.refine_depth_with_normals(depth, normals, intr)
    quality = jpre.observation_quality_map(rgb, refined, normals, intr)
    gray = jpre.rgb_to_gray(rgb) * 255.0
    return refined, normals, quality, gray, jpre.laplacian_blurriness(gray), rgb


def _port_bundle(packed):
    return tpre.preprocess_bundle(torch.as_tensor(packed), None,
                                  tcam.Intrinsics.from_config(CFG.camera),
                                  depth_scale=DEPTH_SCALE)


# Per-output tolerances. The filtered depth agrees within 1e-6 (exp differs
# by an ulp between the libraries). Normals are cross products of
# neighbour differences ~300x smaller than the points, so those ulps grow:
# measured max 7.1e-5 against the chain, 1.9e-4 against JAX's compiled
# bundle (XLA also fuses the back-projection arithmetic); quality carries
# them through the view-angle factor (measured 4.5e-5 and 9.1e-5). gray is
# on a 0-255 scale, where XLA's fused sum differs by up to 2 ulps (3.1e-5).
TOL = {"depth": (1e-5, 0), "normals": (5e-4, 0), "quality": (5e-4, 0),
       "gray": (0, 1e-6), "blur": (1e-5, 0), "rgb": (1e-6, 0)}
NAMES = ("depth", "normals", "quality", "gray", "blur", "rgb")


def test_bundle_matches_jax_chain_with_pallas_bilateral(packed_frame):
    ref = _jax_chain_with_pallas(packed_frame, jcam.Intrinsics.from_config(CFG.camera))
    got = _port_bundle(packed_frame)
    for name, g, r in zip(NAMES, got, ref):
        atol, rtol = TOL[name]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=rtol,
                                   err_msg=name)
    assert (got[0] > 0).float().mean() > 0.9


def test_bundle_matches_jax_bundle_interior(packed_frame):
    intr = jcam.Intrinsics.from_config(CFG.camera)
    ref = jpre.preprocess_bundle(jnp.asarray(packed_frame), None, intr,
                                 depth_scale=DEPTH_SCALE)
    got = _port_bundle(packed_frame)
    inner = (slice(6, -6), slice(6, -6))
    for i, name in enumerate(NAMES[:4]):
        atol, rtol = TOL[name]
        np.testing.assert_allclose(got[i].numpy()[inner], np.asarray(ref[i])[inner],
                                   atol=atol, rtol=rtol, err_msg=name)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[5]), atol=1e-6, rtol=0)


def test_unpacked_inputs_match_packed(packed_frame):
    """uint16 depth + uint8 rgb give the same bundle as the packed frame."""
    d16 = packed_frame[..., 0].astype(np.uint16) | (packed_frame[..., 1].astype(np.uint16) << 8)
    intr = tcam.Intrinsics.from_config(CFG.camera)
    a = tpre.preprocess_bundle(torch.as_tensor(d16.astype(np.int32)),
                               torch.as_tensor(packed_frame[..., 2:5]), intr,
                               depth_scale=DEPTH_SCALE)
    b = _port_bundle(packed_frame)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
