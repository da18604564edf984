"""core/exact.py and the feature path's fixed-order arithmetic.

The port's grey image, pyramid and descriptors must round the same on
the CPU and on a CUDA device; the card's half of that is
test_torch_cuda_kernels.py::test_features_gpu_match_cpu_bit_for_bit.
Here, on the CPU: exact.div is the CPU's division (and the reciprocal
multiplication that PyTorch's CUDA kernel does for a Python divisor is
not), tree_sum adds pairwise in its stated order, the resize taps are
jax.image.resize's weights, and the descriptor rotation taken from the
moments is cos and sin of the angle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from texturefusion_torch.core import exact
from texturefusion_torch.slam import features as tf

torch.set_num_threads(2)


@pytest.mark.parametrize("s", [255.0, 5000.0, 5, 2 * np.pi])
def test_div_is_the_cpus_division(s):
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 70000, 4096).astype(np.float32))
    np.testing.assert_array_equal(exact.div(x, s).numpy(), (x / s).numpy())
    np.testing.assert_array_equal(exact.div(x, s).numpy(),
                                  (x.double() / float(np.float32(s))).float().numpy())
    recip = x * np.float32(1.0 / s)
    assert (recip != x / s).any()


def test_tree_sum_adds_pairwise():
    x = np.random.default_rng(1).normal(size=(5, 64)).astype(np.float32)
    want = x
    while want.shape[-1] > 1:
        want = want[:, 0::2] + want[:, 1::2]
    np.testing.assert_array_equal(exact.tree_sum(torch.as_tensor(x)).numpy(), want[:, 0])
    with pytest.raises(ValueError):
        exact.tree_sum(torch.zeros(3, 6))


@pytest.mark.parametrize("n_in,n_out", [(160, 133), (120, 100), (133, 111), (40, 33), (32, 32)])
def test_resize_taps_are_jax_weights(n_in, n_out):
    kernel = jscale._kernels[jscale.ResizeMethod.LINEAR]
    want = np.asarray(jscale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in),
                                                jnp.float32(0.0), kernel, True)).T
    idx, wt = tf._linear_taps(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float32)
    np.add.at(dense, (np.arange(n_out)[:, None].repeat(idx.shape[1], 1), idx), wt)
    np.testing.assert_allclose(dense, want, rtol=0, atol=6e-8)
    assert idx.shape[1] <= 3


def test_resize_matches_jax():
    img = np.random.default_rng(2).uniform(0, 255, (120, 160)).astype(np.float32)
    got = tf.resize_linear(torch.as_tensor(img), 100, 133).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), (100, 133), "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_rotation_from_moments_is_cos_sin_of_the_angle():
    rng = np.random.default_rng(3)
    m = torch.as_tensor(rng.normal(0, 500, (2, 300)).astype(np.float32))
    m[:, :3] = 0.0
    patches = torch.as_tensor(rng.uniform(0, 255, (300, 32, 32)).astype(np.float32))
    got = tf._descriptors_patch(patches, m[0], m[1])
    ang = torch.atan2(m[1], m[0])
    c = tf._consts("cpu")
    rx = torch.cos(ang)[:, None] * c["xs"][None] - torch.sin(ang)[:, None] * c["ys"][None] + 15
    ry = torch.sin(ang)[:, None] * c["xs"][None] + torch.cos(ang)[:, None] * c["ys"][None] + 15
    ix = torch.clamp(torch.round(rx).long(), 0, 31)
    iy = torch.clamp(torch.round(ry).long(), 0, 31)
    vals = torch.gather(patches.reshape(300, -1), 1, iy * 32 + ix)
    from texturefusion_torch.ops import hamming
    want = hamming.pack_bits(vals[:, :256] < vals[:, 256:])
    # the two rotations differ by rounding: a sample coordinate within
    # 1e-4 px of its rounding boundary may land on the neighbouring pixel
    same = (got == want).all(-1)
    assert same[:3].all() and same.float().mean() >= 0.98, same.float().mean()
