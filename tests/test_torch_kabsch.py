"""The weighted rigid fit: the plain `kabsch` against the JAX package's,
and kernel K3 (csrc/kabsch.cu) against the plain version.

Point sets (numpy, seeded): random, planar (every point at z = 2 m),
near-collinear (points along a 1 m line with 5 cm of scatter),
reflection-prone (q a mirror image of p, so the SVD's rotation has
det −1 and the fit must flip its last column) and zero-weight (half the
weights 0, and one fit whose weights are all 0). Each set maps p onto q
by a random rigid motion plus 2 mm of noise, at the RANSAC shape (4
points a fit) and at 50 points a fit.

Tolerances. Plain against JAX: rotation entries and translation within
1e-5 (both sum in float32 in another order and take LAPACK's SVD), the
near-collinear sets within 2e-5 (σ2/σ1 ≈ 0.05 magnifies the rounding);
an all-zero fit is the identity on both. K3 against the plain version
(on the card, cuda-marked; the JAX side is imported inside its fixture,
so this file runs on the card's machine with `--noconftest -m cuda`): K3
sums and solves in float64 and rounds once, so it is held within 1e-6 to
the plain version run in float64, and within 2e-5 to the plain version
in float32 on the random sets at the shapes of RANSAC's calls (400 and
100 hypotheses a registration on the default config, 128 and 64 on the
tiny one; the stale-frame refinements call the same registration);
det R = +1 on every fit, degenerate ones included.
"""

import numpy as np
import pytest
import torch

from texturefusion_torch.core import se3
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.slam import matching as tm

torch.set_num_threads(2)

KINDS = ("random", "planar", "collinear", "reflect", "zero")
TOL = {"collinear": 2e-5}
RANSAC_FITS = (400, 100, 128, 64)


def point_sets(kind: str, b: int, n: int, seed: int = 1):
    """[b, n, 3] p, q and [b, n] w (float32) of the kind."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 1.0, (b, n, 3)) + [0.0, 0.0, 2.0]
    if kind == "planar":
        p[..., 2] = 2.0
    if kind == "collinear":
        p = (np.linspace(0.0, 1.0, n)[None, :, None] * np.array([1.0, 0.5, 0.2])
             + rng.normal(0.0, 0.05, (b, n, 3)))
    r = se3.so3_exp(torch.as_tensor(rng.normal(0.0, 0.3, (b, 3)))).numpy()
    if kind == "reflect":
        r = r * np.array([1.0, 1.0, -1.0])
    t = rng.normal(0.0, 0.2, (b, 3))
    q = np.einsum("bji,bnj->bni", r, p - t[:, None]) + rng.normal(0.0, 0.002, (b, n, 3))
    w = rng.uniform(0.5, 1.5, (b, n))
    if kind == "zero":
        w[:, :n // 2] = 0.0
        w[0] = 0.0
    return p.astype(np.float32), q.astype(np.float32), w.astype(np.float32)


def _sizes(kind):
    # zero-weight sets keep 4 weighted points a fit (2 would leave the
    # rotation about their line undetermined)
    return ((64, 8), (16, 50)) if kind == "zero" else ((64, 4), (16, 50))


@pytest.fixture(scope="module")
def jax_kabsch():
    import jax
    import jax.numpy as jnp

    from texturefusion_tpu.slam import matching as jm
    fit = jax.vmap(jm.kabsch)
    return lambda p, q, w: np.asarray(fit(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_kabsch_matches_jax(jax_kabsch, kind):
    tol = TOL.get(kind, 1e-5)
    for b, n in _sizes(kind):
        p, q, w = point_sets(kind, b, n)
        want = jax_kabsch(p, q, w)
        got = tm.kabsch(torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(w)).numpy()
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=tol, rtol=0)
        np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=tol, rtol=0)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        np.testing.assert_allclose(np.linalg.det(got[:, :3, :3].astype(np.float64)), 1.0,
                                   atol=1e-5)
        if kind == "zero":                     # the all-zero fit: the identity on both
            np.testing.assert_array_equal(got[0], np.eye(4, dtype=np.float32))
            np.testing.assert_array_equal(want[0], np.eye(4, dtype=np.float32))


def test_kabsch_on_cpu_is_the_plain_version():
    p, q, w = (torch.as_tensor(a) for a in point_sets("random", 32, 4))
    before = dict(cuda_kernels.LAUNCHES)
    assert torch.equal(tm.kabsch(p, q, w), tm.kabsch_plain(p, q, w))
    assert cuda_kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["shape", "weights", "dtype", "device"])
def test_k3_wrapper_refuses(bad):
    p, q, w = (torch.as_tensor(a) for a in point_sets("random", 8, 4))
    if bad == "shape":
        p = p[..., :2].contiguous()
    elif bad == "weights":
        w = w[:, :3].contiguous()
    elif bad == "dtype":
        q = q.double()
    with pytest.raises(ValueError):
        cuda_kernels.kabsch_cuda(p, q, w)      # a CPU tensor never reaches the kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rt_err(a: torch.Tensor, b: torch.Tensor):
    a, b = a.double().cpu(), b.double().cpu()
    return (float((a[:, :3, :3] - b[:, :3, :3]).abs().max()),
            float((a[:, :3, 3] - b[:, :3, 3]).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("fits", RANSAC_FITS)
def test_k3_matches_plain_at_ransac_shapes(cuda_device, fits):
    p, q, w = (torch.as_tensor(a) for a in point_sets("random", fits, 4, seed=fits))
    w = torch.ones_like(w)                      # RANSAC's samples weigh 1
    before = cuda_kernels.LAUNCHES["kabsch"]
    got = tm.kabsch(p.to(cuda_device), q.to(cuda_device), w.to(cuda_device))
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES["kabsch"] == before + 1
    assert max(_rt_err(got, tm.kabsch_plain(p, q, w))) <= 2e-5
    assert max(_rt_err(got, tm.kabsch_plain(p.double(), q.double(), w.double()))) <= 1e-6
    det = torch.linalg.det(got[:, :3, :3].double().cpu())
    assert torch.allclose(det, torch.ones_like(det), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_k3_matches_plain_in_float64(cuda_device, kind):
    for b, n in _sizes(kind) + ((400, 4),):
        if kind == "zero" and n == 4:
            n = 8
        p, q, w = (torch.as_tensor(a) for a in point_sets(kind, b, n))
        got = tm.kabsch(p.to(cuda_device), q.to(cuda_device), w.to(cuda_device)).cpu()
        want = tm.kabsch_plain(p.double(), q.double(), w.double())
        assert max(_rt_err(got, want)) <= 1e-6, kind
        det = torch.linalg.det(got[:, :3, :3].double())
        assert torch.allclose(det, torch.ones_like(det), atol=1e-6)
        if kind == "zero":
            assert torch.equal(got[0], torch.eye(4))
