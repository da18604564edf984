"""The port's fr1-proxy generator (tools/make_tum_proxy.py) against the JAX
package's (examples/make_tum_proxy.py), and both command lines on the
JAX-generated proxy.

At test scale, as tests/test_ate_proxy_cli.py runs it: 160x120 with the
fr1 camera scaled by 1/4 (the distortion kept), 10 frames. Tolerances:
- the blur against cv2.GaussianBlur(c, (0, 0), 3.0): atol 1e-6;
- the fr1 undistortion against the JAX package's on every VGA pixel:
  atol 1e-4 (tests/test_torch_core.py's), and its inverse within 1e-3 px;
- the generated directories: the same files and the same associate.txt,
  calib.txt, rgb.txt and depth.txt; groundtruth.txt within one step of
  its sixth decimal (1e-6); the decoded depth PNGs equal on at least
  99.9% of the pixels and within one step (0.2 mm) everywhere; RGB within
  one level, and equal on at least 99.5% of the values (the renderers'
  tolerance, tests/test_torch_slice.py). The two renderers differ in
  their last bits, which move a quantised depth or a truncated colour by
  a step;
- the CLIs: tests/test_torch_cli.py's patches and tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import load_tool
from test_torch_cli import SETTINGS, _files, _with_draws, compare_cli_outputs
from test_torch_gcslam import jax_pipelined_tracker
from test_torch_pipeline import _pallas_bilateral
from texturefusion_tpu import __main__ as jmain
from texturefusion_tpu.config import CameraConfig as JCameraConfig
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_torch import __main__ as tmain
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.fusion import pipeline as tpipeline
from texturefusion_torch.io import png

torch.set_num_threads(2)

N_FRAMES = 10
SMALL = dict(width=160, height=120, fx=517.3 / 4, fy=516.5 / 4, cx=318.6 / 4, cy=255.3 / 4)
TEXT_FILES = ("associate.txt", "calib.txt", "rgb.txt", "depth.txt")


JMK = load_tool("make_tum_proxy", "examples")
TMK = load_tool("make_tum_proxy")


def test_blur_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for shape in ((120, 160, 3), (31, 17, 3), (48, 64)):
        img = rng.random(shape).astype(np.float32)
        got = TMK.gaussian_blur(img, 3.0)
        assert got.dtype == np.float32 and got.shape == img.shape
        np.testing.assert_allclose(got, cv2.GaussianBlur(img, (0, 0), 3.0), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(TMK.gaussian_taps(3.0),
                                  cv2.getGaussianKernel(25, 3.0, cv2.CV_32F).ravel())


def test_fr1_undistortion_matches_jax():
    """The port's iterative inverse at the proxy's distortion (d0 0.12,
    d1 -0.18, d2 -0.004, d3 0.003, over 5 px of correction at the border)
    against the JAX package's, and distorting its result gives the pixel
    back."""
    cfg = JCameraConfig(**TMK.FR1_CAMERA)
    ji, ti = jcam.Intrinsics.from_config(cfg), tcam.Intrinsics.from_config(cfg)
    u, v = np.meshgrid(np.arange(cfg.width, dtype=np.float32),
                       np.arange(cfg.height, dtype=np.float32))
    uv = np.stack([u, v], axis=-1)
    got = tcam.undistort_points(ti, torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcam.undistort_points(ji, jnp.asarray(uv))),
                               rtol=0, atol=1e-4)
    assert np.abs(got - uv).max() > 5.0
    xd, yd = tcam.distort_normalized(ti, torch.as_tensor((got[..., 0] - ti.cx) / ti.fx),
                                     torch.as_tensor((got[..., 1] - ti.cy) / ti.fy))
    back = np.stack([xd.numpy() * ti.fx + ti.cx, yd.numpy() * ti.fy + ti.cy], axis=-1)
    assert np.abs(back - uv).max() < 1e-3


@pytest.fixture(scope="module")
def proxies(tmp_path_factory):
    """Both generators at test scale and seed 11: (JAX dir, port dir)."""
    tmp = tmp_path_factory.mktemp("proxy")
    out = str(tmp / "jax"), str(tmp / "port")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JMK, TMK):
            for k, v in SMALL.items():
                mp.setitem(mod.FR1_CAMERA, k, v)
        JMK.generate(out[0], n_frames=N_FRAMES)
        TMK.generate(out[1], n_frames=N_FRAMES, device="cpu")
    return out


def _pngs(root, kind):
    return np.stack([png.read_png(os.path.join(root, f))
                     for f in _files(root) if f.startswith(kind + "/")]).astype(np.int64)


def test_generator_matches_jax(proxies):
    j, t = proxies
    assert _files(t) == _files(j)
    assert len([f for f in _files(t) if f.endswith(".png")]) == 2 * N_FRAMES
    for name in TEXT_FILES:
        with open(os.path.join(j, name)) as fj, open(os.path.join(t, name)) as ft:
            assert ft.read() == fj.read(), name
    gj, gt = (np.loadtxt(os.path.join(d, "groundtruth.txt")) for d in proxies)
    assert gj.shape == gt.shape == (N_FRAMES, 8)
    steps = np.abs(np.round(gt * 1e6) - np.round(gj * 1e6))     # units of the sixth decimal
    assert steps.max() <= 1, steps.max()
    dj, dt = _pngs(j, "depth"), _pngs(t, "depth")
    assert dj.shape == dt.shape == (N_FRAMES, 120, 160)
    assert (dj > 0).mean() > 0.9
    assert (dt == dj).mean() >= 0.999, (dt == dj).mean()
    assert np.abs(dt - dj).max() <= 1
    cj, ct = _pngs(j, "rgb"), _pngs(t, "rgb")
    assert cj.shape == ct.shape == (N_FRAMES, 120, 160, 3)
    assert (ct == cj).mean() >= 0.995, (ct == cj).mean()
    assert np.abs(ct - cj).max() <= 1


def test_cli_on_the_jax_proxy_matches_jax(proxies, tmp_path):
    """Both command lines on the JAX-generated proxy, textured, with
    tests/test_torch_cli.py's patches (the JAX fetches landed, its fault 16
    repaired, its bilateral step the TPU kernel's; the JAX draws injected
    into the port) and its settings file."""
    root = proxies[0]
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS)
    args = [root, str(settings), "0.05", "0"]
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        mp.setattr(tpipeline, "ReconstructionPipeline",
                   _with_draws(tpipeline.ReconstructionPipeline))
        mp.setattr(tpipeline, "TexturedPipeline", _with_draws(tpipeline.TexturedPipeline))
        jax.clear_caches()
        try:
            assert jmain.main(args + ["--out", j_out]) == 0
            assert tmain.main(args + ["--out", t_out, "--device", "cpu"]) == 0
        finally:
            jax.clear_caches()
    compare_cli_outputs(j_out, t_out, N_FRAMES, textured=True)
