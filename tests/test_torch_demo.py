"""The port's demo (tools/demo_synthetic.py) against the JAX package's
(examples/demo_synthetic.py), both run in process at --size small with
the default 8 frames: ground-truth mode, and --slam --texture.

Both see the same frames (the JAX renderer's, handed to the port's
run(frames=); the renderers agree within a uint8 level,
tests/test_torch_slice.py) and the JAX side's bilateral
step is the TPU kernel's in interpret mode. In --slam mode the JAX
pipeline's fetches land at once and its fault 16 is repaired, and the
port takes the JAX package's RANSAC draws, as in tests/test_torch_cli.py.
The JAX script's persistent compilation cache is not switched on.

Tolerances: the same RESULT line and exit code; vertex counts within
0.2% in ground-truth mode and 1% with --slam (tests/test_torch_pipeline.py's
and tests/test_torch_cli.py's); the ATE within 1 mm.
"""

import contextlib
import io
import os
import re
import sys

import jax
import pytest
import torch

from chip_smoke import load_tool
from test_torch_cli import _with_draws
from test_torch_gcslam import jax_pipelined_tracker
from test_torch_pipeline import _pallas_bilateral
from texturefusion_tpu.config import CameraConfig as JCameraConfig
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.io import tum as jtum
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.utils import cache as jcache
from texturefusion_torch.fusion import pipeline as tpipeline

torch.set_num_threads(2)

MODES = {"gt": [], "slam": ["--slam", "--texture"]}
VERTS_FRAC = {"gt": 0.002, "slam": 0.01}
ATE_MM = 1.0


def _jax_frames():
    """The small demo's frames as the JAX script renders them."""
    camera = JCameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
                           far_plane=6.0)
    return jsyn.render_sequence(jsyn.BoxRoomScene(), jcam.Intrinsics.from_config(camera),
                                jsyn.orbit_trajectory(8))


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _result_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("RESULT:")]


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """{mode: (JAX exit code, JAX stdout, JAX ATE mm, port result, port stdout,
    port output directory)}."""
    tmp = tmp_path_factory.mktemp("demo")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
        jdemo = load_tool("demo_synthetic", "examples")
        tdemo = load_tool("demo_synthetic")
        jax_pipelined_tracker(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        mp.setattr(tpipeline, "ReconstructionPipeline",
                   _with_draws(tpipeline.ReconstructionPipeline))
        mp.setattr(tpipeline, "TexturedPipeline", _with_draws(tpipeline.TexturedPipeline))
        ates = []
        ate_rmse = jtum.ate_rmse
        mp.setattr(jtum, "ate_rmse", lambda *a: ates.append(ate_rmse(*a)) or ates[-1])
        jax.clear_caches()
        frames = _jax_frames()
        try:
            for mode, extra in MODES.items():
                argv = ["--size", "small"] + extra
                mp.setattr(sys, "argv", ["demo_synthetic.py", *argv,
                                         "--out", str(tmp / f"jax_{mode}")])
                jrc, jtext = _run(jdemo.main)
                t_out = str(tmp / f"port_{mode}")
                tres, ttext = _run(lambda: tdemo.run(argv + ["--out", t_out, "--device", "cpu"],
                                                     frames=frames))
                out[mode] = (jrc, jtext, ates[-1] * 1e3 if extra else None, tres, ttext, t_out)
        finally:
            jax.clear_caches()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_demo_matches_jax(demos, mode):
    jrc, jtext, jate, tres, ttext, t_out = demos[mode]
    assert _result_line(ttext) == _result_line(jtext) == ["RESULT: PASS"]
    assert tres["rc"] == jrc == 0
    jverts = int(re.search(r"(\d+) verts", jtext).group(1))
    assert tres["verts"] > 1000 and abs(tres["verts"] - jverts) <= VERTS_FRAC[mode] * jverts, (
        tres["verts"], jverts)
    if mode == "slam":
        assert abs(tres["ate_mm"] - jate) <= ATE_MM, (tres["ate_mm"], jate)
        written = {"slam_fused.ply", "trajectory.txt", "model.obj", "model.mtl", "model.png"}
    else:
        assert tres["ate_mm"] is None
        written = {"fused.ply"}
    assert written <= set(os.listdir(t_out)), os.listdir(t_out)
