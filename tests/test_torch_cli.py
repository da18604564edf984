"""The port's command line (`python -m texturefusion_torch`) against the
JAX package's.

Both `main`s run in process on the same inputs: a small TUM directory
written as tests/test_tum_format.py writes it (tiny_test_config's camera
in calib.txt), and the synthetic scene with the sensor cut to a few
frames at that camera, as tests/test_checkpoint_cli.py does, each frame
rendered by the JAX package (the renderers agree to within a uint8
level, tests/test_torch_slice.py; the draws here must see equal frames).
Both read one settings file (fewer features and RANSAC rounds, to keep
the CPU run short). Both CLIs run their real default pipelines: the
tracker pipelined at depth 2 with deferred promotion and the stale-frame
refinement, the discovery prefetch, and the cycle results consumed a
cycle late (async_cycle_results). On the JAX side only these are
patched: every fetch lands at once, the deferred probe is repaired as
the port's (test_torch_gcslam.jax_pipelined_tracker, ROADMAP fault 16),
and the bilateral step is the TPU kernel's in interpret mode. The port
takes the JAX package's RANSAC draws (tests/test_torch_draws.py) and
runs with --device cpu.

Tolerances: the same keyframes, every trajectory position within 1 mm,
the same output files, and the welded PLY's vertex count within 1% (the
meshes' own tolerance in tests/test_torch_pipeline.py is 0.2% before the
weld, which can merge or split a few more).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import JaxKeyDraws, tracked2_draws
from test_torch_gcslam import jax_pipelined_tracker
from test_torch_pipeline import _pallas_bilateral
from test_tum_format import _write_dataset
from texturefusion_tpu import __main__ as jmain
from texturefusion_tpu.config import PipelineConfig as JPipelineConfig
from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.io import sensors as jsensors
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_torch import __main__ as tmain
from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.fusion import pipeline as tpipeline
from texturefusion_torch.io import png
from texturefusion_torch.io import sensors as tsensors
from texturefusion_torch.io.prefetch import prefetch_frames
from texturefusion_torch.io import synthetic as tsynthetic
from texturefusion_torch.texture import manager as tmanager

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
JSCENE = jsyn.BoxRoomScene()
N_DATASET = 8
N_SYNTHETIC = 6
VERTS_FRAC = 0.01
SETTINGS = "max_feature_num: 256\nransac_maximum_iterations: 128\n"
YAML = ("%YAML:1.0\n\nmax_feature_num: 800\n"
        "minimum_disparity:        0.2\n"
        "hamming_distance_threshold:       40\n"
        "far_plane_distance:               5\n")


def _with_draws(cls):
    class Drawn(cls):
        def __init__(self, config, device="cuda"):
            super().__init__(config, device=device, draw_fn=JaxKeyDraws(),
                             frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                                  config.tracking))
    return Drawn


def _jax_render(scene, intr, pose):
    """The port's render_frame, drawn by the JAX renderer."""
    d, c = jsyn.render_frame(JSCENE, JI, jnp.asarray(pose.cpu().numpy()))
    return torch.as_tensor(np.array(d)), torch.as_tensor(np.array(c))


def _small_sensors(mp):
    j_orig, t_orig = jsensors.SyntheticSensor, tsensors.SyntheticSensor
    mp.setattr(tsynthetic, "render_frame", _jax_render)
    mp.setattr(jsensors, "SyntheticSensor",
               lambda n_frames=30, camera=None: j_orig(n_frames=N_SYNTHETIC, camera=CFG.camera))
    mp.setattr(tsensors, "SyntheticSensor",
               lambda n_frames=30, camera=None, device="cuda": t_orig(
                   n_frames=N_SYNTHETIC, camera=CFG.camera, device=device))


def _files(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


def _ply_vertices(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[2])
    raise AssertionError(f"{path}: no vertex count")


def _positions(path):
    return np.loadtxt(path)[:, 1:4]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each CLI in dataset mode (textured) and synthetic mode (--no-texture):
    {mode: (JAX output dir, port output dir)}."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "tum")
    _write_dataset(root, n=N_DATASET)
    settings = tmp / "settings.yaml"
    settings.write_text(SETTINGS)
    args = {"dataset": [root, str(settings), "0.05", "0"],
            "synthetic": ["", str(settings), "0.05", "4", "--max-frames", str(N_SYNTHETIC),
                          "--no-texture"]}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_pipelined_tracker(mp)
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        mp.setattr(tpipeline, "ReconstructionPipeline",
                   _with_draws(tpipeline.ReconstructionPipeline))
        mp.setattr(tpipeline, "TexturedPipeline", _with_draws(tpipeline.TexturedPipeline))
        _small_sensors(mp)
        jax.clear_caches()
        try:
            for mode, a in args.items():
                j_out, t_out = str(tmp / f"jax_{mode}"), str(tmp / f"port_{mode}")
                assert jmain.main(a + ["--out", j_out]) == 0
                assert tmain.main(a + ["--out", t_out, "--device", "cpu"]) == 0
                out[mode] = (j_out, t_out)
        finally:
            jax.clear_caches()
    return out


def compare_cli_outputs(j_out, t_out, n, textured):
    """The port's CLI outputs against the JAX CLI's, with this file's
    tolerances: the same files and keyframes, every trajectory position
    within 1 mm, the welded PLY's vertices within 1%, the keyframe dumps'
    intrinsics equal and poses within 2e-3, their images equal."""
    assert _files(t_out) == _files(j_out)
    kf = [f for f in _files(t_out) if f.startswith("keyframes/")]
    assert len(kf) >= 2 and len(kf) % 2 == 0, kf
    pj = _positions(os.path.join(j_out, "trajectory.txt"))
    pt = _positions(os.path.join(t_out, "trajectory.txt"))
    assert pj.shape == pt.shape == (n, 3)
    assert np.abs(pt - pj).max() <= 1e-3, np.abs(pt - pj).max()
    vj, vt = (_ply_vertices(os.path.join(d, "fused.ply")) for d in (j_out, t_out))
    assert vt > 100 and abs(vt - vj) <= VERTS_FRAC * vj, (vt, vj)
    for name in (f for f in kf if f.endswith(".cam")):
        cj = np.loadtxt(os.path.join(j_out, name))
        ct = np.loadtxt(os.path.join(t_out, name))
        np.testing.assert_allclose(ct[12:], cj[12:], rtol=0, atol=0)     # fx fy cx cy
        np.testing.assert_allclose(ct[:12], cj[:12], rtol=0, atol=2e-3)  # the 3x4 pose
    for name in (f for f in kf if f.endswith(".png")):       # RGB order, as cv2 wrote it
        np.testing.assert_array_equal(png.read_png(os.path.join(t_out, name)),
                                      png.read_png(os.path.join(j_out, name)))
    if textured:
        assert {"model.obj", "model.mtl", "model.png"} <= set(_files(t_out))


@pytest.mark.parametrize("mode", ["dataset", "synthetic"])
def test_cli_matches_jax(cli_runs, mode):
    j_out, t_out = cli_runs[mode]
    n = N_DATASET if mode == "dataset" else N_SYNTHETIC
    compare_cli_outputs(j_out, t_out, n, textured=mode == "dataset")


def test_params_yaml_matches_jax(tmp_path):
    """test_checkpoint_cli.py::test_params_yaml_loading's file, through both
    packages' parsers and onto both packages' configs."""
    yaml = tmp_path / "settings.yaml"
    yaml.write_text(YAML)
    params = tmain.load_params_yaml(str(yaml))
    assert params == jmain.load_params_yaml(str(yaml))
    assert params["max_feature_num"] == 800
    got = tmain.apply_params(PipelineConfig(), params)
    want = jmain.apply_params(JPipelineConfig(), params)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.tracking.max_features == 800 and got.tracking.hamming_threshold == 40
    assert got.tracking.minimum_disparity == 0.2 and got.camera.far_plane == 5.0
    cfg = tmain.make_config(0.03, str(yaml))
    assert cfg.tsdf.voxel_resolution == 0.03 and cfg.tracking.max_features == 800
    assert tmain.load_params_yaml("") == {}


def _tiny_synthetic(mp):
    orig = tsensors.SyntheticSensor
    mp.setattr(tsensors, "SyntheticSensor",
               lambda n_frames=30, camera=None, device="cuda": orig(
                   n_frames=4, camera=CFG.camera, device=device))


def test_cuda_device_without_a_gpu_raises(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["", "", "0.05", "4", "--out", str(tmp_path), "--max-frames", "2"])
    assert not os.listdir(tmp_path)


def test_texture_export_errors_propagate(tmp_path, monkeypatch):
    """A RuntimeError from the textured export (a failed kernel launch is
    one) leaves main; only "no textured chunks" skips the export."""
    _tiny_synthetic(monkeypatch)

    def boom(self, mesher, out_dir, name="model"):
        raise RuntimeError("device-side assert triggered")

    monkeypatch.setattr(tmanager.TextureManager, "export_textured", boom)
    with pytest.raises(RuntimeError, match="device-side assert"):
        tmain.main(["", "", "0.05", "4", "--out", str(tmp_path / "a"), "--max-frames", "4",
                    "--device", "cpu"])

    def empty(self, mesher, out_dir, name="model"):
        raise tmanager.NoTexturedChunks("no textured chunks to export")

    monkeypatch.setattr(tmanager.TextureManager, "export_textured", empty)
    assert tmain.main(["", "", "0.05", "4", "--out", str(tmp_path / "b"), "--max-frames", "4",
                       "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "b" / "fused.ply")
    assert not os.path.exists(tmp_path / "b" / "model.obj")


def test_fusion_thread_is_joined(tmp_path, monkeypatch):
    """A pipeline with the fusion thread (set from code) is closed before
    main returns."""
    _tiny_synthetic(monkeypatch)
    made = []
    orig = tmain.make_config

    def threaded(resolution, params_file):
        cfg = orig(resolution, params_file)
        return cfg.replace(parallel=dataclasses.replace(cfg.parallel, async_fusion=True))

    cls = tpipeline.ReconstructionPipeline

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tmain, "make_config", threaded)
    monkeypatch.setattr(tpipeline, "ReconstructionPipeline", Recorded)
    assert tmain.main(["", "", "0.05", "4", "--out", str(tmp_path), "--max-frames", "4",
                       "--no-texture", "--device", "cpu"]) == 0
    assert len(made) == 1 and made[0]._fusion_executor is None
    assert made[0].config.parallel.async_fusion


def test_prefetch_frames_one_ahead_on_cpu():
    """On a CPU device the arrays pass through as tensors (no pinning), the
    tuples keep their shape, keep_host appends the host tuple, and the
    next frame is taken before the current one is handed out."""
    taken = []

    def frames():
        for i in range(3):
            taken.append(i)
            yield float(i), np.full((2, 3, 5), i, np.uint8), None

    out = []
    for ts, frame, rgb, host in prefetch_frames(frames(), "cpu", keep_host=True):
        out.append(ts)
        assert taken == list(range(min(int(ts) + 2, 3)))
        assert isinstance(frame, torch.Tensor) and not frame.is_pinned()
        assert frame.device.type == "cpu" and rgb is None
        assert host[0] == ts and isinstance(host[1], np.ndarray)
        np.testing.assert_array_equal(frame.numpy(), host[1])
    assert out == [0.0, 1.0, 2.0]
    assert [len(t) for t in prefetch_frames(frames(), "cpu")] == [3, 3, 3]
    assert list(prefetch_frames(iter(()), "cpu")) == []
