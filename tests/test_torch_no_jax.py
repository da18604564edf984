"""The port runs without jax and without any module of the JAX package
(the GT-pose slice, the tracked SLAM path through chip_smoke.run_tracked
and the pipeline through chip_smoke.run_pipeline, on CPU tensors; the
textured pipeline and its export, and the command line on a TUM
directory and in synthetic mode, also without cv2 or PIL, which the
card's machine lacks; the multi-device layer and dryrun_multichip with
those imports blocked, and the two tools, the fr1-proxy generator with
its --run and the demo, likewise, and the four measurement tools:
sol_report, bench_multichip, profile_stages and profile_frame), and
chip_smoke.py and every tool refuse to run on CUDA without a GPU.

The checks of imports run in fresh subprocesses, so the test session's own jax
import cannot hide an import of jax by the port.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from chip_smoke import load_tool

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import texturefusion_torch
from texturefusion_torch.config import tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.fusion.mesher import IncrementalMesher
from texturefusion_torch.io import synthetic
from texturefusion_torch.models.reconstruction import frame_step
from texturefusion_torch.ops import preprocess, tsdf
cfg = tiny_test_config()
intr = cam.Intrinsics.from_config(cfg.camera)
poses = synthetic.orbit_trajectory(2)
depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses, device="cpu")
vol = TSDFVolume(cfg, device="cpu")
mesher = IncrementalMesher(vol)
for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
    packed = preprocess.pack_frame((d * 5000).astype(np.uint16), (c * 255).astype(np.uint8))
    dep, nrm, q, gray, blur, rgb = preprocess.preprocess_bundle(
        torch.as_tensor(packed), None, intr, depth_scale=5000.0)
    vol.integrate_frame(dep, rgb, q, p, keyframe_id=i)
mesher.update_meshes()
v, f, _, _ = mesher.full_mesh()
batch = tsdf.make_empty_batch(4, 512, "cpu")
frame_step(torch.as_tensor(depths[0]), torch.as_tensor(rgbs[0]), batch,
           torch.zeros(4, 3), torch.ones(4, dtype=torch.bool),
           torch.as_tensor(poses[0]), intr, cfg.tsdf)
assert len(v) > 100 and len(f) > 100, (len(v), len(f))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "texturefusion_tpu")))
print("JAX_MODULES", bad)
"""


TRACKED = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke
from texturefusion_torch.config import tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.eval import loop_closure
from texturefusion_torch.io import synthetic, tum
from texturefusion_torch.ops import hamming, preprocess
from texturefusion_torch.slam import fastba, features, icp, loopclosure, matching, promote
from texturefusion_torch.utils import convert
cfg = tiny_test_config()
intr = cam.Intrinsics.from_config(cfg.camera)
poses = synthetic.orbit_trajectory(5)
depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses, device="cpu")
packed = [preprocess.pack_frame((d * 5000).astype(np.uint16), (c * 255).astype(np.uint8))
          for d, c in zip(depths, rgbs)]
slam, _ = chip_smoke.run_tracked(cfg, packed, "cpu")
ate = tum.ate_rmse(slam.trajectory(), np.stack(poses))
assert all(f.tracking_success for f in slam.frames) and ate < 0.02, ate
d0, d1 = torch.as_tensor(depths[0]), torch.as_tensor(depths[1])
r = icp.icp_refine(d0, preprocess.extract_normal_map(d0, intr), d1, torch.eye(4), intr)
assert torch.isfinite(r.pose).all()
loop_closure.precision_recall(loop_closure.detected_pairs_from_slam(slam), set())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "texturefusion_tpu")))
print("JAX_MODULES", bad)
"""


PIPELINE = r"""
import os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke
from texturefusion_torch.io import tum
cfg = chip_smoke._pipeline_config(small=True, async_fusion=True)
poses, packed = chip_smoke._orbit_frames(cfg, 16)   # promotions: cycles on the worker
pipe, loop, fin = chip_smoke.run_pipeline(cfg, packed, "cpu")
pipe.close()
assert tum.ate_rmse(pipe.trajectory(), np.stack(poses)) < 0.02
assert pipe.stats["keyframes"] >= 2, pipe.stats
with tempfile.TemporaryDirectory() as tmp:
    assert pipe.export_mesh(os.path.join(tmp, "m.ply")) > 100
    pipe.save_trajectory(os.path.join(tmp, "t.txt"))
    pipe.save_stats(tmp)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "texturefusion_tpu")))
print("JAX_MODULES", bad)
"""


TEXTURED = r"""
import os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke
from texturefusion_torch.io import png
cfg = chip_smoke._pipeline_config(small=True, async_fusion=True)
poses, packed = chip_smoke._orbit_frames(cfg, 11)   # three keyframes: cycles on the worker
pipe, loop, fin = chip_smoke.run_pipeline(cfg, packed, "cpu", textured=True)
pipe.close()
tm = pipe.texture
assert len(tm.atlas.patches) > 20 and not tm.atlas.overflowed, len(tm.atlas.patches)
with tempfile.TemporaryDirectory() as tmp:
    obj = pipe.export_textured(tmp)
    lines = open(obj).read().splitlines()
    n_v = sum(ln.startswith("v ") for ln in lines)
    assert n_v == sum(ln.startswith("vt ") for ln in lines) > 100
    assert png.read_png(os.path.join(tmp, "model.png")).shape[1] == tm.atlas.size
bad = sorted(m for m in sys.modules
             if m in ("jax", "cv2", "PIL") or m.startswith(("jax.", "jaxlib", "texturefusion_tpu",
                                                            "cv2.", "PIL.")))
print("JAX_MODULES", bad)
"""


CLI = r"""
import os, runpy, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(2)
import chip_smoke
from texturefusion_torch.config import tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.io import sensors, synthetic
from texturefusion_torch.ops.preprocess import pack_frame
cfg = tiny_test_config()
orig = sensors.SyntheticSensor
sensors.SyntheticSensor = lambda n_frames=30, camera=None, device="cuda": orig(
    n_frames=n_frames, camera=cfg.camera, device=device)
poses = synthetic.orbit_trajectory(4)
depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(),
                                         cam.Intrinsics.from_config(cfg.camera), poses,
                                         device="cpu")
packed = [pack_frame((d * 5000).astype(np.uint16), (c * 255).astype(np.uint8))
          for d, c in zip(depths, rgbs)]
with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "tum")
    chip_smoke.write_tum_dataset(root, cfg.camera, packed, poses)
    chip_smoke.read_back_tum(root, packed)
    for args, textured in (([root, "", "0.05", "0"], True),
                           (["", "", "0.05", "4", "--max-frames", "4"], True)):
        out = os.path.join(tmp, "out" + args[3])
        sys.argv = ["texturefusion_torch"] + args + ["--out", out, "--device", "cpu"]
        try:
            runpy.run_module("texturefusion_torch", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert e.code == 0, e.code
        chip_smoke.check_cli_outputs(out, 4, textured=textured)
bad = sorted(m for m in sys.modules
             if m in ("jax", "cv2", "PIL") or m.startswith(("jax.", "jaxlib", "texturefusion_tpu",
                                                            "cv2.", "PIL.")))
print("JAX_MODULES", bad)
"""


MULTICHIP = r"""
import importlib.abc, sys


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "texturefusion_tpu", "cv2", "PIL"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Blocked())
import torch
torch.set_num_threads(2)
import texturefusion_torch.parallel.ba
import texturefusion_torch.parallel.mesh
import texturefusion_torch.parallel.sharded_tsdf
import texturefusion_torch.models.reconstruction
import texturefusion_torch.fusion.mesher
import texturefusion_torch.texture.manager
import texturefusion_torch.texture.patch
from texturefusion_torch.fusion.pipeline import TexturedPipeline
from texturefusion_torch.parallel.dryrun import dryrun_multichip
r = dryrun_multichip(2, device="cpu")
assert r["pipeline_active"] > 0 and r["shards"] == 2
print("MULTICHIP_OK")
"""


TOOLS = r"""
import importlib.abc, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "texturefusion_tpu", "cv2", "PIL"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Blocked())
import torch
torch.set_num_threads(2)
import chip_smoke
mk = chip_smoke.load_tool("make_tum_proxy")
demo = chip_smoke.load_tool("demo_synthetic")
mk.FR1_CAMERA.update(width=160, height=120, fx=517.3 / 4, fy=516.5 / 4, cx=318.6 / 4,
                     cy=255.3 / 4)
with tempfile.TemporaryDirectory() as tmp:
    root = os.path.join(tmp, "proxy")
    rc = mk.main(["--frames", "4", "--out", root, "--run", "--device", "cpu"])
    assert rc == 0, rc
    res = chip_smoke.check_cli_outputs(os.path.join(root, "out"), 4)
    stats = chip_smoke.cli_run_stats(os.path.join(root, "out"))
    ate, n = mk.trajectory_ate(os.path.join(root, "out"), root)
    assert n == 4 and ate < 0.1 and stats["chunks_created"] >= stats["chunks_meshed"] > 0, (
        ate, n, stats)
    for extra in ([], ["--slam", "--texture"]):
        out = demo.run(["--frames", "3", "--out", os.path.join(tmp, "demo"), "--device", "cpu",
                        *extra])
        assert out["verts"] > 1000 and out["median_mm"] < 30.0, out
    assert {"fused.ply", "slam_fused.ply", "trajectory.txt", "model.obj"} <= set(
        os.listdir(os.path.join(tmp, "demo")))
print("TOOLS_OK")
"""


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("PYTHONSTARTUP", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_slice_never_imports_jax():
    res = _run(["-c", SLICE], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_port_tracked_path_never_imports_jax():
    res = _run(["-c", TRACKED], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_port_pipeline_never_imports_jax():
    """ReconstructionPipeline with the fusion thread, exports included,
    through chip_smoke.run_pipeline on CPU tensors."""
    res = _run(["-c", PIPELINE], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_port_textured_pipeline_never_imports_jax_or_image_libraries():
    """TexturedPipeline with the fusion thread and export_textured, through
    chip_smoke.run_pipeline on CPU tensors: no jax, JAX package, cv2 or
    PIL module loads."""
    res = _run(["-c", TEXTURED], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_port_command_line_never_imports_jax_or_image_libraries():
    """`python -m texturefusion_torch` (runpy, as -m runs it) at the tiny
    camera with --device cpu: on a TUM directory written and read back
    through the port, and in synthetic mode with --max-frames 4, both
    textured, with complete outputs; no jax, JAX package, cv2 or PIL
    module loads."""
    res = _run(["-c", CLI], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_port_multi_device_layer_never_imports_jax_or_image_libraries():
    """parallel/*, models.reconstruction, the texture stage's modules and
    dryrun_multichip(2, "cpu") with any import of jax, the JAX package,
    cv2 or PIL raising."""
    res = _run(["-c", MULTICHIP], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "MULTICHIP_OK" in res.stdout, res.stdout


def test_tools_never_import_jax_or_image_libraries():
    """tools/make_tum_proxy.py (4 frames of the proxy at 160x120, then its
    --run) and tools/demo_synthetic.py (3 frames, ground-truth mode and
    --slam --texture) with --device cpu, with any import of jax, the JAX
    package, cv2 or PIL raising."""
    res = _run(["-c", TOOLS], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TOOLS_OK" in res.stdout, res.stdout[-3000:]


MEASURE = r"""
import importlib.abc, os, sys, tempfile


class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "texturefusion_tpu", "cv2", "PIL"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Blocked())
import torch
torch.set_num_threads(2)
import chip_smoke
tool = chip_smoke.load_tool(sys.argv[1])
small = ["--device", "cpu", "--small", "--n", "1"]
if sys.argv[1] == "sol_report":
    with tempfile.TemporaryDirectory() as tmp:
        assert tool.main(small + ["--no-scaling", "--out", os.path.join(tmp, "r.json")]) == 0
        assert os.path.getsize(os.path.join(tmp, "r.json")) > 0
elif sys.argv[1] == "bench_multichip":
    mesh = tool.make_bench_mesh("cpu", devices=2)
    assert tool.bench_sharded_tsdf(mesh, 64, n_iters=1)["steps_s"] > 0
    assert tool.bench_distributed_ba(mesh, n_iters=1) > 0
    assert tool.bench_ba_scale(mesh, ks=(64,), n_iters=1)[0]["schur_within_tol"]
    assert tool.bench_full_step(mesh, n_iters=1)["n_found"] > 0
else:
    assert tool.main(small) == 0
print("MEASURE_OK")
"""

# each tool's arguments besides --device; "{out}" is a path the run must not create
TOOL_ARGS = {"make_tum_proxy": ["--out", "{out}"], "demo_synthetic": ["--out", "{out}"],
             "sol_report": ["--out", "{out}"], "bench_multichip": ["--cap", "64"],
             "profile_stages": ["--small"], "profile_frame": ["--small"]}


@pytest.mark.parametrize("tool", ["sol_report", "bench_multichip", "profile_stages",
                                  "profile_frame"])
def test_measurement_tools_never_import_jax_or_image_libraries(tool):
    """The four measurement tools at their small sizes with --device cpu
    (bench_multichip's functions on 2 CPU shards), with any import of jax,
    the JAX package, cv2 or PIL raising."""
    res = _run(["-c", MEASURE, tool], ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "MEASURE_OK" in res.stdout, res.stdout[-3000:]


@pytest.mark.parametrize("tool", list(TOOL_ARGS))
def test_tools_on_cuda_without_a_gpu_raise(tool, tmp_path):
    assert not torch.cuda.is_available()
    mod = load_tool(tool)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([a.format(out=out) for a in TOOL_ARGS[tool]] + ["--device", "cuda"])
    assert not os.path.exists(out)


def test_chip_smoke_fails_without_cuda():
    assert not torch.cuda.is_available()
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "CUDA" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path), {"PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
