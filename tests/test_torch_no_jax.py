"""The port runs without jax and without any module of the JAX package
(the GT-pose slice, the tracked SLAM path through chip_smoke.run_tracked
and the pipeline through chip_smoke.run_pipeline, on CPU tensors; the
textured pipeline and its export also without cv2 or PIL, which the
card's machine lacks), and chip_smoke.py refuses to run without a GPU.

Both checks run in fresh subprocesses, so the test session's own jax
import cannot hide an import of jax by the port.
"""

import os
import shutil
import subprocess
import sys

import torch

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
