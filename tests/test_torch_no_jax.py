"""The port runs without jax, and chip_smoke.py refuses to run without a GPU.

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
depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses)
vol = TSDFVolume(cfg)
mesher = IncrementalMesher(vol)
for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
    packed = preprocess.pack_frame((d * 5000).astype(np.uint16), (c * 255).astype(np.uint8))
    dep, nrm, q, gray, blur, rgb = preprocess.preprocess_bundle(
        torch.as_tensor(packed), None, intr, depth_scale=5000.0)
    vol.integrate_frame(dep, rgb, q, p, keyframe_id=i)
mesher.update_meshes()
v, f, _, _ = mesher.full_mesh()
batch = tsdf.make_empty_batch(4, 512)
frame_step(torch.as_tensor(depths[0]), torch.as_tensor(rgbs[0]), batch,
           torch.zeros(4, 3), torch.ones(4, dtype=torch.bool),
           torch.as_tensor(poses[0]), intr, cfg.tsdf)
assert len(v) > 100 and len(f) > 100, (len(v), len(f))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
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
