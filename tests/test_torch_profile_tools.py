"""tools/profile_stages.py and tools/profile_frame.py, the port's stage
profilers, against examples/profile_stages.py and examples/profile_frame.py.

Both run here at the tiny test camera with --device cpu and print every
label of the JAX script, in its order (each label is checked to be the JAX
script's, in its source). On the same two ground-truth orbit frames
(rendered by the JAX package and handed to both), the chunks discovered,
the dirty set and the vertex and triangle totals equal what the JAX
script's steps give at the same size (profile_stages.py:111-139: discovery,
the fused integration, integrate_frame, IncrementalMesher.update_meshes),
and the unique chunk count equals profile_frame.py's.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import load_tool
from texturefusion_tpu.config import CameraConfig as JCameraConfig
from texturefusion_tpu.config import PipelineConfig as JPipelineConfig
from texturefusion_tpu.config import TrackingConfig as JTrackingConfig
from texturefusion_tpu.config import TSDFConfig as JTSDFConfig
from texturefusion_tpu.config import tiny_test_config as jtiny
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.fusion.mesher import IncrementalMesher as JMesher
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops import tsdf as jtsdf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
stages = load_tool("profile_stages")
frame = load_tool("profile_frame")

STAGE_LABELS = ("preprocess_bundle", "extract_features", "register_frames",
                "fuse_depth_into_keyframe", "frame_step_tracked (full)", "n chunks discovered",
                "integrate_frame_fused", "n dirty chunks", "mesher.update_meshes (compile)",
                "mesher.update_meshes (steady)", "total verts / tris",
                "mesh_chunks_pooled[512] device", "counts fetch", "pool row fetch")
FRAME_LABELS = ("tiny op (dispatch latency)", "h2d depth 1.2MB", "h2d rgb 3.7MB",
                "d2h 1024 floats", "preprocess_bundle", "candidate_chunks_unique",
                "n unique chunks", "native touch", "integrate_frame_fused",
                "discover+touch+integrate+sync")


def _labels(text: str) -> list:
    return [ln.split(":")[0].strip() for ln in text.splitlines() if ":" in ln]


@pytest.mark.parametrize("tool, script, labels", [(stages, "profile_stages", STAGE_LABELS),
                                                  (frame, "profile_frame", FRAME_LABELS)])
def test_prints_every_jax_label_in_order(tool, script, labels, capsys):
    with open(os.path.join(ROOT, "examples", script + ".py")) as f:
        source = f.read()
    assert all(label in source for label in labels)
    assert tool.main(["--device", "cpu", "--small", "--n", "1"]) == 0
    printed = _labels(capsys.readouterr().out)
    assert [p for p in printed if p in labels] == list(labels), printed


def _jax_config():
    return JPipelineConfig(camera=dataclasses.replace(jtiny().camera, far_plane=6.0),
                           tracking=JTrackingConfig(blur_threshold=0.0),
                           tsdf=JTSDFConfig(voxel_resolution=0.02, capacity=2048,
                                            max_update_chunks=1024))


@pytest.fixture(scope="module")
def frames():
    config = _jax_config()
    poses = jsyn.orbit_trajectory(2)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(),
                                        jcam.Intrinsics.from_config(config.camera), poses)
    return np.asarray(depths), np.asarray(rgbs), [np.asarray(p) for p in poses]


def test_configs_are_the_jax_scripts_at_the_tiny_camera():
    """profile_stages' config, which profile_frame also runs."""
    cfg = stages.stages_config(small=True)
    assert (cfg.camera.width, cfg.camera.height, cfg.camera.fx) == (160, 120, 120.0)
    assert (cfg.camera.far_plane, cfg.tsdf.voxel_resolution, cfg.tsdf.capacity,
            cfg.tsdf.max_update_chunks) == (6.0, 0.02, 2048, 1024)
    cfg = stages.stages_config()
    assert dataclasses.asdict(cfg.camera) == dataclasses.asdict(JCameraConfig(far_plane=6.0))
    assert (cfg.tsdf.capacity, cfg.tsdf.max_update_chunks) == (16384, 1024)
    assert cfg.tracking.blur_threshold == 0.0


def test_stage_counts_equal_the_jax_scripts(frames):
    depths, rgbs, poses = frames
    got = stages.run("cpu", small=True, n=1, frames=frames, log=lambda m: None)
    config = _jax_config()
    intr = jcam.Intrinsics.from_config(config.camera)
    p0 = jnp.asarray(jpre.pack_frame((depths[0] * 5000).astype(np.uint16),
                                     (rgbs[0] * 255).astype(np.uint8)))
    quality0 = jpre.preprocess_bundle(p0, None, intr, depth_scale=5000.0)[2]
    vol = JVolume(config)
    pose = jnp.asarray(poses[0])
    slots = vol.discover_chunks(depths[0], pose)
    idx, active = vol._padded(slots)
    d0, r0 = jnp.asarray(depths[0]), jnp.asarray(rgbs[0])
    for _ in range(2):      # the tool's call and its one timed call
        out, _, _ = jtsdf.integrate_frame_fused(vol.batch, vol.origins, idx, active, d0, r0,
                                                quality0, pose, jnp.float32(1.0), intr,
                                                config.tsdf)
        vol.batch = out
    vol.integrate_frame(d0, r0, quality0, pose, keyframe_id=0, sign=1.0)
    mesher = JMesher(vol)
    dirty = sorted(vol.dirty_mesh)
    mesher.update_meshes()
    n_verts = sum(len(m[0]) for m in mesher.meshes.values())
    n_tris = sum(len(m[1]) for m in mesher.meshes.values())
    assert got["chunks"] == len(slots) > 100
    assert got["dirty"] == len(dirty)
    assert (got["verts"], got["tris"]) == (n_verts, n_tris)
    assert n_verts > 1000
    assert all(m["ms"] > 0 and m["device_ms"] is None for m in got["stages"].values())


def test_unique_chunks_equal_the_jax_scripts(frames):
    depths, rgbs, poses = frames
    got = frame.run("cpu", small=True, n=1, frame=(depths[0], rgbs[0], poses[0]),
                    log=lambda m: None)
    config = _jax_config()
    _, n = jtsdf.candidate_chunks_unique(jnp.asarray(depths[0]), jnp.asarray(poses[0]),
                                         jcam.Intrinsics.from_config(config.camera),
                                         config.tsdf, max_out=4096)
    assert got["unique"] == int(n) > 100
    assert got["allocator"] in ("NativeChunkAllocator", "PyChunkAllocator")
    assert all(m["ms"] > 0 for m in got["lines"].values())
