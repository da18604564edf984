"""The CUDA kernels against their plain PyTorch versions, and their bindings.

Tests marked `cuda` need an NVIDIA GPU and skip without one; they import
no jax, so on the GPU machine they run without the repo's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -m cuda

The unmarked tests check, on any machine, what the wrappers refuse and
that the ctypes parameter block matches the C struct.
"""

import os
import re

import numpy as np
import pytest
import torch

from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig, \
    tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import cuda_kernels, preprocess, tsdf

torch.set_num_threads(2)

CONFIG = PipelineConfig(
    camera=CameraConfig(width=128, height=96, fx=100.0, fy=100.0, cx=63.5, cy=47.5,
                        far_plane=6.0),
    tsdf=TSDFConfig(voxel_resolution=0.05, capacity=64, max_update_chunks=16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _wall(seed, pre_integrated, device):
    cfg, intr = CONFIG.tsdf, cam.Intrinsics.from_config(CONFIG.camera)
    s1, v = cfg.capacity + 1, 512
    rng = np.random.default_rng(seed)
    d = (2.0 + rng.normal(0, 0.02, (intr.height, intr.width))).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    rgb = rng.random((intr.height, intr.width, 3)).astype(np.float32)
    q = rng.random((intr.height, intr.width)).astype(np.float32)
    if pre_integrated:
        w = rng.integers(0, 4, (s1, v)).astype(np.float32)
        rows = [rng.normal(0, 0.05, (s1, v)).astype(np.float32), w,
                (rng.random((s1, v, 3)) * 90).astype(np.float32), w.copy()]
    else:
        rows = [np.full((s1, v), 999.0, np.float32), np.zeros((s1, v), np.float32),
                np.zeros((s1, v, 3), np.float32), np.zeros((s1, v), np.float32)]
    ids = np.asarray([(x, y, 4) for x in range(-2, 2) for y in range(-1, 2)], np.int32)
    idx = np.concatenate([np.arange(len(ids)), np.full(16 - len(ids), cfg.capacity)])
    origins = np.zeros((s1, 3), np.float32)
    origins[:len(ids)] = ids * 0.4
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (tsdf.ChunkBatch(*(t(a) for a in rows)), t(origins), t(idx.astype(np.int64)),
            t(np.arange(16) < len(ids)), t(d), t(rgb), t(q), torch.eye(4, device=device),
            intr, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_bilateral_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, (120, 160)).astype(np.float32)
    d[:, 80:] += 1.0
    d[rng.random(d.shape) < 0.05] = 0.0
    x = torch.as_tensor(d, device=cuda_device)
    before = cuda_kernels.LAUNCHES["bilateral"]
    got = preprocess.bilateral_filter(x)
    assert cuda_kernels.LAUNCHES["bilateral"] == before + 1
    torch.testing.assert_close(got, preprocess.bilateral_filter_plain(x), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sign,pre,with_color", [(1.0, False, True), (1.0, True, True),
                                                 (-1.0, True, True), (1.0, True, False)])
def test_tsdf_kernel_matches_plain(cuda_device, sign, pre, with_color):
    kb, *args = _wall(0, pre, cuda_device)
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    before = cuda_kernels.LAUNCHES["tsdf_integrate"]
    kq, ku = tsdf.integrate_frame_fused(kb, *args[:7], sign, *args[7:],
                                        with_color=with_color)
    assert cuda_kernels.LAUNCHES["tsdf_integrate"] == before + 1
    pq, pu = tsdf.integrate_frame_fused_plain(pb, *args[:7], sign, *args[7:],
                                              with_color=with_color)
    cap = CONFIG.tsdf.capacity
    for a, b, (rtol, atol) in zip(kb, pb, ((1e-5, 1e-5), (1e-6, 1e-6), (1e-4, 1e-3),
                                           (1e-6, 1e-6))):
        torch.testing.assert_close(a[:cap], b[:cap], rtol=rtol, atol=atol)
    torch.testing.assert_close(kq[:12], pq[:12], rtol=1e-4, atol=1e-2)
    assert torch.equal(ku[:12], pu[:12]) and bool(ku.any())
    assert not bool(ku[12:].any()) and bool((kq[12:] == 0).all())


@pytest.mark.cuda
def test_slice_gpu_matches_cpu(cuda_device):
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.io import synthetic
    config = tiny_test_config()
    intr = cam.Intrinsics.from_config(config.camera)
    poses = synthetic.orbit_trajectory(2)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses)
    vols = []
    for dev in ("cpu", cuda_device):
        vol = TSDFVolume(config, device=dev)
        for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
            dep, _, q, _, _, rgb = preprocess.preprocess_bundle(
                torch.as_tensor(d, device=dev), torch.as_tensor(c, device=dev), intr)
            vol.integrate_frame(dep, rgb, q, p, keyframe_id=i)
        vols.append(vol)
    np.testing.assert_array_equal(vols[0].ids, vols[1].ids)
    s = vols[0].active_slots()
    torch.testing.assert_close(vols[1].batch.weight[s].cpu(), vols[0].batch.weight[s])


def test_wrappers_refuse_cpu_and_wrong_types():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.bilateral_cuda(torch.zeros(8, 8))
    kb, *args = _wall(0, False, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.tsdf_integrate_cuda(*kb, args[1], args[2], args[0][args[1]],
                                         tsdf.pack_image(args[3], args[4], args[5]),
                                         args[6], 1.0, args[7], args[8])


def test_params_struct_matches_cuda_source():
    with open(os.path.join(os.path.dirname(cuda_kernels.__file__), "..", "csrc",
                           "tsdf_integrate.cu")) as f:
        src = f.read()
    body = re.search(r"struct TsdfParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(None, 1)
            fields += [(n.strip(), ctype) for n in names.split(",")]
    ctypes_map = {"float": "c_float", "int": "c_int"}
    assert [(n, ctypes_map[t]) for n, t in fields] == [
        (n, t.__name__) for n, t in cuda_kernels.TsdfParams._fields_]


def test_cpu_tensors_take_the_plain_path():
    before = dict(cuda_kernels.LAUNCHES)
    x = torch.rand(16, 16) + 1.0
    torch.testing.assert_close(preprocess.bilateral_filter(x),
                               preprocess.bilateral_filter_plain(x))
    kb, *args = _wall(1, True, "cpu")
    tsdf.integrate_frame_fused(kb, *args[:7], 1.0, *args[7:])
    assert cuda_kernels.LAUNCHES == before
