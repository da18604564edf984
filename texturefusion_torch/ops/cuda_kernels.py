"""Build, bind and launch the port's hand-written CUDA kernels.

The two TPU kernels of the JAX package have Hopper counterparts here:

  K1  csrc/bilateral.cu        replaces ops/pallas_kernels.py bilateral_filter_pallas
  K2  csrc/tsdf_integrate.cu   replaces examples/pallas_voxel_kernel.py integrate_rows_pallas

Both are compiled on first use by nvcc into one shared library with a
plain C interface (texturefusion_torch/_build/, named by a hash of the
sources so an edited source rebuilds) and bound with ctypes: pointers,
the current stream and scalars cross as c_void_p / c_int / c_float.
Each launch function returns cudaGetLastError() and the wrapper raises
if it is not 0. The wrappers check device, dtype, shape and contiguity,
allocate their outputs with torch.empty and never synchronise.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one
right after its launch and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.core import geometry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
SOURCES = ("bilateral.cu", "tsdf_integrate.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

LAUNCHES = {"bilateral": 0, "tsdf_integrate": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME   # env, PATH, or the default install
    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


class TsdfParams(ctypes.Structure):
    """Mirror of `TsdfParams` in csrc/tsdf_integrate.cu (field order matters)."""

    _fields_ = [(n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy")] + [
        ("width", ctypes.c_int), ("height", ctypes.c_int)] + [
        (n, ctypes.c_float) for n in (
            "near_plane", "far_plane", "trunc_quad", "trunc_linear",
            "trunc_const", "trunc_scale", "res_diag", "color_band",
            "integration_weight", "min_weight", "color_saturation", "sign")] + [
        ("with_color", ctypes.c_int), ("n_rows", ctypes.c_int)]


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_CSRC, s) for s in SOURCES]
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        path = os.path.join(_BUILD, f"libtf_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *srcs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            if verbose:
                print(res.stderr.strip())
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tf_bilateral_launch.restype = i
        lib.tf_bilateral_launch.argtypes = [p, p, p, i, i, i, f, p]
        lib.tf_tsdf_integrate_launch.restype = i
        lib.tf_tsdf_integrate_launch.argtypes = [p] * 12 + [
            ctypes.POINTER(TsdfParams), i, p]
        _lib = lib
        return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             shape: Optional[Tuple[int, ...]] = None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


_device_consts: dict = {}


def _device_const(key, make) -> torch.Tensor:
    """Small per-device constant tables (spatial weights, centroids)."""
    t = _device_consts.get(key)
    if t is None:
        t = _device_consts[key] = make()
    return t


def spatial_weights(radius: int, sigma_space: float) -> np.ndarray:
    """(2r+1)² bilateral spatial weights, dy-major, computed in float64
    and rounded once, as the TPU kernel computes them."""
    r = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space * sigma_space)
                  ).astype(np.float32).reshape(-1)


def bilateral_cuda(depth: torch.Tensor, radius: int = 4,
                   sigma_space: float = 4.5, sigma_range: float = 0.03) -> torch.Tensor:
    """K1: [H, W] f32 depth on the card -> [H, W] filtered depth."""
    _require(depth, "depth", torch.float32)
    if depth.dim() != 2:
        raise ValueError(f"depth must be [H, W], got {tuple(depth.shape)}")
    lib = build()
    h, w = depth.shape
    ws = _device_const(("ws", depth.device, radius, sigma_space), lambda: torch.as_tensor(
        spatial_weights(radius, sigma_space), device=depth.device))
    out = torch.empty_like(depth)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    rc = lib.tf_bilateral_launch(depth.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                 h, w, radius,
                                 float(np.float32(1.0 / (2.0 * sigma_range * sigma_range))),
                                 stream)
    _check(rc, "bilateral")
    LAUNCHES["bilateral"] += 1
    return out


def tsdf_integrate_cuda(sdf: torch.Tensor, weight: torch.Tensor,
                        color: torch.Tensor, ccnt: torch.Tensor,
                        idx: torch.Tensor, active: torch.Tensor,
                        origins: torch.Tensor, image: torch.Tensor,
                        world_to_cam: torch.Tensor, sign: float,
                        intr, cfg, with_color: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: update rows sdf/weight/ccnt [S+1, 512], color [S+1, 512, 3]
    IN PLACE at the slots `idx` [U] (int64; padding lanes inactive).
    origins [U, 3] are the listed rows' chunk origins, image [H, W, 5]
    is depth | rgb×255 | quality, world_to_cam [4, 4]. Returns
    (quality [U] f32, updated [U] bool)."""
    n_rows, n_vox = sdf.shape
    if n_vox != cfg.chunk_size ** 3 or n_vox != 512:
        raise ValueError(f"rows must be [S+1, 512], got {tuple(sdf.shape)}")
    u = idx.shape[0]
    _require(sdf, "sdf", torch.float32)
    _require(weight, "weight", torch.float32, (n_rows, n_vox))
    _require(color, "color", torch.float32, (n_rows, n_vox, 3))
    _require(ccnt, "color_count", torch.float32, (n_rows, n_vox))
    _require(idx, "idx", torch.int64, (u,))
    _require(active, "active", torch.bool, (u,))
    _require(origins, "origins", torch.float32, (u, 3))
    _require(image, "image", torch.float32, (intr.height, intr.width, 5))
    _require(world_to_cam, "world_to_cam", torch.float32, (4, 4))
    lib = build()
    dev = sdf.device
    cent = _device_const(("cent", dev, cfg.chunk_size, cfg.voxel_resolution),
                         lambda: torch.as_tensor(geometry.voxel_centroids(
                             cfg.chunk_size, cfg.voxel_resolution), device=dev))
    res_diag = float(np.sqrt(3.0)) * cfg.voxel_resolution
    params = TsdfParams(
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        width=intr.width, height=intr.height,
        near_plane=intr.near, far_plane=intr.far,
        trunc_quad=cfg.truncation_quad, trunc_linear=cfg.truncation_linear,
        trunc_const=cfg.truncation_const, trunc_scale=cfg.truncation_scale,
        res_diag=res_diag, color_band=res_diag * 0.5 + cfg.color_band_pad,
        integration_weight=cfg.integration_weight, min_weight=cfg.min_weight,
        color_saturation=cfg.color_saturation, sign=float(sign),
        with_color=int(with_color), n_rows=n_rows)
    quality = torch.empty(u, dtype=torch.float32, device=dev)
    updated = torch.empty(u, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.tf_tsdf_integrate_launch(
        sdf.data_ptr(), weight.data_ptr(), color.data_ptr(), ccnt.data_ptr(),
        idx.data_ptr(), active.data_ptr(), origins.data_ptr(), image.data_ptr(),
        cent.data_ptr(), world_to_cam.data_ptr(), quality.data_ptr(),
        updated.data_ptr(), ctypes.byref(params), u, stream)
    _check(rc, "tsdf_integrate")
    LAUNCHES["tsdf_integrate"] += 1
    return quality, updated
