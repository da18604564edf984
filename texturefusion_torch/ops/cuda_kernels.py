"""Build, bind and launch the port's hand-written CUDA kernels.

The two TPU kernels of the JAX package have Hopper counterparts here:

  K1  csrc/bilateral.cu        replaces ops/pallas_kernels.py bilateral_filter_pallas
  K2  csrc/tsdf_integrate.cu   replaces examples/pallas_voxel_kernel.py integrate_rows_pallas

and two kernels have no Pallas counterpart:

  K3  csrc/kabsch.cu           the weighted rigid fit of slam/matching.py kabsch, which
                               the JAX package computes with jnp.linalg.svd inside its
                               jitted programs; torch.linalg.svd synchronises with the
                               host on the card, which a captured program cannot do
  K4  csrc/atlas_blit.cu       a texture cycle's atlas patches, each a keyframe region
                               resized as texture/atlas.py resize_bilinear does, which
                               the JAX package blits on the host one chunk at a time

K2 has two entry points: one frame with colour or depth only, ±1
(tsdf_integrate_cuda), and its F-frame mode, F depth-only frames with a
sign each in one pass over the rows (tsdf_integrate_frames_cuda).
All are compiled on first use by nvcc into one shared library with a
plain C interface (texturefusion_torch/_build/, named by a hash of the
sources and flags so an edited source rebuilds) and bound with ctypes:
pointers, the current stream and scalars cross as c_void_p / c_int /
c_float. Each source is compiled with its own flags, all at once, and the
objects are linked into the library: K2 and K4 need -fmad=false (K2's
projection must round as the plain version does, K4's resize equal it
bit for bit), K1 wants fused multiply-adds.
Each launch function returns cudaGetLastError() and the wrapper raises
if it is not 0. The wrappers check device, dtype, shape and contiguity,
allocate their outputs with torch.empty and never synchronise.

`LAUNCHES` counts kernel launches per kernel (K2's F-frame mode under
its own key); each wrapper adds one right after its launch and nowhere
else, so a run can show that its main path went through the kernels.
A wrapper called while its thread captures a CUDA graph (utils/graphs.py)
launches nothing: it records the launch into the program being
captured, and each replay of that program adds its recorded launches.
`LANES` sums the lanes K2 was launched over, and `FRAME_SHAPES` counts
its F-frame mode's launches by (frames, lanes, whether the signs mix -1
and +1: a drift reintegration).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# each source and the flags it adds to NVCC_FLAGS
SOURCES = {"bilateral.cu": (), "tsdf_integrate.cu": ("-fmad=false",), "kabsch.cu": (),
           "atlas_blit.cu": ("-fmad=false",)}

MAX_RADIUS = 8              # K1 is instantiated for radius 0..MAX_RADIUS

MAX_FRAMES = 64             # frames of one launch of K2's F-frame mode

LAUNCHES = {"bilateral": 0, "tsdf_integrate": 0, "tsdf_integrate_frames": 0, "kabsch": 0,
            "atlas_blit": 0}
LANES = {"tsdf_integrate": 0}
FRAME_SHAPES: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# per thread: the launch counts of the CUDA graph it is capturing, or None
CAPTURE = threading.local()


def _count(name: str) -> None:
    """One launch of kernel `name`: counted now, or recorded into the
    program this thread is capturing (counted at each of its replays)."""
    rec = getattr(CAPTURE, "launches", None)
    if rec is None:
        LAUNCHES[name] += 1
    else:
        rec[name] += 1


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LANES):
        for k in counts:
            counts[k] = 0
    FRAME_SHAPES.clear()


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
        ("with_color", ctypes.c_int), ("n_rows", ctypes.c_int),
        ("centroid", ctypes.c_float * 8)]


class FrameSigns(ctypes.Structure):
    """Mirror of `FrameSigns` in csrc/tsdf_integrate.cu."""

    _fields_ = [("n_frames", ctypes.c_int), ("sign", ctypes.c_float * MAX_FRAMES)]


def _compile(srcs, path: str, verbose: bool) -> None:
    """nvcc every source to an object at once, then link the library."""
    tmp = f"{path}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *SOURCES[os.path.basename(s)],
                               "-Xptxas", "-v", "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    outs = [(p, *p.communicate()) for p in procs]
    try:
        for p, _, err in outs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")
            if verbose:
                print(err.strip())
        res = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}.so", *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(f"{tmp}.so", path)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per hash of sources and flags) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_CSRC, s) for s in SOURCES]
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
            h.update(" ".join(SOURCES[os.path.basename(s)]).encode())
        h.update(" ".join(NVCC_FLAGS).encode())
        path = os.path.join(_BUILD, f"libtf_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            _compile(srcs, path, verbose)
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tf_bilateral_launch.restype = i
        lib.tf_bilateral_launch.argtypes = [p, p, p, i, i, i, f, p]
        lib.tf_tsdf_integrate_launch.restype = i
        lib.tf_tsdf_integrate_launch.argtypes = [p] * 13 + [ctypes.POINTER(TsdfParams), i, p]
        lib.tf_tsdf_integrate_frames_launch.restype = i
        lib.tf_tsdf_integrate_frames_launch.argtypes = [p] * 7 + [
            ctypes.POINTER(TsdfParams), ctypes.POINTER(FrameSigns), i, p]
        lib.tf_kabsch_launch.restype = i
        lib.tf_kabsch_launch.argtypes = [p, p, p, p, i, i, p]
        lib.tf_atlas_blit_launch.restype = i
        lib.tf_atlas_blit_launch.argtypes = [p, p, i, i, i, p]
        _lib = lib
        return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             shape: Optional[Tuple[int, ...]] = None) -> None:
    """Type, layout and shape of one kernel argument (its device is
    checked by _on_card, after every argument passed these)."""
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _on_card(**tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


_host_consts: dict = {}


def _host_const(key, make):
    """Per-setting host constants: spatial weights, parameter blocks."""
    v = _host_consts.get(key)
    if v is None:
        v = _host_consts[key] = make()
    return v


def spatial_weights(radius: int, sigma_space: float) -> np.ndarray:
    """(2r+1)² bilateral spatial weights, dy-major, computed in float64
    and rounded once, as the TPU kernel computes them."""
    r = np.arange(-radius, radius + 1)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space * sigma_space)
                  ).astype(np.float32).reshape(-1)


def bilateral_cuda(depth: torch.Tensor, radius: int = 4,
                   sigma_space: float = 4.5, sigma_range: float = 0.03) -> torch.Tensor:
    """K1: [H, W] f32 depth on the card -> [H, W] filtered depth.
    radius must lie in 0..MAX_RADIUS (the kernel is instantiated for
    each); the spatial weights travel in the kernel's parameter block."""
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must lie in 0..{MAX_RADIUS}, got {radius}")
    _require(depth, "depth", torch.float32)
    if depth.dim() != 2:
        raise ValueError(f"depth must be [H, W], got {tuple(depth.shape)}")
    _on_card(depth=depth)
    lib = build()
    h, w = depth.shape
    ws = _host_const(("ws", radius, sigma_space), lambda: spatial_weights(radius, sigma_space))
    # exp(-diff²/(2σr²)) = exp2(-(s·diff)²): the kernel stages depths
    # times s and takes exp2
    scale = np.sqrt(np.log2(np.e) / (2.0 * sigma_range * sigma_range))
    out = torch.empty_like(depth)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    rc = lib.tf_bilateral_launch(depth.data_ptr(), out.data_ptr(), ws.ctypes.data,
                                 h, w, radius, float(np.float32(scale)), stream)
    _check(rc, "bilateral")
    _count("bilateral")
    return out


def _tsdf_params(intr, cfg, sign: float, with_color: bool, n_rows: int) -> TsdfParams:
    res_diag = float(np.sqrt(3.0)) * cfg.voxel_resolution
    centroid = ((np.arange(8) + 0.5) * cfg.voxel_resolution).astype(np.float32)
    return TsdfParams(
        fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        width=intr.width, height=intr.height,
        near_plane=intr.near, far_plane=intr.far,
        trunc_quad=cfg.truncation_quad, trunc_linear=cfg.truncation_linear,
        trunc_const=cfg.truncation_const, trunc_scale=cfg.truncation_scale,
        res_diag=res_diag, color_band=res_diag * 0.5 + cfg.color_band_pad,
        integration_weight=cfg.integration_weight, min_weight=cfg.min_weight,
        color_saturation=cfg.color_saturation, sign=float(sign),
        with_color=int(with_color), n_rows=n_rows,
        centroid=(ctypes.c_float * 8)(*centroid.tolist()))


def _aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 accesses)")


def _require_rows(cfg, sdf, weight, idx, active, origins) -> Tuple[int, int]:
    """K2's row arguments, both modes: sdf and weight [S+1, 512] f32
    (16-byte aligned, checked after the device), idx [U] int64, active
    [U] bool or None, origins [S+1, 3]. Returns (S+1, U)."""
    n_rows, n_vox = sdf.shape
    if n_vox != cfg.chunk_size ** 3 or n_vox != 512:
        raise ValueError(f"rows must be [S+1, 512], got {tuple(sdf.shape)}")
    u = idx.shape[0]
    _require(sdf, "sdf", torch.float32)
    _require(weight, "weight", torch.float32, (n_rows, n_vox))
    _require(idx, "idx", torch.int64, (u,))
    if active is not None:
        _require(active, "active", torch.bool, (u,))
    _require(origins, "origins", torch.float32, (n_rows, 3))
    return n_rows, u


def tsdf_integrate_cuda(sdf: torch.Tensor, weight: torch.Tensor,
                        color: torch.Tensor, ccnt: torch.Tensor,
                        idx: torch.Tensor, active: Optional[torch.Tensor],
                        origins: torch.Tensor, depth: torch.Tensor,
                        rgb: Optional[torch.Tensor], quality: Optional[torch.Tensor],
                        cam_to_world: torch.Tensor, sign: float, intr, cfg,
                        with_color: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: update rows sdf/weight/ccnt [S+1, 512], color [S+1, 512, 3]
    IN PLACE at the slots `idx` [U] (int64; `active` [U] bool marks the
    lanes to update, None for all). origins [S+1, 3] is the full
    chunk-origin table (read by slot), depth [H, W], rgb [H, W, 3] in
    0..1, quality [H, W] (rgb and quality are not read, and may be None,
    when with_color is False), cam_to_world [4, 4]. One launch of one
    block per lane. Returns (quality [U] f32, updated [U] bool)."""
    n_rows, u = _require_rows(cfg, sdf, weight, idx, active, origins)
    _require(color, "color", torch.float32, (n_rows, 512, 3))
    _require(ccnt, "color_count", torch.float32, (n_rows, 512))
    _require(depth, "depth", torch.float32, (intr.height, intr.width))
    if with_color:
        _require(rgb, "rgb", torch.float32, (intr.height, intr.width, 3))
        _require(quality, "quality", torch.float32, (intr.height, intr.width))
    _require(cam_to_world, "cam_to_world", torch.float32, (4, 4))
    _on_card(sdf=sdf, weight=weight, color=color, color_count=ccnt, idx=idx, active=active,
             origins=origins, depth=depth, rgb=rgb if with_color else None,
             quality=quality if with_color else None, cam_to_world=cam_to_world)
    _aligned(sdf=sdf, weight=weight, color=color, color_count=ccnt)
    lib = build()
    dev = sdf.device
    params = _host_const(("tsdf", intr, cfg, float(sign), bool(with_color), n_rows),
                         lambda: _tsdf_params(intr, cfg, sign, with_color, n_rows))
    out_q = torch.empty(u, dtype=torch.float32, device=dev)
    updated = torch.empty(u, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.tf_tsdf_integrate_launch(
        sdf.data_ptr(), weight.data_ptr(), color.data_ptr(), ccnt.data_ptr(),
        idx.data_ptr(), None if active is None else active.data_ptr(), origins.data_ptr(),
        depth.data_ptr(), rgb.data_ptr() if with_color else None,
        quality.data_ptr() if with_color else None, cam_to_world.data_ptr(),
        out_q.data_ptr(), updated.data_ptr(), ctypes.byref(params), u, stream)
    _check(rc, "tsdf_integrate")
    _count("tsdf_integrate")
    LANES["tsdf_integrate"] += u
    return out_q, updated


def tsdf_integrate_frames_cuda(sdf: torch.Tensor, weight: torch.Tensor,
                               idx: torch.Tensor, active: Optional[torch.Tensor],
                               origins: torch.Tensor, depths: torch.Tensor,
                               cam_to_worlds: torch.Tensor, signs, intr, cfg) -> None:
    """K2's F-frame mode: depth-only frames depths [F, H, W] at
    cam_to_worlds [F, 4, 4], with `signs` F host floats (1 <= F <=
    MAX_FRAMES), into rows sdf/weight [S+1, 512] IN PLACE at the slots
    `idx` [U] (int64; `active` [U] bool or None as in tsdf_integrate_cuda).
    One launch of two 128-thread blocks per lane, each over half the
    chunk's voxels at 2 a thread; colour rows are not touched."""
    n_rows, u = _require_rows(cfg, sdf, weight, idx, active, origins)
    n_frames = len(signs)
    if not 1 <= n_frames <= MAX_FRAMES:
        raise ValueError(f"the F-frame mode takes 1..{MAX_FRAMES} frames, got {n_frames}")
    _require(depths, "depths", torch.float32, (n_frames, intr.height, intr.width))
    _require(cam_to_worlds, "cam_to_worlds", torch.float32, (n_frames, 4, 4))
    _on_card(sdf=sdf, weight=weight, idx=idx, active=active, origins=origins, depths=depths,
             cam_to_worlds=cam_to_worlds)
    _aligned(sdf=sdf, weight=weight)
    lib = build()
    params = _host_const(("tsdf", intr, cfg, 1.0, False, n_rows),
                         lambda: _tsdf_params(intr, cfg, 1.0, False, n_rows))
    fs = _host_const(("signs", tuple(signs)), lambda: FrameSigns(
        n_frames=n_frames, sign=(ctypes.c_float * MAX_FRAMES)(*signs)))
    rc = lib.tf_tsdf_integrate_frames_launch(
        sdf.data_ptr(), weight.data_ptr(), idx.data_ptr(),
        None if active is None else active.data_ptr(), origins.data_ptr(), depths.data_ptr(),
        cam_to_worlds.data_ptr(), ctypes.byref(params), ctypes.byref(fs), u,
        torch.cuda.current_stream(sdf.device).cuda_stream)
    _check(rc, "tsdf_integrate_frames")
    _count("tsdf_integrate_frames")
    FRAME_SHAPES[(n_frames, u, min(signs) < 0 < max(signs))] += 1


def kabsch_cuda(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3: the weighted rigid fit T [..., 4, 4] with p ≈ R q + t of
    p, q [..., N, 3] and w [..., N] f32 on the card, every leading index a
    fit (slam/matching.py kabsch_plain's function). One launch of one warp
    a fit; the sums and the 3×3 SVD in float64, rounded once."""
    _require(p, "p", torch.float32)
    if p.dim() < 2 or p.shape[-1] != 3:
        raise ValueError(f"p must be [..., N, 3], got {tuple(p.shape)}")
    _require(q, "q", torch.float32, tuple(p.shape))
    _require(w, "w", torch.float32, tuple(p.shape[:-1]))
    _on_card(p=p, q=q, w=w)
    lib = build()
    batch = tuple(p.shape[:-2])
    n_fits = int(np.prod(batch, dtype=np.int64))
    out = torch.empty(batch + (4, 4), dtype=torch.float32, device=p.device)
    rc = lib.tf_kabsch_launch(p.data_ptr(), q.data_ptr(), w.data_ptr(), out.data_ptr(), n_fits,
                              p.shape[-2], torch.cuda.current_stream(p.device).cuda_stream)
    _check(rc, "kabsch")
    _count("kabsch")
    return out


def atlas_blit_cuda(images, table: np.ndarray, size: int) -> torch.Tensor:
    """K4: the regions of `table` (texture/atlas.py roi_table's [n, 5]
    int64 rows: index into `images`, x0, y0, x1, y1, ends exclusive) of
    the [H, W, 3] uint8 images on one card, each resized to size × size
    as texture/atlas.py resize_bilinear does, bit for bit: [n, size, size,
    3] uint8 on that card. The table goes to the card in one copy, with
    each image's address in place of its index; one launch of one thread
    an output pixel."""
    if not images:
        raise ValueError("atlas_blit: no source images")
    h, w = images[0].shape[:2]
    for i, t in enumerate(images):
        _require(t, f"images[{i}]", torch.uint8, (h, w, 3))
    _on_card(**{f"images[{i}]": t for i, t in enumerate(images)})
    dev = images[0].device
    if any(t.device != dev for t in images):
        raise ValueError("atlas_blit: the source images lie on several cards")
    table = np.asarray(table, np.int64)
    if table.ndim != 2 or table.shape[1] != 5:
        raise ValueError(f"table must be [n, 5], got {table.shape}")
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    s, x0, y0, x1, y1 = table.T
    if ((s < 0) | (s >= len(images)) | (x0 < 0) | (x0 >= x1) | (x1 > w)
            | (y0 < 0) | (y0 >= y1) | (y1 > h)).any():
        raise ValueError("atlas_blit: a region lies outside its image, or names no image")
    n = len(table)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = build()
    entries = table.copy()
    entries[:, 0] = np.asarray([t.data_ptr() for t in images], np.int64)[s]
    dev_table = torch.from_numpy(entries).pin_memory().to(dev, non_blocking=True)
    rc = lib.tf_atlas_blit_launch(dev_table.data_ptr(), out.data_ptr(), n, size, w,
                                  torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, "atlas_blit")
    _count("atlas_blit")
    return out
