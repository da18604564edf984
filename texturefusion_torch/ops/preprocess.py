"""Per-frame image preprocessing on torch tensors.

Port of texturefusion_tpu/ops/preprocess.py (ref: BasicAPI.cpp —
framePreprocess :942, extractNormalMapSIMD :849, refineDepthUseNormalSIMD
:728, estimateColorQuality :815, blurriness :1256). Every function takes
(H, W[, C]) tensors and keeps the JAX package's layouts and border rules:

  * the bilateral filter follows the TPU kernel that ran on the chip
    (ops/pallas_kernels.py): taps outside the image weigh 0. On a CUDA
    tensor it is the hand-written kernel K1 (csrc/bilateral.cu); on a
    CPU tensor its plain version below;
  * normals difference the point map with a wrap-around roll, as
    `jnp.roll` does;
  * Sobel and Laplacian stencils replicate the edge pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import cuda_kernels


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicated shifted copy: out[y, x] = img[clamp(y+dy), clamp(x+dx)]."""
    h, w = img.shape
    padded = F.pad(img[None, None], (max(-dx, 0), max(dx, 0),
                                     max(-dy, 0), max(dy, 0)),
                   mode="replicate")[0, 0]
    y0 = max(-dy, 0) + dy
    x0 = max(-dx, 0) + dx
    return padded[y0:y0 + h, x0:x0 + w]


def depth_clamp(depth: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Zero out depth outside (near, far); 0 encodes invalid."""
    valid = (depth > near) & (depth < far)
    return torch.where(valid, depth, 0.0)


def bilateral_filter_plain(depth: torch.Tensor, radius: int = 4,
                           sigma_space: float = 4.5,
                           sigma_range: float = 0.03) -> torch.Tensor:
    """Plain PyTorch version of kernel K1, on any device: Σw·d / Σw over
    the (2r+1)² window, taps accumulated dy-major as the TPU kernel does.
    Invalid (0) taps and taps outside the image (zero padding) weigh 0;
    invalid centres, or Σw ≤ 1e-12, give 0."""
    h, w = depth.shape
    padded = F.pad(depth, (radius, radius, radius, radius))
    ws = cuda_kernels.spatial_weights(radius, sigma_space).tolist()
    inv_2sr = 1.0 / (2.0 * sigma_range * sigma_range)
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = padded[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            diff = nb - depth
            wgt = torch.where(nb > 0.0, ws[k] * torch.exp(-(diff * diff) * inv_2sr), 0.0)
            acc = acc + wgt * nb
            wacc = wacc + wgt
            k += 1
    out = acc / torch.clamp(wacc, min=1e-12)
    return torch.where((depth > 0.0) & (wacc > 1e-12), out, 0.0)


def bilateral_filter(depth: torch.Tensor, radius: int = 4,
                     sigma_space: float = 4.5,
                     sigma_range: float = 0.03) -> torch.Tensor:
    """Edge-preserving 9×9 depth smoothing (ref: cv::bilateralFilter in
    framePreprocess, BasicAPI.cpp:942-997). A CUDA tensor runs kernel K1;
    a CPU tensor runs bilateral_filter_plain."""
    if depth.is_cuda:
        return cuda_kernels.bilateral_cuda(depth.contiguous(), radius, sigma_space, sigma_range)
    if depth.device.type != "cpu":
        raise ValueError(f"bilateral_filter: unsupported device {depth.device}")
    return bilateral_filter_plain(depth, radius, sigma_space, sigma_range)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float -> (H, W) luminance."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def extract_normal_map(depth: torch.Tensor, intr: cam.Intrinsics) -> torch.Tensor:
    """Cross-product normals of the back-projected depth map, facing the
    camera; zero where depth or a forward neighbour is invalid
    (ref: extractNormalMapSIMD BasicAPI.cpp:849-905)."""
    pts = cam.backproject_depth_map(intr, depth)
    dx = torch.roll(pts, -1, dims=1) - pts
    dy = torch.roll(pts, -1, dims=0) - pts
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * _unit(pts), dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    valid = ((depth > 0) & (torch.roll(depth, -1, 1) > 0)
             & (torch.roll(depth, -1, 0) > 0) & (norm[..., 0] > 1e-12))
    return torch.where(valid[..., None], n, 0.0)


def view_angle_cos(depth: torch.Tensor, normals: torch.Tensor,
                   intr: cam.Intrinsics) -> torch.Tensor:
    """|view_dir · normal| per pixel."""
    view = _unit(cam.backproject_depth_map(intr, depth))
    return torch.abs(torch.sum(view * normals, dim=-1))


def refine_depth_with_normals(depth: torch.Tensor, normals: torch.Tensor,
                              intr: cam.Intrinsics,
                              min_cos: float = 0.1) -> torch.Tensor:
    """Zero depth at grazing angles |view·normal| < 0.1
    (ref: refineDepthUseNormalSIMD BasicAPI.cpp:728-780)."""
    cos = view_angle_cos(depth, normals, intr)
    has_normal = torch.sum(normals * normals, dim=-1) > 1e-12
    return torch.where((cos >= min_cos) & has_normal, depth, 0.0)


def sobel_magnitude(gray: torch.Tensor) -> torch.Tensor:
    """|Sobel| gradient magnitude of (H, W), edge-replicated."""
    s = _shift
    gx = (s(gray, -1, 1) + 2 * s(gray, 0, 1) + s(gray, 1, 1)
          - s(gray, -1, -1) - 2 * s(gray, 0, -1) - s(gray, 1, -1))
    gy = (s(gray, 1, -1) + 2 * s(gray, 1, 0) + s(gray, 1, 1)
          - s(gray, -1, -1) - 2 * s(gray, -1, 0) - s(gray, -1, 1))
    return torch.sqrt(gx * gx + gy * gy)


def observation_quality_map(rgb: torch.Tensor, depth: torch.Tensor,
                            normals: torch.Tensor,
                            intr: cam.Intrinsics) -> torch.Tensor:
    """Per-pixel texture-observation quality Sobel(gray) × |view·normal|
    (ref: estimateColorQuality BasicAPI.cpp:815-847)."""
    q = sobel_magnitude(rgb_to_gray(rgb)) * view_angle_cos(depth, normals, intr)
    return torch.where(depth > 0, q, 0.0)


def laplacian_blurriness(gray: torch.Tensor) -> torch.Tensor:
    """Mean |Laplacian| sharpness score of gray in [0, 255]
    (ref: blurriness BasicAPI.cpp:1256-1266)."""
    s = _shift
    lap = (s(gray, 0, 1) + s(gray, 0, -1) + s(gray, 1, 0)
           + s(gray, -1, 0) - 4.0 * gray)
    return torch.mean(torch.abs(lap))


def frame_preprocess(depth_raw: torch.Tensor, intr: cam.Intrinsics,
                     bilateral_radius: int = 4) -> torch.Tensor:
    """Clamp to (near, far), then bilateral smoothing
    (ref: framePreprocess BasicAPI.cpp:942-997)."""
    return bilateral_filter(depth_clamp(depth_raw, intr.near, intr.far),
                            radius=bilateral_radius)


def pack_frame(depth_u16: np.ndarray, rgb_u8: np.ndarray) -> np.ndarray:
    """Host-side: (uint16 depth, uint8 rgb) -> one [H, W, 5] uint8 frame
    (depth low byte, high byte, r, g, b), unpacked by preprocess_bundle."""
    h, w = depth_u16.shape
    out = np.empty((h, w, 5), np.uint8)
    out[..., 0] = depth_u16 & 0xFF
    out[..., 1] = depth_u16 >> 8
    out[..., 2:5] = rgb_u8
    return out


def preprocess_bundle(depth_raw: torch.Tensor, rgb, intr: cam.Intrinsics,
                      depth_scale: float = 1.0):
    """The whole per-frame preprocessing chain. Returns
    (depth_refined, normals, quality, gray255, blur_score, rgb).

    Takes a packed [H, W, 5] uint8 frame (see pack_frame) as `depth_raw`
    with rgb=None, or separate depth (uint16 divided by depth_scale, or
    float) and rgb (uint8 or float 0..1)."""
    if rgb is None:
        packed = depth_raw
        depth_raw = (packed[..., 0].to(torch.float32)
                     + packed[..., 1].to(torch.float32) * 256.0) / depth_scale
        rgb = packed[..., 2:5].to(torch.float32) / 255.0
    if depth_raw.dtype != torch.float32:
        depth_raw = depth_raw.to(torch.float32) / depth_scale
    if rgb.dtype != torch.float32:
        rgb = rgb.to(torch.float32) / 255.0
    depth = frame_preprocess(depth_raw, intr)
    normals = extract_normal_map(depth, intr)
    depth_refined = refine_depth_with_normals(depth, normals, intr)
    quality = observation_quality_map(rgb, depth_refined, normals, intr)
    gray = rgb_to_gray(rgb) * 255.0
    blur = laplacian_blurriness(gray)
    return depth_refined, normals, quality, gray, blur, rgb
