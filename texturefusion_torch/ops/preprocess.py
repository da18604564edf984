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


def color_valid_flag(depth: torch.Tensor, normals: torch.Tensor,
                     intr: cam.Intrinsics, min_cos: float = 0.2) -> torch.Tensor:
    """Per-pixel flag: a colour observation is usable where |view·normal|
    ≥ 0.2 (ref: checkColorQuality BasicAPI.cpp:783-813)."""
    cos = view_angle_cos(depth, normals, intr)
    has_normal = torch.sum(normals * normals, dim=-1) > 1e-12
    return (cos >= min_cos) & has_normal & (depth > 0)


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


def _bilinear_depth(depth: torch.Tensor, uv: torch.Tensor):
    """Validity-aware bilinear depth sample at float uv [N, 2]
    (ref: Patch.cpp:110-170). Returns (d, ok): ok when more than half the
    bilinear mass falls on valid (> 0) samples."""
    h, w = depth.shape
    uv = torch.nan_to_num(uv)      # a non-finite pose must not index out of bounds
    x = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = depth.reshape(-1)
    base = y0 * w + x0
    d00, d01, d10, d11 = (flat[base], flat[base + 1], flat[base + w], flat[base + w + 1])
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    ws = w00 * (d00 > 0) + w01 * (d01 > 0) + w10 * (d10 > 0) + w11 * (d11 > 0)
    d = w00 * d00 + w01 * d01 + w10 * d10 + w11 * d11
    ok = ws > 0.5
    return torch.where(ok, d / torch.clamp(ws, min=1e-12), 0.0), ok


def _warped_depth_obs(target_depth: torch.Tensor, source_depth: torch.Tensor,
                      rel_source_to_target: torch.Tensor, intr: cam.Intrinsics,
                      consistency: float):
    """For each TARGET pixel with depth: project into the source frame,
    sample its depth bilinearly, lift the sample back into the target
    frame (a backward warp of gathers; ref: refineKeyframesSIMD
    BasicAPI.cpp:506-635). Returns (z_obs [H, W], agree [H, W])."""
    from texturefusion_torch.core import se3
    pts_t = cam.backproject_depth_map(intr, target_depth)
    pts_s = se3.transform_points(se3.inverse(rel_source_to_target), pts_t.reshape(-1, 3))
    uv, z_exp = cam.project(intr, pts_s)
    d_s, ok_s = _bilinear_depth(source_depth, uv)
    valid = ((target_depth.reshape(-1) > 0) & (z_exp > intr.near)
             & cam.in_image(intr, uv) & ok_s & (d_s > 0))
    agree = valid & (torch.abs(d_s - z_exp) < consistency * torch.clamp(z_exp, min=1e-3))
    x_s = cam.unproject(intr, uv[..., 0], uv[..., 1], d_s)
    z_obs = se3.transform_points(rel_source_to_target, x_s)[..., 2]
    shape = target_depth.shape
    return torch.where(agree, z_obs, 0.0).reshape(shape), agree.reshape(shape)


def fuse_depth_into_keyframe(kf_depth: torch.Tensor, kf_weight: torch.Tensor,
                             new_depth: torch.Tensor, rel_pose_new_to_kf: torch.Tensor,
                             intr: cam.Intrinsics, consistency: float = 0.05):
    """Running weighted fusion of a tracked frame's depth into its keyframe
    (ref: refineKeyframesSIMD BasicAPI.cpp:506-635). Returns (depth, weight)."""
    z_obs, agree = _warped_depth_obs(kf_depth, new_depth, rel_pose_new_to_kf, intr,
                                     consistency)
    den = agree.to(torch.float32)
    fused = (kf_depth * kf_weight + z_obs) / torch.clamp(kf_weight + den, min=1e-12)
    return torch.where((kf_weight + den) > 0, fused, 0.0), kf_weight + den


def refine_new_frame_from_keyframe(new_depth: torch.Tensor, kf_depth: torch.Tensor,
                                   rel_pose_new_to_kf: torch.Tensor, intr: cam.Intrinsics,
                                   consistency: float = 0.05,
                                   kf_trust: float = 1.0) -> torch.Tensor:
    """Refine a tracked frame's depth FROM its keyframe (ref:
    refineNewframesSIMD BasicAPI.cpp:378-505): each new-frame pixel warps
    into the keyframe and blends with its depth where consistent."""
    from texturefusion_torch.core import se3
    z_obs, agree = _warped_depth_obs(new_depth, kf_depth, se3.inverse(rel_pose_new_to_kf),
                                     intr, consistency)
    den = agree.to(torch.float32) * kf_trust
    fused = (new_depth + z_obs * kf_trust) / torch.clamp(1.0 + den, min=1e-12)
    return torch.where(new_depth > 0, torch.where(agree, fused, new_depth), 0.0)


def frame_preprocess(depth_raw: torch.Tensor, intr: cam.Intrinsics,
                     bilateral_radius: int = 4) -> torch.Tensor:
    """Clamp to (near, far), then bilateral smoothing
    (ref: framePreprocess BasicAPI.cpp:942-997)."""
    return bilateral_filter(depth_clamp(depth_raw, intr.near, intr.far),
                            radius=bilateral_radius)


def devignette(rgb: torch.Tensor, intr: cam.Intrinsics,
               strength: float = 0.3) -> torch.Tensor:
    """Radial vignetting correction (ref: DatasetWrapper.hpp's optional
    radial devignetting): multiply by 1 + strength·r²·(1 + r²)."""
    u, v = cam.pixel_grid(intr, device=rgb.device)
    r2 = ((u - intr.cx) / intr.fx) ** 2 + ((v - intr.cy) / intr.fy) ** 2
    gain = 1.0 + strength * r2 * (1.0 + r2)
    return torch.clamp(rgb * gain[..., None], 0.0, 1.0)


def remove_boundary_depth(depth: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """Erode depth at discontinuities: flying-pixel removal
    (ref: MapMaintain.hpp:131-172 removeBoundary)."""
    d = depth
    for _ in range(iterations):
        neighbor_max = d
        neighbor_min = torch.where(d > 0, d, torch.inf)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nb = _shift(d, dy, dx)
            neighbor_max = torch.maximum(neighbor_max, nb)
            neighbor_min = torch.minimum(neighbor_min, torch.where(nb > 0, nb, torch.inf))
        jump = neighbor_max - torch.where(torch.isfinite(neighbor_min), neighbor_min, 0.0)
        d = torch.where((d > 0) & (jump < 0.1 * torch.clamp(d, min=0.5)), d, 0.0)
    return d


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
