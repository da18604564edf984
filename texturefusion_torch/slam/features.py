"""FAST corners + oriented binary descriptors over an image pyramid.

Port of texturefusion_tpu/slam/features.py (ref: GCSLAM/ORBSLAM/
ORBextractor.{h,cpp}, driven from BasicAPI.cpp:175-279): FAST-9/16 for
every pixel at once, 3×3 non-maximum suppression, per-cell argmax plus a
top-k in place of the octree distribution, intensity-centroid angle, and
256 rotated point-pair tests packed into 8 words. Keypoints are padded to
a static capacity with validity masks, as in the JAX package.

Border rules follow the JAX code exactly: the FAST and NMS shifts
replicate edge pixels, the descriptor box blur wraps around (jnp.roll),
and patch starts follow jax.lax.dynamic_slice (negative starts count
from the end, then clamp into the image). Ties in the top-k go to the
lowest index, as jax.lax.top_k does.

Every float step from the grey image to the descriptor bits rounds the
same on the CPU and on a CUDA device (core/exact.py): the pyramid
resize sums its weighted taps in float64 and rounds each pass once; the
blur divides exactly; the intensity-centroid moments are summed
pairwise; the descriptor's rotation takes its cosine and sine from the
moments (m10 / r, m01 / r) rather than from the library's cos and sin of
the angle. So a frame has the same keypoints and descriptors on both devices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from texturefusion_torch.config import TrackingConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import exact
from texturefusion_torch.ops import hamming

# FAST circle of radius 3 (16-offset Bresenham circle), (dx, dy)
_FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _descriptor_pattern(n_bits: int = 256, radius: int = 13,
                        seed: int = 7) -> np.ndarray:
    """The JAX package's point-pair pattern [n_bits, 4] = (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, radius / 2.5, size=(n_bits, 4))
    return np.clip(pts, -radius, radius).astype(np.float32)


_PATTERN = _descriptor_pattern()

# Patch geometry: descriptor taps reach |xy| ≤ 13 after rotation and the
# IC-angle disc has radius 11, so a 32×32 patch centred at (15, 15)
# covers both.
_PATCH = 32
_PATCH_C = 15
_IC_RADIUS = 11


def _ic_weights():
    yy, xx = np.mgrid[0:_PATCH, 0:_PATCH]
    dx = (xx - _PATCH_C).astype(np.float32)
    dy = (yy - _PATCH_C).astype(np.float32)
    disc = (dx * dx + dy * dy) <= _IC_RADIUS * _IC_RADIUS
    return (np.where(disc, dx, 0.0).astype(np.float32),
            np.where(disc, dy, 0.0).astype(np.float32))


_IC_DX, _IC_DY = _ic_weights()
_CONSTS: dict = {}


def _consts(device) -> dict:
    """The pattern, IC weights and FAST bit tables on `device`, made once."""
    c = _CONSTS.get(device)
    if c is None:
        pat = torch.as_tensor(_PATTERN)
        c = _CONSTS[device] = {k: v.to(device) for k, v in {
            "ic_w": torch.as_tensor(np.stack([_IC_DX, _IC_DY]).reshape(2, -1)),
            "xs": torch.cat([pat[:, 0], pat[:, 2]]), "ys": torch.cat([pat[:, 1], pat[:, 3]]),
            "bit": (1 << torch.arange(16, dtype=torch.int32))[:, None, None],
            "starts": torch.arange(16, dtype=torch.int32)[:, None, None, None]}.items()}
    return c


class Keypoints(NamedTuple):
    uv: torch.Tensor         # [K, 2] undistorted pixel coords at level-0 scale
    response: torch.Tensor   # [K]
    angle: torch.Tensor      # [K] radians
    level: torch.Tensor      # [K] int32 pyramid level
    desc: torch.Tensor       # [K, 8] int32 words (the uint32 bits of the JAX package)
    valid: torch.Tensor      # [K] bool
    points3d: torch.Tensor   # [K, 3] camera-frame backprojection (0 if no depth)
    has_depth: torch.Tensor  # [K] bool


def _shifted(img: torch.Tensor, offsets, r: int) -> torch.Tensor:
    """[len(offsets), H, W] edge-replicated shifts out[k][y, x] =
    img[clamp(y + dy_k), clamp(x + dx_k)] for (dx, dy) in offsets, |d| ≤ r:
    views of one replicate-padded image, stacked."""
    h, w = img.shape
    p = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    return torch.stack([p[r + dy:r + dy + h, r + dx:r + dx + w] for dx, dy in offsets])


def fast_score(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner response for every pixel (0 for non-corners): the
    16 circle tests are bit-packed per pixel, and a corner has 9
    contiguous brighter or darker samples."""
    c = _consts(gray.device)
    bit = c["bit"]
    diff = _shifted(gray, _FAST_OFFSETS, 3) - gray                     # [16, H, W]
    bits_b = torch.sum((diff > threshold).to(torch.int32) * bit, dim=0, dtype=torch.int32)
    bits_d = torch.sum((diff < -threshold).to(torch.int32) * bit, dim=0, dtype=torch.int32)
    # the response sums the 16 terms one after another, as the JAX loop does
    terms = torch.clamp(torch.abs(diff) - threshold, min=0.0)
    score = torch.zeros_like(gray)
    for i in range(16):
        score = score + terms[i]
    # wrap the circular 16 bits to 32 so every window start is a plain shift
    wraps = torch.stack([bits_b | (bits_b << 16), bits_d | (bits_d << 16)])
    need = (1 << 9) - 1
    is_corner = torch.any(((wraps[None] >> c["starts"]) & need) == need, dim=1).any(dim=0)
    return torch.where(is_corner, score, 0.0)


def _nms(score: torch.Tensor) -> torch.Tensor:
    """3×3 non-maximum suppression (edge-replicated neighbours)."""
    neigh = _shifted(score, [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                             if (dy, dx) != (0, 0)], 1)
    return torch.where(score >= torch.amax(neigh, dim=0), score, 0.0)


def _box_blur(img: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Separable box blur with wrap-around borders (jnp.roll)."""
    k = 2 * r + 1
    out = img
    for axis in (0, 1):
        acc = torch.zeros_like(out)
        for s in range(-r, r + 1):
            acc = acc + torch.roll(out, s, axis)
        out = exact.div(acc, k)
    return out


def _extract_patches(blur: torch.Tensor, vy: torch.Tensor, vx: torch.Tensor) -> torch.Tensor:
    """[K, 32, 32] patches around integer keypoint centres, with the start
    rule of jax.lax.dynamic_slice: a negative start counts from the end
    (as a Python index), then the start is clamped into the image.
    Invalid keypoints (zero-response cells, whose argmax is the cell
    corner) start at −15 and take the wrapped patch."""
    h, w = blur.shape

    def start(v, n):
        s = v.to(torch.int64) - _PATCH_C
        return torch.clamp(torch.where(s < 0, s + n, s), 0, n - _PATCH)

    y0, x0 = start(vy, h), start(vx, w)
    r = torch.arange(_PATCH, device=blur.device)
    return blur[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def _ic_moments(patches: torch.Tensor):
    """Intensity-centroid moments (m10, m01) over the disc (ref:
    ORBextractor IC_Angle), summed pairwise; the angle is atan2(m01, m10)."""
    c = _consts(patches.device)
    m = exact.tree_sum(patches.reshape(patches.shape[0], 1, -1) * c["ic_w"])
    return m[:, 0], m[:, 1]


def _descriptors_patch(patches: torch.Tensor, m10: torch.Tensor,
                       m01: torch.Tensor) -> torch.Tensor:
    """Point pairs rotated by the intensity-centroid angle, compared
    nearest-rounded inside the patch (ref: ORBextractor.cpp GET_VALUE)
    -> [K, 8] int32 words. cos and sin of atan2(m01, m10) are m10 / r and
    m01 / r (1 and 0 where both moments are 0, as atan2(0, 0) = 0)."""
    c = _consts(patches.device)
    xs, ys = c["xs"], c["ys"]
    r = torch.sqrt(m10 * m10 + m01 * m01)
    ok = r > 0
    rs = torch.where(ok, r, 1.0)
    ca = torch.where(ok, m10 / rs, 1.0)
    sa = torch.where(ok, m01 / rs, 0.0)
    rx = ca[:, None] * xs[None] - sa[:, None] * ys[None] + _PATCH_C
    ry = sa[:, None] * xs[None] + ca[:, None] * ys[None] + _PATCH_C
    ix = torch.clamp(torch.round(rx).to(torch.int64), 0, _PATCH - 1)
    iy = torch.clamp(torch.round(ry).to(torch.int64), 0, _PATCH - 1)
    vals = torch.gather(patches.reshape(patches.shape[0], -1), 1, iy * _PATCH + ix)
    return hamming.pack_bits(vals[:, :256] < vals[:, 256:])


def level_budgets(cfg: TrackingConfig) -> np.ndarray:
    """Per-level keypoint budget ∝ scale, summing to max_features_pad."""
    inv_scale = 1.0 / cfg.pyramid_scale
    weights = np.power(inv_scale, np.arange(cfg.pyramid_levels))
    weights /= weights.sum()
    budgets = np.maximum((weights * cfg.max_features_pad).astype(int), 8)
    budgets[0] += cfg.max_features_pad - budgets.sum()
    return budgets


def _linear_taps(n_in: int, n_out: int):
    """jax.image.resize's "linear" weights along one axis (a triangle
    filter, widened by n_in / n_out when downsampling, each output's
    weights normalized to sum to 1) as each output's nonzero taps in input
    order: (input index [n_out, T], weight [n_out, T]), zero-padded."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    w = np.where((sample >= -0.5) & (sample <= n_in - 0.5), w, f32(0.0)).astype(f32).T
    n_taps = max(int((w != 0).sum(axis=1).max()), 1)
    idx = np.zeros((n_out, n_taps), np.int64)
    wt = np.zeros((n_out, n_taps), f32)
    for o in range(n_out):
        nz = np.nonzero(w[o])[0]
        idx[o, :len(nz)], wt[o, :len(nz)] = nz, w[o, nz]
    return idx, wt


_TAPS: dict = {}      # (n_in, n_out, device) -> resize taps, made once


def _taps(n_in: int, n_out: int, device):
    key = (n_in, n_out, device)
    if key not in _TAPS:
        idx, wt = _linear_taps(n_in, n_out)
        _TAPS[key] = (torch.as_tensor(idx).to(device), torch.as_tensor(wt).to(device))
    return _TAPS[key]


def resize_linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """jax.image.resize(img, (nh, nw), "linear"), antialiased when
    downsampling: rows, then columns. Each pass rounds its weighted sum of
    taps to float32 once: the products and their sum are taken in float64
    (a float32 product is exact there), so the result does not hang on the
    order of the additions, on the CPU or on the card. jax.image.resize
    rounds as its backend's matrix product does, which cannot be copied;
    on a flat texture cell that rounding decides descriptor bits."""
    idx, wt = _taps(img.shape[0], nh, img.device)
    taps = img[idx].double() * wt.double()[..., None]  # [nh, T, W]
    out = taps[:, 0]
    for t in range(1, taps.shape[1]):
        out = out + taps[:, t]
    idx, wt = _taps(img.shape[1], nw, img.device)
    taps = out.float()[:, idx].double() * wt.double()  # [nh, nw, T]
    out = taps[..., 0]
    for t in range(1, taps.shape[-1]):
        out = out + taps[..., t]
    return out.float()


def extract_features(gray: torch.Tensor, depth: torch.Tensor,
                     cfg: TrackingConfig, intr: cam.Intrinsics) -> Keypoints:
    """Detect, orient, describe and backproject up to cfg.max_features_pad
    keypoints across the pyramid (ref: BasicAPI.cpp:175-279)."""
    inv_scale = 1.0 / cfg.pyramid_scale
    budgets = level_budgets(cfg)
    dev = gray.device
    out = {k: [] for k in ("uv", "resp", "ang", "desc", "ok", "lvl")}
    img = gray
    scale = 1.0
    h0, w0 = gray.shape
    for lvl in range(cfg.pyramid_levels):
        if lvl > 0:
            nh = max(int(round(h0 * inv_scale ** lvl)), 32)
            nw = max(int(round(w0 * inv_scale ** lvl)), 32)
            img = resize_linear(img, nh, nw)      # recursive, like ORB-SLAM's pyramid
            scale = w0 / nw
        score = _nms(fast_score(img, cfg.fast_threshold))
        border = 16
        h, w = score.shape
        mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
        mask[border:h - border, border:w - border] = True
        score = torch.where(mask, score, 0.0)

        # per-cell argmax, then the strongest cells (spread and strength)
        k = int(budgets[lvl])
        n_cells = k * 4
        gy = max(int(np.floor(np.sqrt(n_cells * h / w))), 1)
        gx = max(n_cells // gy, 1)
        cell_h = -(-h // gy)
        cell_w = -(-w // gx)
        sp = F.pad(score, (0, gx * cell_w - w, 0, gy * cell_h - h))
        cells = sp.reshape(gy, cell_h, gx, cell_w).permute(0, 2, 1, 3)
        cells = cells.reshape(gy * gx, cell_h * cell_w)
        ci = torch.argmax(cells, dim=1)
        cell_resp = torch.gather(cells, 1, ci[:, None])[:, 0]
        cid = torch.arange(gy * gx, device=dev)
        wy = ((cid // gx) * cell_h + ci // cell_w).to(torch.float32)
        wx = ((cid % gx) * cell_w + ci % cell_w).to(torch.float32)
        k = min(k, gy * gx)
        resp, win = torch.sort(cell_resp, descending=True, stable=True)
        resp, win = resp[:k], win[:k]
        vy, vx = wy[win], wx[win]
        patches = _extract_patches(_box_blur(img), vy, vx)
        m10, m01 = _ic_moments(patches)
        ang = torch.atan2(m01, m10)
        out["uv"].append(torch.stack([vx, vy], dim=-1) * scale)
        out["resp"].append(resp)
        out["ang"].append(ang)
        out["desc"].append(_descriptors_patch(patches, m10, m01))
        out["ok"].append(resp > 0)
        out["lvl"].append(torch.full((k,), lvl, dtype=torch.int32, device=dev))

    uv = torch.cat(out["uv"])
    valid = torch.cat(out["ok"])
    # depth at the RAW pixel; backprojection from UNDISTORTED coords
    # (ref: BasicAPI.cpp:195-241, 257-279)
    d, dmask = cam.nearest_sample(depth, uv)
    has_depth = valid & dmask & (d > intr.near) & (d < intr.far)
    uv_ideal = cam.undistort_points(intr, uv)
    pts = cam.unproject(intr, uv_ideal[:, 0], uv_ideal[:, 1], d)
    pts = torch.where(has_depth[:, None], pts, 0.0)
    return Keypoints(uv=uv_ideal, response=torch.cat(out["resp"]), angle=torch.cat(out["ang"]),
                     level=torch.cat(out["lvl"]), desc=torch.cat(out["desc"]), valid=valid,
                     points3d=pts, has_depth=has_depth)
