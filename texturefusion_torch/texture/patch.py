"""Texture patches: the incremental texture cycle's device program.

Port of texturefusion_tpu/texture/patch.py (ref: Structure/Patch.cpp:40-108
CalculateTexCoords — project the mesh vertices into the chosen keyframe,
texture coordinates and bbox; :88-96 wrong-mapping detection, more than
30% of the vertices with a colour difference over 0.6 or a depth
difference over 0.7; Structure/Chisel.cpp:149-189 GeneratePatches).

One call runs the global MRF view selection and, for the chunks whose
label changed or whose mesh changed, the projection, the wrong-mapping
veto, the bbox, and the label and colour-moment updates; then the
per-keyframe colour transfers from every chunk's moments. Plain torch
ops on the tensors' device: the JAX package has no Pallas kernel here.
The host owns the patch records and the atlas (texture/atlas.py,
texture/manager.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from texturefusion_torch.config import TextureConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import se3
from texturefusion_torch.texture import color as color_ops
from texturefusion_torch.texture import mrf as mrf_ops


class IncrementalCycleOut(NamedTuple):
    """What the host reads of one texture cycle."""

    proj_rows: torch.Tensor  # [M] node index of the projected chunks
    proj_kf: torch.Tensor    # [M] adopted keyframe per projected row
    n_changed: torch.Tensor  # scalar — total changed (may exceed M)
    uv16: torch.Tensor       # [M, P, 2] int32 pixel coords × 16, truncated
    uv_valid: torch.Tensor   # [M, P] bool
    bbox_min: torch.Tensor   # [M, 2]
    bbox_max: torch.Tensor   # [M, 2]
    wrong: torch.Tensor      # [M] bool
    t_mats: torch.Tensor     # [K, 3, 3] per-keyframe colour transfer
    mean_t: torch.Tensor     # [K, 3]
    mean_v: torch.Tensor     # [K, 3]


def _unpack(p: torch.Tensor) -> torch.Tensor:
    """[...] packed r | g<<8 | b<<16 → [..., 3] float 0..255."""
    return torch.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF], dim=-1).to(torch.float32)


def _bilinear_packed(rgbp: torch.Tensor, depth: torch.Tensor, row: torch.Tensor,
                     uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear rgb and depth from the packed keyframe stack: rgbp [K, H, W]
    int32, depth [K, H, W] f32, row [M] stack row per chunk, uv [M, P, 2].
    One int32 gather and one f32 gather per tap. Returns (rgb [M, P, 3] in
    0..1, depth [M, P], depth_ok [M, P]).

    Depth is validity-aware, as the reference's sampler is (ref:
    Patch.cpp:110-170): taps without depth (0) weigh nothing, and a sample
    is ok when more than half its bilinear weight falls on valid taps;
    where all four taps are valid it equals the plain interpolation. The
    JAX package interpolates the zeros in, so a vertex next to a hole
    reads a depth far in front of it and counts as occluded (ROADMAP
    Queue 3 fault 10)."""
    _, h, w = rgbp.shape
    x = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    base = row.to(torch.int64)[:, None] * (h * w) + y0 * w + x0    # [M, P]
    pf = rgbp.reshape(-1)
    df = depth.reshape(-1)
    c00, c01 = _unpack(pf[base]), _unpack(pf[base + 1])
    c10, c11 = _unpack(pf[base + w]), _unpack(pf[base + w + 1])
    fxc = fx[..., None]
    top = c00 + (c01 - c00) * fxc
    bot = c10 + (c11 - c10) * fxc
    rgb = (top + (bot - top) * fy[..., None]) / 255.0
    d00, d01, d10, d11 = df[base], df[base + 1], df[base + w], df[base + w + 1]
    dt = d00 + (d01 - d00) * fx
    db = d10 + (d11 - d10) * fx
    taps = torch.stack([d00, d01, d10, d11], dim=-1)
    weights = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=-1)
    weights = torch.where(taps > 0, weights, 0.0)
    mass = weights.sum(dim=-1)
    d_valid = (weights * taps).sum(dim=-1) / torch.clamp(mass, min=1e-12)
    d = torch.where((taps > 0).all(dim=-1), dt + (db - dt) * fy, d_valid)
    return rgb, d, mass > 0.5


def wrong_mapping_tests(tex: torch.Tensor, d_kf: torch.Tensor, d_ok: torch.Tensor,
                        z: torch.Tensor, vert_color: torch.Tensor, intr: cam.Intrinsics,
                        cfg: TextureConfig) -> torch.Tensor:
    """Per-vertex wrong-mapping tests [3, ...]: occluded (more than 5 cm
    behind the keyframe's depth), depth (off it by more than
    wrong_mapping_depth), colour (a channel off the voxel colour by more
    than wrong_mapping_color); the depth tests only where the depth
    sample is ok (ref: Patch.cpp:88-96)."""
    return torch.stack([d_ok & (d_kf > intr.near) & (z > d_kf + 0.05),
                        d_ok & (torch.abs(d_kf - z) > cfg.wrong_mapping_depth),
                        torch.amax(torch.abs(tex - vert_color), dim=-1) > cfg.wrong_mapping_color])


STATS_W = 25    # n, Σtex(3), Σvox(3), Σ tex·texᵀ(9), Σ vox·voxᵀ(9)


def texture_cycle_incremental(
        problem: mrf_ops.MRFProblem,  # node i ↔ chunk slot_idx[i]
        slot_idx: torch.Tensor,       # [N] int64 chunk slot per node
        labels_dev: torch.Tensor,     # [S+1] int32 keyframe label per slot (updated in place)
        stats_dev: torch.Tensor,      # [S+1, STATS_W] f32 colour moments (updated in place)
        failed_dev: torch.Tensor,     # [S+1] int32 keyframe last found wrong (updated in place)
        remeshed_mask: torch.Tensor,  # [N] bool — chunk remeshed this cycle
        pool_verts: torch.Tensor,     # [S+1, P, 3] mesh pool
        pool_colpk: torch.Tensor,     # [S+1, P] int32 packed voxel colours
        pool_vcount: torch.Tensor,    # [S+1] int32
        pool_tcount: torch.Tensor,    # [S+1] int32
        kf_rgbp: torch.Tensor,        # [K, H, W] int32 packed keyframe rgb
        kf_depth: torch.Tensor,       # [K, H, W] f32
        kf_poses: torch.Tensor,       # [K, 4, 4]
        fallback_kf: int,             # label for chunks without a prior label
        intr: cam.Intrinsics,
        cfg: TextureConfig,
        sweeps: int,
        m_budget: int,
) -> IncrementalCycleOut:
    """The incremental texture cycle: MRF view selection over all chunks;
    projection, uv, wrong mapping and colour moments only for the CHANGED
    chunks (label flip or remeshed; ref: the incremental view_selection,
    TexMap.cpp:257-406), up to m_budget of them in node order. Unchanged
    chunks keep their moment rows, so the per-keyframe colour compensation
    (ref: Chisel.cpp:198-286) still sees every patched vertex.

    A projected chunk that is not wrong adopts its new label and moments;
    a wrong one keeps its old label and records the keyframe in
    failed_dev. It is projected again once its selection moves to another
    keyframe (the host poisons the wrong observation, ref:
    MobileFusion.cpp:330-343) or its mesh changes. The JAX package
    projects it again every cycle even when nothing moved (a chunk whose
    label is the fallback, with no observation to poison), and such
    chunks, first in node order, can take the whole budget (ROADMAP
    Queue 3 fault 9); with failed_dev all -1 the two agree. Rows past the
    budget, and the lanes that are not projected, write the trash row
    (-1 and zeros, so duplicate writes agree), which the compensation
    never reads."""
    dev = slot_idx.device
    n = problem.unary.shape[0]
    trash = labels_dev.shape[0] - 1
    k = kf_poses.shape[0]

    sol = mrf_ops.solve_icm(problem, cfg.mrf_potts_weight, cfg.mrf_edge_weight, sweeps=sweeps)
    kf_sel = torch.gather(problem.label_kf, 1, sol[:, None])[:, 0]     # [N]
    old = labels_dev[slot_idx]
    kf_new = torch.where(kf_sel >= 0, kf_sel, torch.where(old >= 0, old, fallback_kf))
    node_ok = (slot_idx != trash) & (pool_vcount[slot_idx] > 0)
    moved = (kf_new != old) & (kf_new != failed_dev[slot_idx])
    changed = node_ok & (moved | remeshed_mask)

    # the changed nodes in order, compacted to the projection budget
    cum = torch.cumsum(changed.to(torch.int64), dim=0)
    n_changed = cum[-1]
    ar = torch.arange(m_budget, device=dev)
    rows = torch.clamp(torch.searchsorted(cum, ar + 1), max=n - 1)
    row_ok = ar < torch.clamp(n_changed, max=m_budget)
    csl = torch.where(row_ok, slot_idx[rows], trash)                   # [M]

    # ---- projection of the changed chunks into their new keyframes
    verts = pool_verts[csl]                                            # [M, P, 3]
    vert_color = _unpack(pool_colpk[csl]) / 255.0
    p = verts.shape[1]
    vert_valid = torch.arange(p, device=dev)[None, :] < pool_vcount[csl][:, None]
    kfr = torch.clamp(kf_new[rows], 0, k - 1).to(torch.int64)          # [M]
    w2c = se3.inverse(kf_poses)[kfr]
    pts_cam = torch.einsum("uij,upj->upi", w2c[:, :3, :3], verts) + w2c[:, None, :3, 3]
    uv, z = cam.project(intr, pts_cam)
    ok = vert_valid & cam.in_image(intr, uv, margin=1.0) & (z > intr.near) & row_ok[:, None]

    tex, d_kf, d_ok = _bilinear_packed(kf_rgbp, kf_depth, kfr, uv)
    bad = ok & wrong_mapping_tests(tex, d_kf, d_ok, z, vert_color, intr, cfg).any(dim=0)
    n_ok = ok.sum(dim=1)
    wrong = (bad.sum(dim=1) / torch.clamp(n_ok, min=1)) > cfg.wrong_mapping_frac
    wrong = wrong | (n_ok == 0)

    big = 1e9
    bbox_min = torch.floor(torch.where(ok[..., None], uv, big).amin(dim=1) - 1.0)
    bbox_max = torch.ceil(torch.where(ok[..., None], uv, -big).amax(dim=1) + 1.0)
    lim = torch.tensor([intr.width - 1, intr.height - 1], dtype=torch.float32, device=dev)
    bbox_min = torch.minimum(torch.clamp(bbox_min, min=0.0), lim)
    bbox_max = torch.minimum(torch.clamp(bbox_max, min=0.0), lim)

    # ---- labels and colour moments of the projected, non-wrong chunks
    adopt = row_ok & ~wrong
    lab_val = torch.where(adopt, kf_new[rows], labels_dev[csl])
    row_sl = torch.where(row_ok, csl, trash)
    labels_dev[row_sl] = torch.where(row_ok, lab_val, -1)
    failed_dev[row_sl] = torch.where(row_ok & wrong, kf_new[rows], -1)

    wgt = (ok & ~wrong[:, None]).to(torch.float32)                    # [M, P]
    s_tt = torch.einsum("mp,mpc,mpd->mcd", wgt, tex, tex)
    s_vv = torch.einsum("mp,mpc,mpd->mcd", wgt, vert_color, vert_color)
    stat_rows = torch.cat([wgt.sum(dim=1)[:, None],
                           torch.einsum("mp,mpc->mc", wgt, tex),
                           torch.einsum("mp,mpc->mc", wgt, vert_color),
                           s_tt.reshape(-1, 9), s_vv.reshape(-1, 9)], dim=1)   # [M, 25]
    stats_dev[torch.where(adopt, csl, trash)] = torch.where(adopt[:, None], stat_rows, 0.0)

    # ---- per-keyframe colour compensation from every chunk's moments
    seg_ok = (labels_dev >= 0) & (pool_tcount > 0)
    seg_ok[trash] = False
    seg = torch.where(seg_ok, torch.clamp(labels_dev, 0, k - 1), k).to(torch.int64)
    agg = torch.zeros((k + 1, STATS_W), device=dev).index_add_(0, seg, stats_dev)[:k]
    cnt = torch.clamp(agg[:, 0], min=1e-6)[:, None]
    mean_t = agg[:, 1:4] / cnt
    mean_v = agg[:, 4:7] / cnt
    cov_t = agg[:, 7:16].reshape(-1, 3, 3) / cnt[..., None] \
        - mean_t[:, :, None] * mean_t[:, None, :]
    cov_v = agg[:, 16:25].reshape(-1, 3, 3) / cnt[..., None] \
        - mean_v[:, :, None] * mean_v[:, None, :]
    t_mats = color_ops.transfer_matrices(mean_t, cov_t, mean_v, cov_v)

    uv16 = torch.clamp(uv * 16.0, 0, 65535).to(torch.int32)
    return IncrementalCycleOut(
        proj_rows=rows, proj_kf=kf_new[rows], n_changed=n_changed, uv16=uv16, uv_valid=ok,
        bbox_min=bbox_min, bbox_max=bbox_max, wrong=wrong, t_mats=t_mats,
        mean_t=mean_t, mean_v=mean_v)
