"""The comparison that decides `correct`, in NumPy.

Each session of a run hands over what the program made of it (see
tfbench/session.py `Outputs`): every frame's pose, the final mesh's
vertices, a seeded sample of the fused TSDF's voxels, and the texture's
colour at each textured vertex. Each is judged against what the
benchmark itself generated: the ground-truth poses of the traffic and
the analytic scene of the configuration. The map, the TSDF and the
texture are moved into the ground-truth frame by the Umeyama alignment
of the session's trajectory (the program's map lives in its first
keyframe's frame). A run's number is the worst of its sessions'.

  ate_mm          ATE RMSE of the trajectory (trajectory.ate_rmse)
  map_rms_mm      RMS |scene sdf| at the mesh's vertices
  tsdf_median_mm  median |stored sdf - scene sdf| at the sampled voxels
                  that were observed (weight > 0) within two voxels of
                  the surface by their stored value
  colour_median   median over textured vertices of the mean over the
                  channels of |atlas colour - scene albedo|, in 8-bit
                  levels
  export_colour_median
                  the same over every vertex of the textured export (its
                  compensated colours, the fused voxel colour where a
                  projection is invalid), after one gain a channel
                  fitted by least squares. Logged, and compared only
                  where a cell's limits name it: the compensation matches
                  each keyframe's colours to the fused voxel colours'
                  mean and covariance, which is not the albedo's, so the
                  sound export reads about as far off as a broken one
                  (PERF.md section 2)
  uncovered_pct   the share of the scene's surface seen along the
                  ground-truth path (coverage.surface_samples) with no
                  mesh vertex near it, in %: none within two voxels
                  across the surface and ACROSS_M (or two voxels, if
                  more) along its normal (coverage.covered), so that the
                  map's position error, which map_rms_mm judges, is not
                  read as a hole
  untextured_pct  the share of that surface with no textured vertex (one
                  colour_median reads) near it, in the same sense: holes
                  in the textured model, of the mesh or of the texture

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tfbench.reference import coverage
from tfbench.reference import trajectory as traj
from tfbench.reference.scene import Scene

NUMBERS = ("ate_mm", "map_rms_mm", "tsdf_median_mm", "colour_median",
           "export_colour_median", "uncovered_pct", "untextured_pct")
SAMPLES_PER_FRAME = 512
ACROSS_M = 0.03


def sample_atlas(image: np.ndarray, size: int, uv: np.ndarray) -> np.ndarray:
    """Bilinear sample [P, 3] in [0, 1] of an atlas image [rows, size, 3]
    uint8 at normalized uv [P, 2] (v up, the OBJ convention of the
    program's export), rows clamped to the image."""
    rows = image.shape[0]
    x = np.clip(uv[:, 0] * size, 0, size - 1)
    y = np.clip((1.0 - uv[:, 1]) * size, 0, rows - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, size - 1)
    y1 = np.minimum(y0 + 1, rows - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def at(yy, xx):
        return image[yy, xx].astype(np.float64) / 255.0

    return ((at(y0, x0) * (1 - fx) + at(y0, x1) * fx) * (1 - fy)
            + (at(y1, x0) * (1 - fx) + at(y1, x1) * fx) * fy)


def surface(scene: Scene, config: Dict, gt: np.ndarray, seed: int) -> np.ndarray:
    """The scene's surface that ground-truth poses gt [N, 4, 4] see, drawn
    from `seed` (the same for every session of a run): SAMPLES_PER_FRAME
    pixels a frame within the pipeline's far plane."""
    rng = np.random.default_rng([seed % (1 << 64), 11])
    far = float(config["pipeline"]["camera"].get("far_plane", 3.0))
    return coverage.surface_samples(scene, config["camera"], gt, SAMPLES_PER_FRAME, rng, far)


def gain_fitted_median(got: np.ndarray, want: np.ndarray) -> float:
    """Median over points of the mean over channels of |g got - want| in
    8-bit levels, g one gain a channel fitted by least squares."""
    g = (got * want).sum(axis=0) / np.maximum((got * got).sum(axis=0), 1e-12)
    return float(np.median(np.abs(got * g - want).mean(axis=1)) * 255.0)


def session_numbers(out, gt: np.ndarray, scene: Scene, voxel: float,
                    samples: np.ndarray) -> Dict[str, float]:
    """The compared numbers of one session's outputs `out` against its
    ground-truth poses gt [N, 4, 4] and the surface `samples` [P, 3] they
    see. A session that gave no pose for a frame, no vertex, no observed
    voxel or no textured vertex reads inf on that number."""
    inf = float("inf")
    res = {k: inf for k in NUMBERS}
    est = np.asarray(out.poses, np.float64)
    if est.shape != gt.shape or not np.isfinite(est).all():
        return res
    res["ate_mm"] = traj.ate_rmse(est, gt) * 1e3
    rot, t = traj.align_umeyama(est, gt)
    if len(out.verts):
        v = np.asarray(out.verts, np.float64) @ rot.T + t
        d = scene.sdf(v)
        res["map_rms_mm"] = float(np.sqrt(np.mean(d * d)) * 1e3)
    if len(out.vox_sdf):
        near = np.abs(out.vox_sdf) < 2.0 * voxel
        if near.any():
            c = np.asarray(out.vox_pos[near], np.float64) @ rot.T + t
            res["tsdf_median_mm"] = float(
                np.median(np.abs(out.vox_sdf[near] - scene.sdf(c))) * 1e3)
    if len(out.tex_verts):
        got = np.asarray(out.tex_rgb, np.float64)
        want = scene.color((np.asarray(out.tex_verts, np.float64) @ rot.T + t)
                           .astype(np.float32)).astype(np.float64)
        res["colour_median"] = float(np.median(np.abs(got - want).mean(axis=1)) * 255.0)
    if len(out.export_verts):
        want = scene.color((np.asarray(out.export_verts, np.float64) @ rot.T + t)
                           .astype(np.float32)).astype(np.float64)
        res["export_colour_median"] = gain_fitted_median(
            np.asarray(out.export_rgb, np.float64), want)
    if len(samples):
        normals = coverage.normals(scene, samples)
        across = max(ACROSS_M, 2.0 * voxel)
        for name, verts in (("uncovered_pct", out.verts), ("untextured_pct", out.tex_verts)):
            v = np.asarray(verts, np.float64) @ rot.T + t
            near = coverage.covered(samples, normals, v, 2.0 * voxel, across)
            res[name] = 100.0 * float(1.0 - near.mean())
    return res


def run_numbers(per_session: List[Dict[str, float]]) -> Dict[str, float]:
    """A run's numbers: each the worst (largest) over its sessions."""
    return {k: max(s[k] for s in per_session) for k in NUMBERS}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit", "ok"}} for every limited number; a number
    that is not finite fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and bool(np.isfinite(v)) and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": ok}
    return out


def verdict(judged: Dict[str, dict]) -> Optional[bool]:
    return all(j["ok"] for j in judged.values())
