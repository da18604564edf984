"""Trajectories and their error, in NumPy.

`loop` is a frozen copy of texturefusion_torch/io/synthetic.py
`loop_trajectory` (the camera rides a circle looking radially outward);
`align_umeyama` and `ate_rmse` are frozen copies of
texturefusion_torch/io/tum.py (SE3 Umeyama alignment, no scale, as the
TUM benchmark's ATE tool). Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def loop(n_frames: int, radius: float, revolutions: float, center=(0.0, 0.0, 0.0),
         bob: float = 0.05, start_deg: float = 0.0) -> np.ndarray:
    """[n_frames, 4, 4] float32 camera-to-world poses along a circle of
    `radius` around `center`, `revolutions` turns over n_frames from the
    angle `start_deg`, the camera looking radially outward, bobbing `bob`
    metres up and down three times a turn (camera y points down). Past one
    turn the loop closes on itself; a fraction of a turn is a pan."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    up_hint = np.asarray([0.0, -1.0, 0.0])
    for i in range(n_frames):
        a = np.deg2rad(start_deg) + 2.0 * np.pi * revolutions * i / max(n_frames - 1, 1)
        eye = np.asarray(center) + np.asarray(
            [radius * np.sin(a), bob * np.sin(3 * a), radius * np.cos(a)])
        z_axis = np.asarray([np.sin(a), 0.0, np.cos(a)])
        z_axis = z_axis / np.linalg.norm(z_axis)
        x_axis = np.cross(up_hint, z_axis)
        x_axis = x_axis / np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        poses[i, :3, 0] = x_axis
        poses[i, :3, 1] = y_axis
        poses[i, :3, 2] = z_axis
        poses[i, :3, 3] = eye
        poses[i, 3, 3] = 1.0
    return poses


TRAJECTORIES = {"loop": loop}


def make(spec: Dict, n_frames: int) -> np.ndarray:
    """The ground-truth poses a traffic mix's "trajectory" entry names:
    {"kind": <a key of TRAJECTORIES>, **its arguments}, with an optional
    "base_frames": the path is laid out over that many frames and its
    first n_frames taken, so a shorter session rides a shorter arc at the
    same speed."""
    kw = {k: v for k, v in spec.items() if k not in ("kind", "base_frames")}
    base = max(n_frames, int(spec.get("base_frames", n_frames)))
    return TRAJECTORIES[spec["kind"]](base, **kw)[:n_frames]


def align_umeyama(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rot [3, 3], t [3]) with p_gt ~ rot @ p_est + t, from the camera
    positions of matched poses [N, 4, 4] (SE3, no scale)."""
    est_t = np.asarray(est, np.float64)[:, :3, 3]
    gt_t = np.asarray(gt, np.float64)[:, :3, 3]
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    cov = (gt_t - mu_g).T @ (est_t - mu_e) / len(est_t)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    return rot, mu_g - rot @ mu_e


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error RMSE (m) after align_umeyama."""
    rot, t = align_umeyama(est, gt)
    err = np.asarray(est, np.float64)[:, :3, 3] @ rot.T + t - np.asarray(gt, np.float64)[:, :3, 3]
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
