"""TUM RGB-D dataset reader and trajectory accuracy.

Port of texturefusion_tpu/io/tum.py (ref: BasicAPI.cpp:1032-1134
initOfflineData — associate.txt / groundtruth.txt / calib.txt parsing;
Tools/DatasetWrapper.hpp:15-263), whose `io/__init__.py` imports jax.
Frames are read through io/png, not cv2 (the card's machine has no image
library); rotations come from core/se3 on the CPU.

`calib.txt` wins over the camera the caller passes, as in the JAX package
and the reference (which reads it unconditionally); the port warns,
naming the fields it replaced.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.config import CameraConfig
from texturefusion_torch.core import se3
from texturefusion_torch.io import png


@dataclasses.dataclass
class TumSequence:
    root: str
    rgb_files: List[str]
    depth_files: List[str]
    timestamps: np.ndarray                  # (N,) rgb timestamps
    camera: CameraConfig
    gt_timestamps: Optional[np.ndarray] = None
    gt_poses: Optional[np.ndarray] = None   # (M, 4, 4)

    def __len__(self) -> int:
        return len(self.rgb_files)

    def load_frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (depth_meters [H, W] f32, rgb [H, W, 3] f32 in [0, 1])."""
        depth_raw, rgb_raw = self.load_frame_raw(i)
        return (depth_raw.astype(np.float32) / self.camera.depth_scale,
                rgb_raw.astype(np.float32) / 255.0)

    def load_frame_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """The sensor formats (depth uint16 [H, W], rgb uint8 [H, W, 3] in
        RGB order), converted on the device by preprocess_bundle."""
        depth = png.read_png(self.depth_files[i])
        if depth.dtype != np.uint16:
            raise ValueError(f"{self.depth_files[i]}: depth must be 16-bit greyscale")
        rgb = png.read_png(self.rgb_files[i])
        if rgb.ndim != 3:
            raise ValueError(f"{self.rgb_files[i]}: rgb must be 8-bit colour")
        return depth, rgb


def _parse_calib(path: str) -> CameraConfig:
    """13-field calib.txt: fx fy cx cy width height scale [d0..d4]
    (ref: BasicAPI.cpp:1108-1133)."""
    with open(path) as f:
        vals = [float(x) for x in f.read().split()]
    kw = dict(fx=vals[0], fy=vals[1], cx=vals[2], cy=vals[3],
              width=int(vals[4]), height=int(vals[5]), depth_scale=vals[6])
    if len(vals) >= 12:
        kw.update(d0=vals[7], d1=vals[8], d2=vals[9], d3=vals[10], d4=vals[11])
    return CameraConfig(**kw)


def _parse_groundtruth(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt: `ts tx ty tz qx qy qz qw` (ref: BasicAPI.cpp:1084-1106)."""
    with open(path) as f:
        lines = f.read().splitlines()
    ts, poses = [], []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        if len(vals) < 8:
            continue
        ts.append(vals[0])
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = se3.matrix_from_quaternion(
            torch.tensor(vals[4:8], dtype=torch.float32)).numpy()
        pose[:3, 3] = vals[1:4]
        poses.append(pose)
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def load_tum_sequence(root: str, camera: Optional[CameraConfig] = None) -> TumSequence:
    """Load via associate.txt (`ts_rgb rgb_path ts_depth depth_path`) with
    calib.txt and an optional groundtruth.txt, like the reference's
    initOfflineData. calib.txt, when present, replaces `camera` whole
    (far_plane included) and a warning names the fields that changed;
    `camera` is the fallback for directories without one."""
    with open(os.path.join(root, "associate.txt")) as f:
        lines = f.read().splitlines()
    rgb_files, depth_files, timestamps = [], [], []
    for line in lines:
        parts = line.split()
        if len(parts) < 4:
            continue
        timestamps.append(float(parts[0]))
        # the reference's convention: column 1 the rgb path, column 3 the depth path
        rgb_files.append(os.path.join(root, parts[1]))
        depth_files.append(os.path.join(root, parts[3]))
    calib = os.path.join(root, "calib.txt")
    if os.path.exists(calib):
        on_disk = _parse_calib(calib)
        if camera is not None:
            dropped = [f.name for f in dataclasses.fields(CameraConfig)
                       if getattr(camera, f.name) != getattr(on_disk, f.name)]
            if dropped:
                warnings.warn(f"{calib} overrides the camera passed in: its values replace "
                              f"{', '.join(dropped)}")
        camera = on_disk
    elif camera is None:
        camera = CameraConfig()
    gt_ts = gt_poses = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt_ts, gt_poses = _parse_groundtruth(gt_path)
    return TumSequence(root=root, rgb_files=rgb_files, depth_files=depth_files,
                       timestamps=np.asarray(timestamps), camera=camera,
                       gt_timestamps=gt_ts, gt_poses=gt_poses)


def align_umeyama(est_poses: np.ndarray, gt_poses: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SE3 (Umeyama, no scale) alignment est→gt from matched poses.
    Returns (rot[3,3], t[3]) with p_gt ≈ rot @ p_est + t."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    xe, xg = est_t - mu_e, gt_t - mu_g
    cov = xg.T @ xe / len(est_t)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    return rot, mu_g - rot @ mu_e


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE after SE3 (Umeyama, no scale)
    alignment; est_poses/gt_poses (N, 4, 4) with matching indices."""
    rot, t = align_umeyama(est_poses, gt_poses)
    err = est_poses[:, :3, 3] @ rot.T + t - gt_poses[:, :3, 3]
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray,
                         max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (like TUM associate.py):
    (index in ts_a, index in the sorted ts_b) within max_dt."""
    pairs = []
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b) and abs(ts_b[k] - t) <= best_dt:
                best, best_dt = k, abs(ts_b[k] - t)
        if best >= 0:
            pairs.append((i, best))
    return pairs


def trajectory_from_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A trajectory.txt (or groundtruth.txt) in TUM format -> (timestamps,
    poses [N, 4, 4])."""
    return _parse_groundtruth(path)
