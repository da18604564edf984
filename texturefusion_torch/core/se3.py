"""Batched SO(3)/SE(3) Lie-group operations on torch tensors.

Port of texturefusion_tpu/core/se3.py (ref: GCSLAM/frame.h:14,
MultiViewGeometry.cpp:1101-1112 SE3 exp update). Poses are (..., 4, 4)
homogeneous matrices, twists (..., 6) ordered [rho, omega] as in
Sophus' SE3::exp.

Point transforms are written as three elementwise multiply-adds in a
fixed order rather than a matmul: the TSDF voxel kernel
(csrc/tsdf_integrate.cu) repeats exactly these roundings, so the kernel
and its plain version project every voxel to the same pixel.
"""

from __future__ import annotations

import torch

# 3x3/4x4 pose algebra in full float32 on the card, never TF32.
torch.backends.cuda.matmul.allow_tf32 = False

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(ox)
    return torch.stack([
        torch.stack([zero, -oz, oy], dim=-1),
        torch.stack([oz, zero, -ox], dim=-1),
        torch.stack([-oy, ox, zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3). Taylor-safe at 0."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = k @ k
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3(k) + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) principal rotation vector, through the
    quaternion (stable up to theta = pi)."""
    q = quaternion_from_matrix(rot)
    xyz, w = q[..., :3], q[..., 3]
    sign = torch.where(w < 0, -1.0, 1.0)
    xyz = xyz * sign[..., None]
    w = w * sign
    s = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(s, w)
    scale = torch.where(s > _EPS, theta / torch.clamp(s, min=_EPS),
                        2.0 / torch.clamp(w, min=_EPS))
    return xyz * scale[..., None]


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V used in SE(3) exp: t = V·rho."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = k @ k
    big = theta2 > _EPS
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    return _eye3(k) + b[..., None, None] * k + c[..., None, None] * k2


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = k @ k
    cot_term = torch.where(
        theta2 > _EPS,
        (1.0 - theta * torch.cos(theta * 0.5)
         / (2.0 * torch.sin(theta * 0.5) + _EPS)) / theta2,
        1.0 / 12.0 + theta2 / 720.0)
    return _eye3(k) - 0.5 * k + cot_term[..., None, None] * k2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [rho, omega] -> (..., 4, 4) homogeneous matrix."""
    rho, omega = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(omega) @ rho[..., None])[..., 0]
    return make_pose(so3_exp(omega), t)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [rho, omega]."""
    omega = so3_log(pose[..., :3, :3])
    rho = (_left_jacobian_inv(omega) @ pose[..., :3, 3, None])[..., 0]
    return torch.cat([rho, omega], dim=-1)


def make_pose(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype,
                          device=rot.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4)).clone()


def _rot_apply(rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) times (..., N, 3) points: three elementwise multiplies
    per output, summed x + y + z in that order."""
    r = rot[..., None, :, :]               # (..., 1, 3, 3)
    p = pts[..., :, None, :]               # (..., N, 1, 3)
    return r[..., 0] * p[..., 0] + r[..., 1] * p[..., 1] + r[..., 2] * p[..., 2]


def rotate_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return _rot_apply(pose[..., :3, :3], pts)


def transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) points: R·p, then + t."""
    return _rot_apply(pose[..., :3, :3], pts) + pose[..., None, :3, 3]


def inverse(pose: torch.Tensor) -> torch.Tensor:
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t = pose[..., None, :3, 3]             # (..., 1, 3)
    return make_pose(rot_t, -_rot_apply(rot_t, t)[..., 0, :])


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def pose_distance(a: torch.Tensor, b: torch.Tensor,
                  rot_weight: float = 1.0, trans_weight: float = 1.0) -> torch.Tensor:
    """Weighted SE3 delta cost between two poses (ref: MapMaintain.hpp:239-258)."""
    xi = se3_log(compose(inverse(a), b))
    return (trans_weight * torch.sum(xi[..., :3] ** 2, dim=-1)
            + rot_weight * torch.sum(xi[..., 3:] ** 2, dim=-1))


def quaternion_from_matrix(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), TUM order
    (ref: BasicAPI.cpp:74-91)."""
    m = rot
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    trace = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = root(trace + 1.0)
    qw = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s,
                      (m[..., 0, 2] - m[..., 2, 0]) / s,
                      (m[..., 1, 0] - m[..., 0, 1]) / s, 0.25 * s], dim=-1)
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m[..., 0, 1] + m[..., 1, 0]) / s,
                      (m[..., 0, 2] + m[..., 2, 0]) / s,
                      (m[..., 2, 1] - m[..., 1, 2]) / s], dim=-1)
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m[..., 0, 1] + m[..., 1, 0]) / s, 0.25 * s,
                      (m[..., 1, 2] + m[..., 2, 1]) / s,
                      (m[..., 0, 2] - m[..., 2, 0]) / s], dim=-1)
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m[..., 0, 2] + m[..., 2, 0]) / s,
                      (m[..., 1, 2] + m[..., 2, 1]) / s, 0.25 * s,
                      (m[..., 1, 0] - m[..., 0, 1]) / s], dim=-1)
    use_w = (trace > 0)[..., None]
    x_big = ((m00 >= m11) & (m00 >= m22))[..., None]
    y_big = (m11 >= m22)[..., None]
    out = torch.where(use_w, qw, torch.where(x_big, qx,
                                             torch.where(y_big, qy, qz)))
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
