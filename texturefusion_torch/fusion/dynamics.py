"""Re-integration scheduling from pose drift (numpy only).

A copy of texturefusion_tpu/fusion/dynamics.py (ref:
GCFusion/MobileFusion.cpp:13-67 GetMapDynamics; GCFusion/MapMaintain.hpp
:239-258 GetPoseDifference and :175-238 SelectLargestNValues): keyframes
whose current BA pose drifted from the pose they were last integrated at
are de-integrated and re-integrated. Selection uses moving-average
windows over the per-keyframe drift costs, picking the segments with the
largest accumulated drift.
"""

from __future__ import annotations

from typing import List

import numpy as np

DRIFT_THRESHOLD = 1e-4   # ref: MapMaintain.hpp threshold on window cost


def pose_drift_costs(current: np.ndarray, integrated: np.ndarray) -> np.ndarray:
    """Weighted SE3 delta cost per keyframe [K]
    (ref: GetPoseDifference MapMaintain.hpp:239-258), in float64 numpy:
    K is small and this runs every fusion cycle."""
    if len(current) == 0:
        return np.zeros(0, np.float32)
    a = np.asarray(current, np.float64)
    b = np.asarray(integrated, np.float64)
    ra = a[:, :3, :3]
    rel_r = np.einsum("kji,kjl->kil", ra, b[:, :3, :3])      # raᵀ·rb
    rel_t = np.einsum("kji,kj->ki", ra, b[:, :3, 3] - a[:, :3, 3])
    tr = np.clip((np.trace(rel_r, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    w = np.stack([rel_r[:, 2, 1] - rel_r[:, 1, 2],
                  rel_r[:, 0, 2] - rel_r[:, 2, 0],
                  rel_r[:, 1, 0] - rel_r[:, 0, 1]], axis=-1)
    s = 2.0 * np.sin(theta)
    scale = np.where(theta > 1e-8, theta / np.maximum(s, 1e-12), 0.5)
    omega = w * scale[:, None]
    # rho = V⁻¹·t  (V = SO3 left Jacobian)
    k = np.zeros((len(a), 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -omega[:, 2], omega[:, 1], -omega[:, 0]
    k[:, 1, 0], k[:, 2, 0], k[:, 2, 1] = omega[:, 2], -omega[:, 1], omega[:, 0]
    th2 = theta * theta
    coef = np.where(theta > 1e-6,
                    (1.0 - theta * np.sin(theta)
                     / np.maximum(2.0 * (1.0 - np.cos(theta)), 1e-12))
                    / np.maximum(th2, 1e-12),
                    1.0 / 12.0)
    v_inv = (np.eye(3)[None] - 0.5 * k
             + coef[:, None, None] * np.matmul(k, k))
    rho = np.einsum("kij,kj->ki", v_inv, rel_t)
    # rotation weighted 9×, translation 1× — the reference's
    # cost = 9·Σ angle² + Σ t² (MapMaintain.hpp:255-257; for small
    # angles ‖euler‖ ≈ ‖ω‖)
    return (1.0 * np.sum(rho ** 2, axis=-1)
            + 9.0 * np.sum(omega ** 2, axis=-1)).astype(np.float32)


def select_keyframes_to_update(costs: np.ndarray, max_updates: int = 4,
                               window: int = 3,
                               threshold: float = DRIFT_THRESHOLD) -> List[int]:
    """Moving-average window selection (ref: SelectLargestNValues
    MapMaintain.hpp:175-238): smooth the drift costs with a centred
    window, then greedily take the highest-cost keyframes above threshold,
    suppressing immediate neighbours so updates spread across the map."""
    k = len(costs)
    if k == 0:
        return []
    smoothed = np.copy(costs).astype(np.float64)
    if k >= window > 1:
        # ('same' mode returns len(kernel) when the signal is shorter —
        # hence the k >= window guard)
        kernel = np.ones(window) / window
        smoothed = np.convolve(costs, kernel, mode="same")
    order = np.argsort(-smoothed)
    picked: List[int] = []
    suppressed = np.zeros(k, bool)
    for i in order:
        if len(picked) >= max_updates:
            break
        if suppressed[i] or smoothed[i] <= threshold:
            continue
        # the smoothed peak can sit on a NEIGHBOUR of the drifted keyframe
        # (the raw peak leaks into adjacent windows); reintegrate the raw
        # argmax within the window or the drift never clears
        lo = max(0, i - 1)
        hi = min(k, i + 2)
        j = lo + int(np.argmax(costs[lo:hi]))
        if j not in picked:
            picked.append(j)
        suppressed[lo:hi] = True
        suppressed[max(0, j - 1):min(k, j + 2)] = True
    return picked
