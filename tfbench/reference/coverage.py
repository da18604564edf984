"""How much of the scene the map covers, in NumPy.

`surface_samples` casts rays of the camera (its pixels undistorted as
tfbench/traffic/render.py does) from the ground-truth poses into the
analytic scene of tfbench/reference/scene.py, in closed form: the
nearest of the room's walls, seen from inside, and the spheres. The hits
within the sensor's range are the surface the path sees. `covered`
tells which samples have a mesh vertex near them: within `along` of the
sample across the surface, and within `across` of it along the scene's
normal there, so that an error of the map's position, which the map's
own numbers judge, does not read as a hole, while a hole wider than
twice `along` does. Nothing here imports the program.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

from tfbench.reference.scene import Scene

_BIAS = 1 << 20


def undistorted_rays(cam: Dict, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Unit camera-frame rays [P, 3] of pixels (u, v): 8 fixed-point
    iterations of the inverse Brown model of the camera entry."""
    k1, k2, p1, p2, k3 = (float(cam.get(f"d{i}", 0.0)) for i in range(5))
    xd = (u - cam["cx"]) / cam["fx"]
    yd = (v - cam["cy"]) / cam["fy"]
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def ray_hits(scene: Scene, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Distance [P] along unit rays dirs [P, 3] from origin [3] (inside
    the room, outside the spheres) to the first surface."""
    with np.errstate(divide="ignore", invalid="ignore"):
        wall = np.where(dirs > 0, (scene.room_max - origin) / dirs,
                        np.where(dirs < 0, (scene.room_min - origin) / dirs, np.inf))
    t = wall.min(axis=1)
    for cx, cy, cz, r in scene.spheres:
        oc = origin - np.asarray([cx, cy, cz])
        b = dirs @ oc
        disc = b * b - (oc @ oc - r * r)
        near = -b - np.sqrt(np.maximum(disc, 0.0))
        t = np.where((disc > 0) & (near > 0) & (near < t), near, t)
    return t


def surface_samples(scene: Scene, cam: Dict, poses: np.ndarray, per_frame: int,
                    rng: np.random.Generator, far: float) -> np.ndarray:
    """[N * per_frame or fewer, 3] world points of the scene's surface
    seen from camera-to-world poses [N, 4, 4] through `per_frame` pixels
    each, drawn with `rng`, at depths under `far`."""
    out = []
    w, h = int(cam["width"]), int(cam["height"])
    for pose in np.asarray(poses, np.float64):
        u = rng.uniform(0.5, w - 1.5, per_frame)
        v = rng.uniform(0.5, h - 1.5, per_frame)
        rays = undistorted_rays(cam, u, v)
        dirs = rays @ pose[:3, :3].T
        t = ray_hits(scene, pose[:3, 3], dirs)
        depth = t * rays[:, 2]
        keep = np.isfinite(t) & (depth < far)
        out.append(pose[:3, 3] + dirs[keep] * t[keep, None])
    return np.concatenate(out) if out else np.zeros((0, 3))


def normals(scene: Scene, pts: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Unit normals [P, 3] of the scene's surface at points [P, 3] on it:
    the gradient of its signed distance, by central differences."""
    g = np.stack([scene.sdf(pts + e) - scene.sdf(pts - e) for e in np.eye(3) * eps], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def _keys(cells: np.ndarray) -> np.ndarray:
    c = cells + _BIAS
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def covered(samples: np.ndarray, normals_: np.ndarray, verts: np.ndarray, along: float,
            across: float, block: int = 8192) -> np.ndarray:
    """[P] bool: whether some vertex of verts [V, 3] lies within `along` of
    sample p across the surface (the distance from the line through p
    along its normal n) and within `across` of p along n."""
    out = np.zeros(len(samples), bool)
    if not len(verts) or not len(samples):
        return out
    size = max(along, across)
    key = _keys(np.floor(verts / size).astype(np.int64))
    order = np.argsort(key, kind="stable")
    key, verts = key[order], verts[order]
    for b0 in range(0, len(samples), block):
        p, n = samples[b0:b0 + block], normals_[b0:b0 + block]
        cell = np.floor(p / size).astype(np.int64)
        hit = np.zeros(len(p), bool)
        for off in itertools.product((-1, 0, 1), repeat=3):
            k = _keys(cell + np.asarray(off, np.int64))
            lo = np.searchsorted(key, k, "left")
            cnt_all = np.searchsorted(key, k, "right") - lo
            has = np.nonzero((cnt_all > 0) & ~hit)[0]
            if not len(has):
                continue
            cnt = cnt_all[has]
            owner = np.repeat(has, cnt)
            idx = (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                   + np.repeat(lo[has], cnt))
            d = verts[idx] - p[owner]
            a = np.einsum("ij,ij->i", d, n[owner])
            inplane = np.einsum("ij,ij->i", d, d) - a * a
            ok = (np.abs(a) <= across) & (inplane <= along * along)
            hit[owner[ok]] = True
        out[b0:b0 + block] = hit
    return out
