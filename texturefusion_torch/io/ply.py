"""Mesh export: binary PLY writer and reader (numpy only).

A copy of texturefusion_tpu/io/ply.py without the trajectory writer:
importing that package's `io` pulls in jax through its `__init__`.
Replaces the reference's PLY saver (ref: open_chisel/io/PLY.cpp,
Structure/Chisel.cpp:357-379 SaveAllMeshesToPLY).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_ply(path: str, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None) -> None:
    """Write a binary-little-endian PLY. vertices (N,3) f32, faces (M,3) int,
    colors (N,3) float [0,1] or uint8, normals (N,3)."""
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        cols = [vertices.astype("<f4")]
        if normals is not None:
            cols.append(normals.astype("<f4"))
        vdata = np.concatenate(
            [np.ascontiguousarray(c).view(np.uint8).reshape(n, -1)
             for c in cols], axis=1)
        if colors is not None:
            vdata = np.concatenate([vdata, colors.reshape(n, 3)], axis=1)
        f.write(vdata.tobytes())
        if faces is not None:
            m = len(faces)
            fdata = np.empty((m, 13), dtype=np.uint8)
            fdata[:, 0] = 3
            fdata[:, 1:] = (np.ascontiguousarray(faces.astype("<i4"))
                            .view(np.uint8).reshape(m, 12))
            f.write(fdata.tobytes())


def load_ply(path: str):
    """Minimal binary/ascii PLY reader for round-trip tests."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    body = data[end:]
    n_vert = n_face = 0
    props = []
    mode = None
    binary = True
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            binary = parts[1].startswith("binary")
        elif parts[0] == "element":
            mode = parts[1]
            if mode == "vertex":
                n_vert = int(parts[2])
            elif mode == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and mode == "vertex":
            props.append((parts[-1], parts[1]))
    assert binary, "only binary PLY supported"
    fmt_map = {"float": ("<f4", 4), "uchar": ("u1", 1), "float32": ("<f4", 4),
               "uint8": ("u1", 1)}
    stride = sum(fmt_map[t][1] for _, t in props)
    vdata = np.frombuffer(body[: n_vert * stride], dtype=np.uint8).reshape(n_vert, stride)
    out = {}
    off = 0
    for name, t in props:
        dt, sz = fmt_map[t]
        out[name] = vdata[:, off:off + sz].copy().view(dt).reshape(n_vert)
        off += sz
    verts = np.stack([out["x"], out["y"], out["z"]], axis=-1)
    colors = None
    if "red" in out:
        colors = np.stack([out["red"], out["green"], out["blue"]], axis=-1)
    normals = None
    if "nx" in out:
        normals = np.stack([out["nx"], out["ny"], out["nz"]], axis=-1)
    faces = None
    if n_face:
        fbody = body[n_vert * stride:]
        fdata = np.frombuffer(fbody[: n_face * 13], dtype=np.uint8).reshape(n_face, 13)
        faces = fdata[:, 1:].copy().view("<i4").reshape(n_face, 3)
    return verts, faces, colors, normals

