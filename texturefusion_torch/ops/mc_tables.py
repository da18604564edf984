"""Marching-cubes case tables, generated constructively at import time.

Equivalent role to open_chisel's vendored triangle table
(ref: 3rd_party/open_chisel/marching_cubes/MarchingCubes.h:37 triangleTable,
MeshCube :43-121) but derived from first principles rather than copied:

For each of the 256 corner-sign configurations we
  1. find the cube edges with a sign crossing,
  2. pair crossings on each face (2 crossings: join; 4 crossings —
     the ambiguous case — pair so each segment cuts off an *inside*
     corner, a rule that depends only on the face's signs and is therefore
     identical from both sides of a shared face ⇒ watertight meshes),
  3. walk edge→face→edge to close polygon loops,
  4. fan-triangulate each loop,
  5. orient every triangle so its normal points along the gradient of the
     trilinear interpolant (from inside/negative toward outside/positive).

Conventions:
  corner i  ↔ offset ((i>>0)&1, (i>>1)&1, (i>>2)&1)      (x fastest)
  "inside"  ↔ sdf < 0  (bit set in the case index)
  edge e    ↔ (corner_a, corner_b) in EDGE_CORNERS, a < b
"""

from __future__ import annotations

import numpy as np

CORNER_OFFSETS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int32
)

# 12 edges as corner index pairs (a < b), grouped by axis for ownership:
# edge along x from corner c (x-bit 0), etc.
EDGE_CORNERS = []
for a, bit in ((0, 1), (1, 2), (2, 4)):
    for c in range(8):
        if not (c & bit):
            EDGE_CORNERS.append((c, c | bit))
EDGE_CORNERS = np.array(EDGE_CORNERS, np.int32)  # [12, 2]; 0-3 x, 4-7 y, 8-11 z

# Edge ownership for cross-voxel dedup: edge k of the cube at grid pos p is
# the same vertex as ("axis", p + origin_offset). origin = corner_a offset.
EDGE_AXIS = np.array([0] * 4 + [1] * 4 + [2] * 4, np.int32)
EDGE_ORIGIN = CORNER_OFFSETS[EDGE_CORNERS[:, 0]]  # [12, 3]

# The six faces: (corner indices in perimeter order)
_FACES = [
    (0, 1, 3, 2),  # z = 0
    (4, 5, 7, 6),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (2, 3, 7, 6),  # y = 1
    (0, 2, 6, 4),  # x = 0
    (1, 3, 7, 5),  # x = 1
]


def _edge_index(a: int, b: int) -> int:
    a, b = min(a, b), max(a, b)
    for i, (x, y) in enumerate(EDGE_CORNERS.tolist()):
        if (x, y) == (a, b):
            return i
    raise KeyError((a, b))


def _face_pairs(case: int, face) -> list:
    """Pair the crossing edges on one face. Returns [(e1, e2), ...]."""
    cs = list(face)
    inside = [(case >> c) & 1 for c in cs]
    # perimeter edges of the face as corner pairs
    per = [(cs[i], cs[(i + 1) % 4]) for i in range(4)]
    crossings = [i for i, (a, b) in enumerate(per)
                 if ((case >> a) & 1) != ((case >> b) & 1)]
    if not crossings:
        return []
    if len(crossings) == 2:
        e = [_edge_index(*per[i]) for i in crossings]
        return [(e[0], e[1])]
    # ambiguous: 4 crossings, alternating signs. Cut off each inside corner:
    # pair the two perimeter edges adjacent to every inside corner.
    pairs = []
    for i in range(4):
        if inside[i]:
            prev_edge = per[(i - 1) % 4]
            next_edge = per[i]
            pairs.append((_edge_index(*prev_edge), _edge_index(*next_edge)))
    assert len(pairs) == 2
    return pairs


def _loops_for_case(case: int) -> list:
    """Closed crossing-edge loops for a corner-sign case."""
    # adjacency: for each crossing edge, its partners (one per adjacent face)
    partners = {}
    for f in _FACES:
        for e1, e2 in _face_pairs(case, f):
            partners.setdefault(e1, []).append(e2)
            partners.setdefault(e2, []).append(e1)
    for e, ps in partners.items():
        assert len(ps) == 2, (case, e, ps)
    loops = []
    visited = set()
    for start in sorted(partners):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [p for p in partners[cur] if p != prev]
            # both partners equal prev can't happen (two distinct faces)
            n = nxt[0]
            if n == start:
                break
            loop.append(n)
            visited.add(n)
            prev, cur = cur, n
        assert len(loop) >= 3, (case, loop)
        loops.append(loop)
    return loops


def _triangulate(case: int) -> list:
    """Triangles (edge-index triples) for a case, consistently oriented."""
    # canonical geometry: corner values -1 inside, +1 outside; vertices at
    # edge midpoints of the unit cube
    vals = np.array([-1.0 if (case >> c) & 1 else 1.0 for c in range(8)])
    mids = 0.5 * (CORNER_OFFSETS[EDGE_CORNERS[:, 0]]
                  + CORNER_OFFSETS[EDGE_CORNERS[:, 1]]).astype(np.float64)

    def tri_grad(p):
        """Gradient of the trilinear interpolant at point p."""
        x, y, z = p
        g = np.zeros(3)
        for c in range(8):
            ox, oy, oz = CORNER_OFFSETS[c]
            wx, wy, wz = (x if ox else 1 - x), (y if oy else 1 - y), (z if oz else 1 - z)
            sx = 1.0 if ox else -1.0
            sy = 1.0 if oy else -1.0
            sz = 1.0 if oz else -1.0
            g += vals[c] * np.array([sx * wy * wz, sy * wx * wz, sz * wx * wy])
        return g

    tris = []
    for loop in _loops_for_case(case):
        for i in range(1, len(loop) - 1):
            t = (loop[0], loop[i], loop[i + 1])
            p = (mids[t[0]] + mids[t[1]] + mids[t[2]]) / 3.0
            n = np.cross(mids[t[1]] - mids[t[0]], mids[t[2]] - mids[t[0]])
            if np.dot(n, tri_grad(p)) < 0:
                t = (t[0], t[2], t[1])
            tris.append(t)
    return tris


def _build_tables():
    all_tris = [_triangulate(case) for case in range(256)]
    max_tris = max(len(t) for t in all_tris)
    table = np.full((256, max_tris * 3), -1, np.int32)
    counts = np.zeros(256, np.int32)
    for case, tris in enumerate(all_tris):
        counts[case] = len(tris)
        flat = [e for t in tris for e in t]
        table[case, : len(flat)] = flat
    return table, counts, max_tris


TRI_TABLE, TRI_COUNTS, MAX_TRIS = _build_tables()
