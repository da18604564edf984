"""Incremental marching cubes over TSDF chunks, on torch tensors.

Port of texturefusion_tpu/ops/marching_cubes.py (ref:
Structure/ChunkManager.cpp:595-1004 GenerateMeshEfficient). Each chunk
reads a 9³ SDF/weight/colour block from itself and its 7 positive-corner
neighbours (ref: ChunkManager.cpp:608-633), emits one vertex per sign-
crossing grid edge it owns (3·9³ edge slots, the reference's per-edge
dedup arrays :645-647) and triangles as chunk-local vertex ids; normals
are SDF gradients (:277-455).

The JAX core is shaped for the TPU (row gathers with static remaps, a
one-hot reduction over the 12 cube edges, top_k compaction). Here the
gathers are direct and the compaction is an exclusive cumsum feeding a
scatter; the outputs are the same: per chunk, the first P valid edges in
ascending edge order and the first T valid triangles in emission order.

Three outputs: the device mesh pool (`mesh_chunks_pooled`, the
pipeline's), the padded per-chunk buffers (`mesh_chunks` → ChunkMesh,
compacted on the host by `compact_mesh` or on the device by
`compact_mesh_device`), and one flat compacted mesh over every chunk
(`mesh_chunks_compact` → CompactMesh, the multichip map cycle's). The
JAX package compacts the flat mesh with searchsorted gathers, because
scatters serialize on the TPU; here a cumsum feeds one index_put_, with
the same output.

Packed normals and colours are built in int64 and stored as int32 in the
pool: 3 × 8-bit channels never reach the sign bit, so the bits equal the
JAX pool's uint32. CompactMesh's vertex records hold the JAX uint32
words' bits in int32 too (positions as their float32 bits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from texturefusion_torch.ops import mc_tables
from texturefusion_torch.ops.tsdf import RESET_SDF

B = 9               # block side: chunk 8³ + 1 shared layer
B3 = B * B * B      # 729


def _block_luts(chunk_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each 9³ block voxel: (neighbour choice 0..7, linear index in
    that neighbour chunk). Neighbour bits: 1=+x, 2=+y, 4=+z."""
    s = chunk_size
    coords = np.stack(np.meshgrid(np.arange(B), np.arange(B), np.arange(B),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    nbr = (coords[:, 0] // s) + 2 * (coords[:, 1] // s) + 4 * (coords[:, 2] // s)
    local = coords % s
    lin = local[:, 0] + local[:, 1] * s + local[:, 2] * s * s  # x-fastest
    return nbr.astype(np.int64), lin.astype(np.int64)


def _grid_lin(coords: np.ndarray) -> np.ndarray:
    """9³ grid coords (..., 3) -> linear id (x*81 + y*9 + z)."""
    return (coords[..., 0] * B + coords[..., 1]) * B + coords[..., 2]


def _grad_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """SDF gradient along a block axis; one-sided at the block faces."""
    upper = torch.roll(f, -1, axis)
    lower = torch.roll(f, 1, axis)
    n = f.shape[axis]
    shape = [1, 1, 1, 1]
    shape[axis] = n
    idx = torch.arange(n, device=f.device).reshape(shape)
    return torch.where(idx == 0, upper - f,
                       torch.where(idx == n - 1, f - lower, (upper - lower) * 0.5))


def _mesh_vertices(sdf, weight, color, color_count, nbr_slots, origins,
                   chunk_size: int, resolution: float):
    """The 9³ blocks of U chunks and their edge vertices. nbr_slots [U, 8]
    (self + 7 corner neighbours, trash slot where absent), origins [U, 3].

    Returns (s_blk [U, 729], observed [U, 729], positions [U,E,3],
    normals [U,E,3], colors [U,E,3] in 0..1, crossing [U,E] bool)."""
    dev = sdf.device
    V = sdf.shape[1]

    # ---- 9³ blocks: one direct gather per field
    nbr_lut, lin_lut = _block_luts(chunk_size)
    flat = (nbr_slots[:, torch.as_tensor(nbr_lut, device=dev)] * V
            + torch.as_tensor(lin_lut, device=dev))              # [U, 729]
    s_blk = sdf.reshape(-1)[flat]
    w_blk = weight.reshape(-1)[flat]
    cnt = torch.clamp(color_count.reshape(-1)[flat], min=1e-6)
    c_blk = color.reshape(-1, 3)[flat] / cnt[..., None] / 255.0

    s3 = s_blk.reshape(-1, B, B, B)
    ob = ((w_blk > 0) & (torch.abs(s_blk) < RESET_SDF * 0.5))     # [U, 729]
    g3 = torch.stack([_grad_axis(s3, 1), _grad_axis(s3, 2), _grad_axis(s3, 3)],
                     dim=-1).reshape(-1, B3, 3)

    # ---- per-edge vertices (ownership: axis × 9³ origin)
    coords = np.stack(np.meshgrid(np.arange(B), np.arange(B), np.arange(B),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    grid_pos = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    pos_l, nrm_l, col_l, val_l = [], [], [], []
    for axis in range(3):
        step = np.zeros(3, np.int64)
        step[axis] = 1
        nb_coords = coords + step
        in_range = torch.as_tensor((nb_coords < B).all(axis=-1), device=dev)
        nb_lin = torch.as_tensor(_grid_lin(np.clip(nb_coords, 0, B - 1)), device=dev)
        s0, s1 = s_blk, s_blk[:, nb_lin]
        val_l.append((s0 * s1 < 0) & ob & ob[:, nb_lin] & in_range[None, :])
        t = torch.clamp(s0 / torch.where(torch.abs(s0 - s1) > 1e-12, s0 - s1, 1e-12),
                        0.0, 1.0)
        pos_l.append(grid_pos[None] + t[..., None]
                     * torch.as_tensor(step, dtype=torch.float32, device=dev))
        col_l.append(c_blk + (c_blk[:, nb_lin] - c_blk) * t[..., None])
        n = g3 + (g3[:, nb_lin] - g3) * t[..., None]
        nrm_l.append(n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                                     min=1e-12))

    positions = (torch.cat(pos_l, dim=1) * resolution + origins[:, None, :]
                 + 0.5 * resolution)
    normals = torch.cat(nrm_l, dim=1)
    colors = torch.clamp(torch.cat(col_l, dim=1), 0.0, 1.0)
    return s_blk, ob, positions, normals, colors, torch.cat(val_l, dim=1)


def _triangle_edges(s_blk: torch.Tensor, ob: torch.Tensor, chunk_size: int):
    """Per chunk, the marching-cubes triangles as block edge ids: (emitted
    [U, 512·MT·3] bool, edge id [U, 512·MT·3], 0 where not emitted)."""
    dev = s_blk.device
    U, s = s_blk.shape[0], chunk_size
    vox = np.stack(np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    corner_lin = torch.as_tensor(_grid_lin(vox[:, None, :] + mc_tables.CORNER_OFFSETS[None]),
                                 device=dev)                     # [512, 8]
    cs = s_blk[:, corner_lin]                                    # [U, 512, 8]
    cell_ok = torch.all(ob[:, corner_lin], dim=-1)
    weights8 = 1 << torch.arange(8, device=dev)
    case = torch.sum((cs < 0).to(torch.int64) * weights8, dim=-1)
    case = torch.where(cell_ok, case, 0)
    local_e = torch.as_tensor(mc_tables.TRI_TABLE, dtype=torch.int64,
                              device=dev)[case]                  # [U, 512, MT*3]
    e_glob = torch.as_tensor(_grid_lin(vox[:, None, :] + mc_tables.EDGE_ORIGIN[None])
                             + mc_tables.EDGE_AXIS[None, :] * B3, device=dev)  # [512, 12]
    gid = torch.gather(e_glob[None].expand(U, -1, -1), 2,
                       torch.clamp(local_e, min=0)).reshape(U, -1)
    return (local_e >= 0).reshape(U, -1), gid


def _mesh_core(sdf, weight, color, color_count, nbr_slots, origins, active,
               chunk_size: int, resolution: float):
    """Marching cubes over U chunks. nbr_slots [U, 8] (self + 7 corner
    neighbours, trash slot where absent), origins [U, 3], active [U].

    Returns (positions [U,E,3], npack [U,E] i64, cpack [U,E] i64,
    val [U,E] bool, vali [U,E] i64, vidx [U,E] i64 exclusive prefix,
    tl [U,T,3] i64 chunk-local vertex ids, tvalid [U,T] bool)."""
    U = nbr_slots.shape[0]
    s_blk, ob, positions, normals, colors, crossing = _mesh_vertices(
        sdf, weight, color, color_count, nbr_slots, origins, chunk_size, resolution)
    val = crossing & active[:, None]                             # [U, 3·729]

    vali = val.to(torch.int64)
    vidx = torch.cumsum(vali, dim=1) - vali

    n8 = (torch.clamp(torch.round(normals * 127.0), -127, 127) + 127.0).to(torch.int64)
    npack = n8[..., 0] + (n8[..., 1] << 8) + (n8[..., 2] << 16)
    c8 = torch.clamp(torch.round(colors * 255.0), 0, 255).to(torch.int64)
    cpack = c8[..., 0] + (c8[..., 1] << 8) + (c8[..., 2] << 16)

    # ---- triangles: case index → local edges → chunk-local vertex ids
    emitted, gid = _triangle_edges(s_blk, ob, chunk_size)
    tl = torch.where(emitted, torch.gather(vidx, 1, gid), 0).reshape(U, -1, 3)
    cv = torch.gather(val, 1, gid).reshape(U, -1, 3)
    tvalid = (torch.all(emitted.reshape(U, -1, 3), dim=-1) & torch.all(cv, dim=-1)
              & active[:, None])
    return positions, npack, cpack, val, vali, vidx, tl, tvalid


class ChunkMesh(NamedTuple):
    """Padded per-chunk mesh buffers (batch dimension U leading)."""

    positions: torch.Tensor   # [U, 3·729, 3] world-space edge vertices
    normals: torch.Tensor     # [U, 3·729, 3]
    colors: torch.Tensor      # [U, 3·729, 3] in [0, 1]
    vert_valid: torch.Tensor  # [U, 3·729] bool
    triangles: torch.Tensor   # [U, 8³·MAX_TRIS, 3] int64 block edge ids, -1 padded


def mesh_chunks(sdf, weight, color, color_count, slots: torch.Tensor,
                nbr_slots: torch.Tensor, origins: torch.Tensor, chunk_size: int,
                resolution: float) -> ChunkMesh:
    """Marching cubes over the chunks `slots` [U] into padded per-chunk
    buffers: every owned grid edge's vertex, valid where the SDF crosses
    zero between two observed nodes, and triangles of edge ids."""
    del slots  # the chunks are named by nbr_slots[:, 0], as in the JAX package
    U = nbr_slots.shape[0]
    s_blk, ob, positions, normals, colors, crossing = _mesh_vertices(
        sdf, weight, color, color_count, nbr_slots, origins, chunk_size, resolution)
    emitted, gid = _triangle_edges(s_blk, ob, chunk_size)
    return ChunkMesh(positions, normals, colors, crossing,
                     torch.where(emitted, gid, -1).reshape(U, -1, 3))


class CompactMesh(NamedTuple):
    """A flat mesh holding only real geometry, over all U chunks: vertex
    records of 5 words (position xyz as float32 bits; the normal as
    3×(int8+127); the colour as 3×uint8), chunk u's at rows [voff[u],
    voff[u] + vcount[u]), and triangles as CHUNK-LOCAL vertex ids."""

    vert_rec: torch.Tensor    # [vert_cap, 5] int32 (the JAX uint32 words' bits)
    triangles: torch.Tensor   # [tri_cap, 3] int32
    vcount: torch.Tensor      # [U] int32 vertices per chunk
    tcount: torch.Tensor      # [U] int32 triangles per chunk


def _records(positions: torch.Tensor, npack: torch.Tensor, cpack: torch.Tensor) -> torch.Tensor:
    """[U, E, 5] int32 vertex records."""
    return torch.cat([positions.contiguous().view(torch.int32),
                      npack[..., None].to(torch.int32), cpack[..., None].to(torch.int32)],
                     dim=-1)


def _compact_flat(valid: torch.Tensor, payload: torch.Tensor, cap: int) -> torch.Tensor:
    """The first `cap` payload rows whose `valid` is set, in flat row-major
    order, zero-filled: valid [U, E], payload [U, E, C] -> [cap, C]."""
    v = valid.reshape(-1)
    dest = torch.cumsum(v.to(torch.int64), dim=0) - 1
    keep = v & (dest < cap)
    out = torch.zeros((cap, payload.shape[-1]), dtype=payload.dtype, device=payload.device)
    out[dest[keep]] = payload.reshape(-1, payload.shape[-1])[keep]
    return out


def compact_mesh_device(mesh: ChunkMesh, active: torch.Tensor, vert_cap: int,
                        tri_cap: int) -> CompactMesh:
    """On-device compaction of padded per-chunk buffers into a CompactMesh
    (vertices of inactive chunks and triangles touching an invalid vertex
    are dropped)."""
    U = mesh.vert_valid.shape[0]
    val = mesh.vert_valid & active[:, None]
    vali = val.to(torch.int64)
    vidx = torch.cumsum(vali, dim=1) - vali
    n8 = (torch.clamp(torch.round(mesh.normals * 127.0), -127, 127) + 127.0).to(torch.int64)
    c8 = torch.clamp(torch.round(mesh.colors * 255.0), 0, 255).to(torch.int64)
    rec = _records(mesh.positions, n8[..., 0] + (n8[..., 1] << 8) + (n8[..., 2] << 16),
                   c8[..., 0] + (c8[..., 1] << 8) + (c8[..., 2] << 16))
    t = mesh.triangles
    safe = torch.clamp(t, min=0).reshape(U, -1)
    cv = torch.gather(val, 1, safe).reshape(t.shape)
    tvalid = torch.all(t >= 0, dim=-1) & torch.all(cv, dim=-1) & active[:, None]
    tl = torch.gather(vidx, 1, safe).reshape(t.shape)
    return CompactMesh(_compact_flat(val, rec, vert_cap),
                       _compact_flat(tvalid, tl.to(torch.int32), tri_cap),
                       vali.sum(dim=1).to(torch.int32), tvalid.sum(dim=1).to(torch.int32))


def mesh_chunks_compact(sdf, weight, color, color_count, nbr_slots: torch.Tensor,
                        origins: torch.Tensor, active: torch.Tensor, chunk_size: int,
                        resolution: float, vert_cap: int, tri_cap: int) -> CompactMesh:
    """Marching cubes and the global compaction in one call: one flat mesh
    over all U chunks (the multichip map cycle's meshing)."""
    positions, npack, cpack, val, vali, _, tl, tvalid = _mesh_core(
        sdf, weight, color, color_count, nbr_slots, origins, active, chunk_size, resolution)
    return CompactMesh(_compact_flat(val, _records(positions, npack, cpack), vert_cap),
                       _compact_flat(tvalid, tl.to(torch.int32), tri_cap),
                       vali.sum(dim=1).to(torch.int32),
                       tvalid.to(torch.int64).sum(dim=1).to(torch.int32))


@dataclasses.dataclass
class MeshPool:
    """Device-resident per-chunk mesh pool (slot-indexed, +1 trash row)."""

    verts: torch.Tensor       # [S+1, P, 3] f32 world-space
    col_packed: torch.Tensor  # [S+1, P] int32: 3×u8 channels
    nrm_packed: torch.Tensor  # [S+1, P] int32: 3×(int8+127) channels
    tris: torch.Tensor        # [S+1, T, 3] int32 chunk-local vertex ids
    vcount: torch.Tensor      # [S+1] int32
    tcount: torch.Tensor      # [S+1] int32

    def __iter__(self):
        return iter((self.verts, self.col_packed, self.nrm_packed, self.tris,
                     self.vcount, self.tcount))


# MeshPool's fields in order: the fields of the mesher's pool container
POOL_VERTS, POOL_COLORS, POOL_VCOUNT, POOL_TCOUNT = 0, 1, 4, 5


class PoolReader(NamedTuple):
    """What the texture cycle reads of a mesh pool, on the cycle's
    device: the per-slot vertex and triangle counts [S+1] in slot order,
    and `rows(slots)`, the verts [M, P, 3] and packed colours [M, P] of a
    slot tensor."""

    vcount: torch.Tensor
    tcount: torch.Tensor
    rows: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_mesh_pool(capacity: int, p: int, t: int, device) -> MeshPool:
    i32 = dict(dtype=torch.int32, device=device)
    return MeshPool(
        verts=torch.zeros((capacity + 1, p, 3), dtype=torch.float32, device=device),
        col_packed=torch.zeros((capacity + 1, p), **i32),
        nrm_packed=torch.zeros((capacity + 1, p), **i32),
        tris=torch.zeros((capacity + 1, t, 3), **i32),
        vcount=torch.zeros(capacity + 1, **i32),
        tcount=torch.zeros(capacity + 1, **i32),
    )


def _compact_rows(valid: torch.Tensor, cap: int, *payloads: torch.Tensor):
    """Per row, the first `cap` valid entries of each payload [U, E, ...]
    in ascending order, zero-filled: an exclusive cumsum gives each valid
    entry its output column; the rest go to a spare column, dropped."""
    vi = valid.to(torch.int64)
    dest = torch.cumsum(vi, dim=1) - vi
    dest = torch.where(valid & (dest < cap), dest, cap)
    outs = []
    for p in payloads:
        out = torch.zeros((p.shape[0], cap + 1) + p.shape[2:], dtype=p.dtype,
                          device=p.device)
        idx = dest.reshape(dest.shape + (1,) * (p.dim() - 2)).expand(p.shape)
        outs.append(out.scatter_(1, idx, p)[:, :cap])
    return outs


def mesh_chunks_pooled(pool: MeshPool, sdf, weight, color, color_count,
                       slots: torch.Tensor, nbr_slots: torch.Tensor,
                       origins: torch.Tensor, active: torch.Tensor,
                       chunk_size: int, resolution: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marching cubes over the chunks `slots` [U] with per-chunk
    compaction written into the pool rows IN PLACE. Returns (vcount [U],
    tcount [U]), clamped to the pool's per-chunk capacities; inactive
    lanes write the trash row."""
    p_cap = pool.verts.shape[1]
    t_cap = pool.tris.shape[1]
    positions, npk, cpk, val, vali, _, tl, tvalid = _mesh_core(
        sdf, weight, color, color_count, nbr_slots, origins, active,
        chunk_size, resolution)
    vcount = torch.clamp(torch.sum(vali, dim=1), max=p_cap)
    pv, pn, pc = _compact_rows(val, p_cap, positions, npk, cpk)

    # triangles touching a vertex beyond the pool cap are dropped
    tvalid = tvalid & torch.all(tl < p_cap, dim=-1)
    tcount = torch.clamp(torch.sum(tvalid.to(torch.int64), dim=1), max=t_cap)
    (pt,) = _compact_rows(tvalid, t_cap, tl)

    sl = torch.where(active, slots, pool.verts.shape[0] - 1)
    pool.verts[sl] = pv
    pool.col_packed[sl] = pc.to(torch.int32)
    pool.nrm_packed[sl] = pn.to(torch.int32)
    pool.tris[sl] = pt.to(torch.int32)
    pool.vcount[sl] = torch.where(active, vcount, 0).to(torch.int32)
    pool.tcount[sl] = torch.where(active, tcount, 0).to(torch.int32)
    return vcount, tcount


def gather_pool_rows(pool: MeshPool, slots: torch.Tensor):
    """Copies of the selected pool rows (export path)."""
    return tuple(a[slots] for a in pool)


def unpack_u32_channels(packed: np.ndarray) -> np.ndarray:
    """[...] packed 3×8-bit channels → [..., 3] float 0..255."""
    packed = np.asarray(packed).astype(np.uint32)
    return np.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                     (packed >> 16) & 0xFF], axis=-1).astype(np.float32)


def unpack_vert_records(rec: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[N, 5] vertex records (the uint32 words' bits) → (positions f32
    [N, 3], colors [N, 3] in 0..1, normals [N, 3])."""
    rec = np.asarray(rec).astype(np.uint32)
    pos = rec[:, :3].copy().view(np.float32)
    nrm = (unpack_u32_channels(rec[:, 3]) - 127.0) / 127.0
    col = unpack_u32_channels(rec[:, 4]) / 255.0
    return pos, col, nrm


def compact_mesh(mesh: ChunkMesh, active: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side compaction of padded chunk meshes into flat arrays: each
    chunk keeps the vertices its valid triangles use (ref:
    Chisel.cpp:288-355 DrawMeshes' buffer fill). Returns (vertices [N, 3],
    faces [M, 3] int32, colors [N, 3], normals [N, 3])."""
    pos, nrm, col, val, tris = (t.cpu().numpy() for t in
                                (mesh.positions, mesh.normals, mesh.colors,
                                 mesh.vert_valid, mesh.triangles))
    verts_out, faces_out, cols_out, nrms_out = [], [], [], []
    base = 0
    for u in range(pos.shape[0]):
        if not active[u]:
            continue
        t = tris[u]
        t = t[(t >= 0).all(axis=-1)]
        t = t[val[u][t].all(axis=-1)]     # all three edge vertices valid
        if len(t) == 0:
            continue
        used = np.zeros(val.shape[1], bool)
        used[t.reshape(-1)] = True
        remap = np.full(val.shape[1], -1, np.int64)
        remap[used] = np.arange(used.sum()) + base
        verts_out.append(pos[u][used])
        cols_out.append(col[u][used])
        nrms_out.append(nrm[u][used])
        faces_out.append(remap[t])
        base += used.sum()
    if not verts_out:
        z = np.zeros((0, 3), np.float32)
        return z, np.zeros((0, 3), np.int32), z, z
    return (np.concatenate(verts_out).astype(np.float32),
            np.concatenate(faces_out).astype(np.int32),
            np.concatenate(cols_out).astype(np.float32),
            np.concatenate(nrms_out).astype(np.float32))
