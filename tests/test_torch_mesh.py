"""Parity of the port's marching cubes with the JAX package.

Both packages mesh one volume: an analytic sphere sampled into 5 cm
chunks with random weights and colours, built in numpy, handed to JAX as
arrays and to the port through utils/convert.py. The JAX mesh pool is
carried across the same way. Vertex and triangle counts and triangle ids
are exact, positions agree within 1e-5; packed 8-bit normal and colour
channels within one step (they round float values that differ by ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texturefusion_tpu.config import MeshConfig, tiny_test_config
from texturefusion_tpu.ops import marching_cubes as jmc
from texturefusion_tpu.ops import mc_tables as jtab
from texturefusion_torch.fusion.mesher import IncrementalMesher
from texturefusion_torch.ops import marching_cubes as tmc
from texturefusion_torch.ops import mc_tables as ttab
from texturefusion_torch.utils import convert

torch.set_num_threads(2)

CAP = 96


def test_mc_tables_equal_jax():
    names = [n for n in dir(jtab) if n.isupper()]
    assert {"TRI_TABLE", "CORNER_OFFSETS", "EDGE_AXIS", "EDGE_ORIGIN"} <= set(names)
    for n in names:
        np.testing.assert_array_equal(getattr(ttab, n), getattr(jtab, n), err_msg=n)


def _sphere_volume_arrays(seed=0):
    """JAX-TSDFVolume-shaped numpy state: rows [CAP+1, 512], origins,
    ids [CAP, 3], used [CAP] for a 0.5 m sphere in 4³ chunks of 0.4 m."""
    cfg = tiny_test_config().tsdf
    s, res = cfg.chunk_size, cfg.voxel_resolution
    ext = s * res
    rng = np.random.default_rng(seed)
    ids = np.asarray([(x, y, z) for x in range(-2, 2) for y in range(-2, 2)
                      for z in range(-2, 2)], np.int32)
    order = rng.permutation(len(ids))                # slots not in id order
    slot_ids = np.zeros((CAP, 3), np.int32)
    used = np.zeros(CAP, bool)
    slot_ids[order] = ids
    used[order] = True
    lin = np.arange(s ** 3)
    vox = np.stack([lin % s, (lin // s) % s, lin // (s * s)], -1)
    centers = slot_ids[:, None, :] * ext + (vox[None] + 0.5) * res    # [CAP, 512, 3]
    dist = np.linalg.norm(centers - np.asarray([0.1, 0.05, 0.2]), axis=-1) - 0.5
    near = (np.abs(dist) < 0.15) & used[:, None]
    sdf = np.full((CAP + 1, s ** 3), 999.0, np.float32)
    weight = np.zeros((CAP + 1, s ** 3), np.float32)
    sdf[:CAP][near] = dist[near]
    weight[:CAP][near] = rng.integers(1, 4, near.sum())
    color = np.zeros((CAP + 1, s ** 3, 3), np.float32)
    color[:CAP][near] = rng.random((near.sum(), 3)) * 90
    count = weight.copy()
    origins = np.zeros((CAP + 1, 3), np.float32)
    origins[:CAP] = slot_ids * ext
    return sdf, weight, color, count, origins, slot_ids, used


@pytest.mark.parametrize("p_cap,t_cap", [(256, 384), (40, 48)])
def test_mesh_chunks_pooled_matches_jax(p_cap, t_cap):
    config = tiny_test_config().replace(
        tsdf=tiny_test_config().tsdf.__class__(voxel_resolution=0.05, capacity=CAP),
        mesh=MeshConfig(pool_verts_per_chunk=p_cap, pool_tris_per_chunk=t_cap))
    arrs = _sphere_volume_arrays()
    vol = convert.volume_state_from_numpy(config, *arrs)
    assert vol.n_active() == 64
    mesher = IncrementalMesher(vol)
    slots = np.sort(np.nonzero(arrs[6])[0])[::2]     # half the chunks
    nbr = mesher._neighbor_slots(slots)
    origins = vol.ids[slots].astype(np.float32) * vol.extent
    u = len(slots) + 3                               # three padding lanes
    slots_p = np.concatenate([slots, np.full(3, CAP)])
    nbr_p = np.concatenate([nbr, np.full((3, 8), CAP)])
    origins_p = np.concatenate([origins, np.zeros((3, 3), np.float32)])
    active = np.arange(u) < len(slots)

    jpool, jv, jt = jmc.mesh_chunks_pooled(
        jmc.make_mesh_pool(CAP, p_cap, t_cap), *(jnp.asarray(a) for a in arrs[:4]),
        jnp.asarray(slots_p), jnp.asarray(nbr_p), jnp.asarray(origins_p),
        jnp.asarray(active), 8, 0.05)
    tv, tt = tmc.mesh_chunks_pooled(
        mesher.pool, *vol.batch, torch.as_tensor(slots_p), torch.as_tensor(nbr_p),
        torch.as_tensor(origins_p), torch.as_tensor(active), 8, 0.05)
    np.testing.assert_array_equal(tv.numpy()[:len(slots)], np.asarray(jv)[:len(slots)])
    np.testing.assert_array_equal(tt.numpy()[:len(slots)], np.asarray(jt)[:len(slots)])
    assert tv.numpy().sum() > 0

    ref = convert.mesh_pool_from_numpy(*(np.asarray(a) for a in jpool))
    got = mesher.pool
    rows = slice(0, CAP)
    for name in ("vcount", "tcount", "tris"):
        np.testing.assert_array_equal(getattr(got, name)[rows].numpy(),
                                      getattr(ref, name)[rows].numpy(), err_msg=name)
    np.testing.assert_allclose(got.verts[rows].numpy(), ref.verts[rows].numpy(),
                               atol=1e-5, rtol=0)
    for name in ("col_packed", "nrm_packed"):
        a = tmc.unpack_u32_channels(getattr(got, name)[rows].numpy())
        b = tmc.unpack_u32_channels(getattr(ref, name)[rows].numpy())
        assert np.abs(a - b).max() <= 1.0, name
        assert (a != b).mean() < 1e-3, name
    if p_cap < 256:
        assert (tv.numpy() == p_cap).any()            # some chunks clamped


def test_gather_and_unpack_roundtrip():
    pool = tmc.make_mesh_pool(4, 8, 8)
    pool.col_packed[1, :3] = torch.tensor([0x010203, 0xFFFFFF, 0x7F0080],
                                          dtype=torch.int32)
    rows = tmc.gather_pool_rows(pool, torch.tensor([1]))
    ch = tmc.unpack_u32_channels(rows[1][0, :3].numpy())
    np.testing.assert_array_equal(ch, [[3, 2, 1], [255, 255, 255], [128, 0, 127]])
    np.testing.assert_array_equal(ch, jmc.unpack_u32_channels(
        np.asarray([0x010203, 0xFFFFFF, 0x7F0080], np.uint32)))


def test_release_and_drop_forget_chunks():
    """release() frees slots and resets their rows; drop() removes their
    meshes from the export; the freed slots are handed out again."""
    config = tiny_test_config().replace(
        tsdf=tiny_test_config().tsdf.__class__(voxel_resolution=0.05, capacity=CAP))
    arrs = _sphere_volume_arrays(1)
    vol = convert.volume_state_from_numpy(config, *arrs)
    np.testing.assert_array_equal(vol.lookup(arrs[5][arrs[6]]), np.nonzero(arrs[6])[0])
    mesher = IncrementalMesher(vol)
    vol.dirty_mesh.update(vol.active_slots().tolist())
    assert mesher.update_meshes() == 64
    meshed = sorted(mesher.meshes)
    gone = np.asarray(meshed[:5], np.int64)
    ids_gone = vol.ids[gone].copy()
    n_verts = len(mesher.full_mesh()[0])

    vol.release(gone)
    mesher.drop(gone)
    assert vol.n_active() == 59
    assert (vol.lookup(ids_gone) == -1).all()
    assert (vol.batch.sdf[gone] == 999.0).all() and (vol.batch.weight[gone] == 0).all()
    assert not set(gone.tolist()) & set(mesher.meshes)
    assert len(mesher.full_mesh()[0]) < n_verts
    again = vol.allocate(ids_gone)
    assert sorted(again.tolist()) == sorted(gone.tolist())
    np.testing.assert_allclose(vol.origins[again].numpy(), ids_gone * vol.extent)
