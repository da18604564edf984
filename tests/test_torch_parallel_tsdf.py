"""The chunk-sharded TSDF volume and mesh pool, port against the unsharded
port and against JAX.

The sharded port runs on an 8-shard CPU DeviceMesh, slot s on shard
s % 8. Against the unsharded port the map must be EXACTLY the same
(every row's update is independent, and the halo staging reads the same
rows): slots, rows, observations, dirty sets, trajectory, meshes. Both
runs shard BA's edges over the same eight shards (parallel.n_devices =
8), so their BA sums run in one order. Against JAX:
`sharded_integrate_step` at test_parallel.py's tolerances (weight atol
1e-6, sdf atol 1e-4); the sharded pipeline at test_torch_pipeline.py's
port-vs-JAX tolerances (positions within 1 mm, the same chunk ids, the
weight sum within 1e-3, vertex counts within 1%) on
test_real_pipeline_sharded_matches_single_device's assertions; the
meshing functions exactly on vertex validity, counts and triangles and
within 1e-5 on positions and normals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import (CFG, JI, N_FRAMES, SCENE, SYNC, _jax, _pallas_bilateral,
                                 _port)
from texturefusion_tpu.config import tiny_test_config as jtiny
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import marching_cubes as jmc
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.parallel import mesh as jmesh
from texturefusion_tpu.parallel import sharded_tsdf as jsharded
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline as TPipeline
from texturefusion_torch.ops import marching_cubes as mc
from texturefusion_torch.ops import raycast
from texturefusion_torch.parallel import mesh as pmesh
from texturefusion_torch.parallel import sharded_tsdf
from texturefusion_torch.utils import checkpoint

torch.set_num_threads(2)

SHARDED = CFG.replace(parallel=dataclasses.replace(SYNC, tsdf_sharded=True, n_devices=8))
UNSHARDED = CFG.replace(parallel=dataclasses.replace(SYNC, n_devices=8))


@pytest.fixture(scope="module")
def seq():
    poses = jsyn.orbit_trajectory(N_FRAMES)
    depths, rgbs = jsyn.render_sequence(SCENE, JI, poses)
    return poses, depths, rgbs


@pytest.fixture(scope="module")
def pair(seq):
    _, depths, rgbs = seq
    return _port(SHARDED, depths, rgbs), _port(UNSHARDED, depths, rgbs)


def _rows(vol, n):
    batch, origins = vol.dense_batch()
    return [a[:n].numpy() for a in batch] + [origins[:n].numpy()]


def test_sharded_pipeline_equals_unsharded_port(pair):
    shd, ref = pair
    vol, rv = shd.volume, ref.volume
    assert vol.sharded and vol.mesh.size == 8 and not rv.sharded
    assert (vol.cfg.capacity + 1) % 8 == 0 and shd.slam.mesh.size == 8
    cap = rv.cfg.capacity
    assert vol.n_active() == rv.n_active() > 10
    np.testing.assert_array_equal(vol.used[:cap], rv.used)
    assert not vol.used[cap:].any()
    np.testing.assert_array_equal(vol.ids[:cap], rv.ids)
    for a, b in zip(_rows(vol, cap), _rows(rv, cap)):
        np.testing.assert_array_equal(a, b)
    extra = _rows(vol, vol.cfg.capacity + 1)
    assert (extra[0][cap:] == 999.0).all() and not extra[1][cap:].any()
    np.testing.assert_array_equal(shd.trajectory(), ref.trajectory())
    assert shd.stats == ref.stats
    assert vol.dirty_mesh == rv.dirty_mesh and vol.new_since_gc == rv.new_since_gc
    assert vol.observations == rv.observations and vol.observations
    assert shd.mesher.last_remeshed == ref.mesher.last_remeshed
    np.testing.assert_array_equal(shd.mesher.vcount[:cap], ref.mesher.vcount[:cap])
    np.testing.assert_array_equal(shd.mesher.tcount[:cap], ref.mesher.tcount[:cap])
    for a, b in zip(shd.mesher.full_mesh(), ref.mesher.full_mesh()):
        np.testing.assert_array_equal(a, b)
    assert len(shd.mesher.full_mesh()[0]) > 500
    assert {(k, v) for k, v in shd.stats.items()} == {(k, v) for k, v in ref.stats.items()}
    # every shard integrated: each local-frame pass and keyframe pass split by owner
    assert all(c > 0 for c in vol.rows.per_shard("integrate_frame"))
    assert all(c > 0 for c in vol.rows.per_shard("integrate_depths"))
    assert all(c > 0 for c in shd.mesher.pool_rows.per_shard("remesh"))


def test_sharded_pipeline_matches_jax_sharded(seq, pair):
    """test_real_pipeline_sharded_matches_single_device's assertions, the
    JAX side sharded over its eight CPU devices."""
    poses, depths, rgbs = seq
    shd, _ = pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            jp = _jax(SHARDED, depths, rgbs)
        finally:
            jax.clear_caches()
    assert jp.volume.sharding is not None and shd.volume.sharded
    assert shd.volume.cfg.capacity == jp.volume.cfg.capacity
    assert (shd.volume.cfg.capacity + 1) % 8 == 0
    assert shd.volume.n_active() == jp.volume.n_active()
    assert {tuple(r) for r in shd.volume.ids[shd.volume.used].tolist()} == \
        {tuple(r) for r in jp.volume.ids[jp.volume.used].tolist()}
    w = float(shd.volume.dense_batch()[0].weight.sum())
    jw = float(jnp.sum(jp.volume.batch.weight))
    assert abs(w - jw) <= 1e-3 * jw
    dist = np.abs(shd.trajectory()[:, :3, 3] - jp.trajectory()[:, :3, 3]).max()
    assert dist <= 1e-3, dist
    nt, nj = len(shd.mesher.full_mesh()[0]), len(jp.mesher.full_mesh()[0])
    ft, fj = len(shd.mesher.full_mesh()[1]), len(jp.mesher.full_mesh()[1])
    assert abs(nt - nj) <= 0.01 * nj and abs(ft - fj) <= 0.01 * fj


def test_sharded_integrate_step_matches_jax():
    """tests/test_parallel.py::test_sharded_tsdf_integration_matches_dense,
    both packages: 64 slots over 8 shards, 32 chunks along the wall."""
    cfg = jtiny()
    intr = jcam.Intrinsics.from_config(cfg.camera)
    pose = jnp.asarray(jsyn.orbit_trajectory(1)[0])
    depth, rgb = jsyn.render_frame(jsyn.BoxRoomScene(), intr, pose)
    cap, n_vox = 64, cfg.tsdf.chunk_size ** 3
    ext = cfg.tsdf.chunk_size * cfg.tsdf.voxel_resolution
    origins = np.zeros((cap, 3), np.float32)
    active = np.zeros(cap, bool)
    for k, (x, y) in enumerate((x, y) for x in range(-4, 4) for y in range(-2, 2)):
        origins[k] = [x * ext, y * ext, 1.8]
        active[k] = True
    m = jmesh.make_mesh()
    jbatch, _ = jsharded.make_sharded_batch(cap, n_vox, m)
    quality = jnp.zeros_like(depth)
    jout, jq = jsharded.sharded_integrate_step(m, intr, cfg.tsdf)(
        jbatch, jax.device_put(jnp.asarray(origins), jmesh.shard_leading(m)),
        jax.device_put(jnp.asarray(active), jmesh.shard_leading(m)), depth, rgb, quality, pose,
        jnp.float32(1.0))

    mesh = pmesh.make_mesh(8, "cpu")
    batch, orig = sharded_tsdf.make_sharded_batch(cap, n_vox, mesh)
    orig.put(np.arange(cap), [torch.as_tensor(origins)])
    tq = sharded_tsdf.sharded_integrate_step(mesh, intr, cfg.tsdf)(
        batch, orig, sharded_tsdf.ShardedRows.from_full(mesh, [torch.as_tensor(active)]),
        torch.tensor(np.asarray(depth)),
        torch.tensor(np.asarray(rgb)), torch.tensor(np.asarray(quality)),
        torch.tensor(np.asarray(pose)), 1.0)
    rows = batch.gather(np.arange(cap))
    assert rows[1].sum() > 0
    np.testing.assert_allclose(rows[1].numpy(), np.asarray(jout.weight), atol=1e-6)
    np.testing.assert_allclose(rows[0].numpy(), np.asarray(jout.sdf), atol=1e-4)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-2)
    assert batch.per_shard("sharded_step") == [1] * 8
    # shard k holds slots k, k+8, ...: slot 9's row is shard 1's row 1
    np.testing.assert_array_equal(batch.parts[1][1][1].numpy(), rows[1][9].numpy())


def test_round_robin_placement_spreads_a_fresh_map_fault_14():
    """The allocator hands out ascending slots; the port places slot s on
    shard s % n, so a fresh map's chunks spread within one of even over
    the shards. The JAX package's contiguous blocks (NamedSharding(P))
    put every one of them on the first shard (ROADMAP fault 14)."""
    vol = TSDFVolume(CFG, device="cpu", mesh=pmesh.make_mesh(8, "cpu"))
    poses = jsyn.orbit_trajectory(2)
    depth, _ = jsyn.render_frame(jsyn.BoxRoomScene(), JI, jnp.asarray(poses[0]))
    slots = vol.discover_chunks(torch.tensor(np.asarray(depth)),
                                torch.as_tensor(poses[0]))
    assert len(slots) > 50
    per_shard = np.bincount(vol.mesh.shard_of(slots), minlength=8)
    assert per_shard.max() - per_shard.min() <= 1, per_shard
    block = (vol.cfg.capacity + 1) // 8
    contiguous = np.bincount(np.asarray(slots) // block, minlength=8)
    assert contiguous[0] == len(slots) and not contiguous[1:].any()


def test_readers_of_rows_work_sharded(pair, seq, tmp_path):
    """Raycast, sdf_at and the checkpoint read a sharded volume through
    its container and agree exactly with the unsharded port; a
    checkpoint of the sharded pipeline restores into a sharded pipeline."""
    shd, ref = pair
    poses = seq[0]
    a = raycast.raycast_volume(shd.volume, poses[3], n_steps=48)
    b = raycast.raycast_volume(ref.volume, poses[3], n_steps=48)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a.hit.float().mean() > 0.3     # ten orbit frames map part of this view
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-1.5, 1.5, (500, 3)),
                          dtype=torch.float32) + torch.tensor([0.0, 0.0, 1.0])
    for x, y in zip(shd.volume.sdf_at(pts), ref.volume.sdf_at(pts)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    cap = ref.volume.cfg.capacity
    arrays, _ = checkpoint.pipeline_state(shd)
    rarrays, _ = checkpoint.pipeline_state(ref)
    for name in ("sdf", "weight", "color", "color_count", "origins"):
        np.testing.assert_array_equal(arrays[name][:cap], rarrays[name][:cap])
    path = str(tmp_path / "shd.ckpt")
    checkpoint.save_pipeline(shd, path)
    back = TPipeline(SHARDED, device="cpu")
    checkpoint.load_pipeline(back, path)
    assert back.volume.sharded
    for x, y in zip(_rows(back.volume, cap + 8), _rows(shd.volume, cap + 8)):
        np.testing.assert_array_equal(x, y)


def test_streaming_offloads_and_restores_sharded(seq):
    """ChunkStreamer gathers and puts rows through the container: with
    half the map resident, sharded and unsharded runs stay identical."""
    _, depths, rgbs = seq

    def streamed(base):
        return base.replace(tsdf=dataclasses.replace(base.tsdf, max_resident_chunks=40,
                                                     streaming_radius=1.0))
    shd = _port(streamed(SHARDED), depths, rgbs)
    ref = _port(streamed(UNSHARDED), depths, rgbs)
    assert shd.streamer.offloaded == ref.streamer.offloaded > 0
    assert shd.streamer.restored == ref.streamer.restored
    cap = ref.volume.cfg.capacity
    np.testing.assert_array_equal(shd.volume.used[:cap], ref.volume.used)
    for a, b in zip(_rows(shd.volume, cap), _rows(ref.volume, cap)):
        np.testing.assert_array_equal(a, b)
    for k in ref.streamer.cold:
        for x, y in zip(shd.streamer.cold[k][:4], ref.streamer.cold[k][:4]):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    for a, b in zip(shd.mesher.full_mesh(), ref.mesher.full_mesh()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def meshed_rows(pair):
    """The unsharded run's rows and 48 meshed chunks with their neighbours."""
    _, ref = pair
    vol = ref.volume
    slots = np.nonzero(ref.mesher.tcount[:-1] > 0)[0][:48]
    nbr = ref.mesher._neighbor_slots(slots)
    origins = vol.ids[slots].astype(np.float32) * vol.extent
    rows = [a.numpy() for a in vol.batch]
    return rows, slots, nbr, origins, vol.cfg


def test_mesh_chunks_and_compaction_match_jax(meshed_rows):
    rows, slots, nbr, origins, cfg = meshed_rows
    args = (cfg.chunk_size, cfg.voxel_resolution)
    jm = jmc.mesh_chunks(*(jnp.asarray(r) for r in rows), jnp.asarray(slots),
                         jnp.asarray(nbr.astype(np.int32)), jnp.asarray(origins), *args)
    tm = mc.mesh_chunks(*(torch.as_tensor(r) for r in rows), torch.as_tensor(slots),
                        torch.as_tensor(nbr), torch.as_tensor(origins), *args)
    np.testing.assert_array_equal(tm.vert_valid.numpy(), np.asarray(jm.vert_valid))
    np.testing.assert_array_equal(tm.triangles.numpy(), np.asarray(jm.triangles))
    v = tm.vert_valid.numpy()
    assert v.sum() > 1000
    for name in ("positions", "normals", "colors"):
        np.testing.assert_allclose(getattr(tm, name).numpy()[v], np.asarray(getattr(jm, name))[v],
                                   atol=1e-5)
    active = np.arange(len(slots)) % 5 != 0
    for got, want in zip(mc.compact_mesh(tm, active), jmc.compact_mesh(jm, active)):
        assert got.shape == want.shape and len(got) > 100
        np.testing.assert_allclose(got, want, atol=1e-5)
    td = mc.compact_mesh_device(tm, torch.as_tensor(active), 4096, 8192)
    jd = jmc.compact_mesh_device(jm, jnp.asarray(active), 4096, 8192)
    np.testing.assert_array_equal(td.vcount.numpy(), np.asarray(jd.vcount))
    np.testing.assert_array_equal(td.tcount.numpy(), np.asarray(jd.tcount))
    np.testing.assert_array_equal(td.triangles.numpy(), np.asarray(jd.triangles))
    _same_records(td.vert_rec.numpy(), np.asarray(jd.vert_rec))


def _same_records(got, want):
    """Vertex records: the packed normal and colour words equal, positions
    within 1e-5, then unpack_vert_records on both equal to that."""
    got_u = got.astype(np.uint32)
    np.testing.assert_array_equal(got_u[:, 3:], want[:, 3:])
    gp, gc, gn = mc.unpack_vert_records(got)
    wp, wc, wn = jmc.unpack_vert_records(want)
    np.testing.assert_allclose(gp, wp, atol=1e-5)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gn, wn)


def test_mesh_chunks_compact_matches_jax(meshed_rows):
    rows, slots, nbr, origins, cfg = meshed_rows
    active = np.arange(len(slots)) % 7 != 3
    want = jmc.mesh_chunks_compact(*(jnp.asarray(r) for r in rows),
                                   jnp.asarray(nbr.astype(np.int32)), jnp.asarray(origins),
                                   jnp.asarray(active), cfg.chunk_size, cfg.voxel_resolution,
                                   8192, 16384)
    got = mc.mesh_chunks_compact(*(torch.as_tensor(r) for r in rows), torch.as_tensor(nbr),
                                 torch.as_tensor(origins), torch.as_tensor(active),
                                 cfg.chunk_size, cfg.voxel_resolution, 8192, 16384)
    np.testing.assert_array_equal(got.vcount.numpy(), np.asarray(want.vcount))
    np.testing.assert_array_equal(got.tcount.numpy(), np.asarray(want.tcount))
    assert int(got.vcount.sum()) > 1000
    np.testing.assert_array_equal(got.triangles.numpy(), np.asarray(want.triangles))
    _same_records(got.vert_rec.numpy(), np.asarray(want.vert_rec))
