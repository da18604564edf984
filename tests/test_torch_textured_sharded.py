"""TexturedPipeline over a chunk-sharded mesh pool, port against the
unsharded port and against the JAX package.

tests/test_torch_textured_pipeline.py's CFG0 with parallel.tsdf_sharded
over the eight CPU shards (slot s on shard s % 8), on 10 and 11 orbit
frames. Against the unsharded port everything is EXACTLY the same: both
shard BA's edges over the same eight shards, so the maps are equal
(tests/test_torch_parallel_tsdf.py), and the texture stage reads the
same rows through the pool reader: labels, wrong flags, uvs, the patch
records, the device texture state, the atlas and the exported OBJ / MTL /
PNG bytes. Against the JAX package's sharded TexturedPipeline (its pool a
NamedSharding over its eight CPU devices, gathered by XLA): the
assertions and tolerances of test_torch_textured_pipeline.py, run on
these pipelines. The fusion thread gives the synchronous run. The pool
reader's gather of a slot tensor equals the host-listed gather and plain
indexing, one cycle through it equals the one-device cycle on the
assembled pool, and no cycle reads more than its projection budget of
pool rows.

export_textured bakes the colour transfers into the atlas, so the test
that exports both of a fixture's pipelines comes last, after those that
compare an atlas before its export.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_textured_pipeline as ttp
from test_torch_draws import JaxKeyDraws, tracked2_draws
from test_torch_pipeline import JI, SCENE, SYNC, _pallas_bilateral
from test_torch_textured_pipeline import CFG0, _jax, _port
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_torch.ops import marching_cubes as mc
from texturefusion_torch.parallel.mesh import DeviceMesh, make_mesh
from texturefusion_torch.parallel.sharded_tsdf import ShardedRows
from texturefusion_torch.texture import patch
from texturefusion_torch.utils.stopwatch import STOPWATCH

torch.set_num_threads(2)

SHARDED0 = CFG0.replace(parallel=dataclasses.replace(SYNC, tsdf_sharded=True, n_devices=8))
UNSHARDED0 = CFG0.replace(parallel=dataclasses.replace(SYNC, n_devices=8))


@pytest.fixture(scope="module")
def seqs():
    return {n: jsyn.render_sequence(SCENE, JI, jsyn.orbit_trajectory(n)) for n in (10, 11)}


@pytest.fixture(scope="module")
def ports(seqs):
    """n → (sharded run, unsharded run, (pool rows and whole columns the
    sharded pool handed out, texture cycles) over the sharded run)."""
    out = {}
    for n, (depths, rgbs) in seqs.items():
        cycles = STOPWATCH.counts["tex_device"]
        shd = _port(SHARDED0, depths, rgbs)
        reads = (shd.mesher.pool_rows.rows_read, shd.mesher.pool_rows.columns_read,
                 STOPWATCH.counts["tex_device"] - cycles)
        out[n] = (shd, _port(UNSHARDED0, depths, rgbs), reads)
    return out


@pytest.fixture(scope="module")
def jaxes(seqs):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpre, "bilateral_filter", _pallas_bilateral)
        jax.clear_caches()
        try:
            for n, (depths, rgbs) in seqs.items():
                out[n] = _jax(SHARDED0, depths, rgbs)
        finally:
            jax.clear_caches()
    return out


def test_sharded_textured_matches_jax_sharded(ports, jaxes, tmp_path):
    """10 frames: test_textured_pipeline_matches_jax's assertions."""
    jp, shd = jaxes[10], ports[10][0]
    assert jp.volume.sharding is not None and shd.volume.sharded
    ttp.test_textured_pipeline_matches_jax({10: (jp, shd, None, None)}, tmp_path)


def test_sharded_textured_with_cycles_matches_jax_sharded(ports, jaxes):
    """11 frames: test_textured_pipeline_with_cycles_matches_jax's assertions."""
    ttp.test_textured_pipeline_with_cycles_matches_jax({11: (jaxes[11], ports[11][0], None,
                                                             None)})


def _texture_state(pipe):
    tm = pipe.texture
    tex = {s: (t.label, t.wrong, t.uv16, t.atlas_uv, t.uv_valid) for s, t in tm.chunk_tex.items()}
    recs = {s: (r.slot_index, r.kf_id, r.bbox_min, r.bbox_max)
            for s, r in tm.atlas.patches.items()}
    return tex, recs


def test_async_sharded_textured_run_matches_sync(seqs, ports):
    """The fusion thread runs the texture cycles, and their gathers, on
    its own: the same 11 frames give the synchronous sharded run."""
    depths, rgbs = seqs[11]
    sync = ports[11][0]
    pipe = _port(SHARDED0.replace(parallel=dataclasses.replace(SHARDED0.parallel,
                                                               async_fusion=True)),
                 depths, rgbs)
    assert pipe.volume.sharded
    np.testing.assert_array_equal(pipe.trajectory(), sync.trajectory())
    (tex, recs), (stex, srecs) = _texture_state(pipe), _texture_state(sync)
    assert tex.keys() == stex.keys() and recs.keys() == srecs.keys() and len(recs) > 20
    for s in tex:
        assert tex[s][:2] == stex[s][:2]
        if tex[s][2] is not None:
            np.testing.assert_array_equal(tex[s][2], stex[s][2])
    np.testing.assert_array_equal(pipe.texture.atlas.image, sync.texture.atlas.image)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_gather_rows_of_a_slot_tensor(n_shards):
    """gather_rows (a slot tensor, no host read) equals gather (a host
    list) and plain indexing of the slot-ordered tensors, the trash slot
    (the last) among the slots; column reassembles a whole column."""
    rng = np.random.default_rng(n_shards)
    n_rows = 40 * n_shards
    full = [torch.as_tensor(rng.normal(size=(n_rows, 7, 3)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 1 << 24, (n_rows, 7)).astype(np.int32)),
            torch.as_tensor(rng.integers(0, 300, n_rows).astype(np.int32))]
    rows = ShardedRows.from_full(DeviceMesh(["cpu"] * n_shards), full)
    slots = rng.integers(0, n_rows, 61)
    slots[::7] = n_rows - 1
    got = rows.gather_rows(torch.as_tensor(slots), (0, 1, 2))
    for g, w, f in zip(got, rows.gather(slots), full):
        assert torch.equal(g, w) and torch.equal(g, f[torch.as_tensor(slots)])
    for f in (0, 2):
        assert torch.equal(rows.column(f), full[f])
    assert rows.rows_read == 2 * len(slots) and rows.columns_read == 2


def test_one_cycle_through_the_sharded_reader_is_exact(ports):
    """After the 11-frame run, one texture cycle over every meshed chunk:
    through the sharded pool reader, and texture_cycle_incremental on the
    same pool assembled on one device, from copies of the same state."""
    shd = ports[11][0]
    tm, mesher = shd.texture, shd.mesher
    newest = len(shd.slam.keyframes) - 1
    meshed, nbr = mesher.chunk_adjacency_arrays()
    problem, slots, rmask, _ = tm.build_cycle(shd.volume, meshed, nbr, shd._tex_states(),
                                              newest, set(meshed.tolist()))
    pool = mc.MeshPool(*mesher.pool_rows.gather(np.arange(mesher.pool_rows.n_rows)))

    def state():
        return tuple(t.clone() for t in (tm._labels_dev, tm._stats_dev, tm._failed_dev))

    sharded = state()
    got = tm.run_cycle(problem, slots, rmask, newest, mesher.pool_reader(), sharded)
    one = state()
    want = patch.texture_cycle_incremental(
        problem, torch.as_tensor(slots), *one, torch.as_tensor(rmask), pool.verts,
        pool.col_packed, pool.vcount, pool.tcount, tm.kf_stack.rgb_packed, tm.kf_stack.depth,
        torch.as_tensor(tm.kf_stack.poses), max(newest - 1, 0), tm.intr, tm.cfg,
        tm.cfg.mrf_sweeps, tm.cfg.patch_project_budget)
    assert int(got.n_changed) == len(meshed) > 20 and bool(got.uv_valid.any())
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    for a, b in zip(sharded, one):
        assert torch.equal(a, b)


def test_a_cycle_reads_at_most_m_budget_pool_rows(ports):
    """No texture cycle copies the whole pool: over each sharded run the
    pool handed out its projection budget of rows (verts and colours of
    the projected lanes) and the vcount and tcount columns a cycle, and
    nothing else."""
    m = CFG0.texture.patch_project_budget
    for shd, _, (rows, columns, cycles) in ports.values():
        assert cycles >= 2 and rows == m * cycles and columns == 2 * cycles
        assert m < shd.mesher.pool_rows.n_rows


def test_textured_pipeline_on_an_explicit_mesh(seqs, ports, tmp_path):
    """TexturedPipeline(mesh=) shards the volume over the mesh given, with
    the texture state on its first device sized to the pool's rows, and
    runs to export_textured: the 8-shard mesh gives the tsdf_sharded run."""
    depths, rgbs = seqs[10]
    pipe = ttp.PortSyncTextured(UNSHARDED0, device="cpu", mesh=make_mesh(8, "cpu"),
                            draw_fn=JaxKeyDraws(),
                            frame_draws=lambda i: tracked2_draws(jax.random.PRNGKey(7), i,
                                                                 UNSHARDED0.tracking))
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        pipe.process_frame(d, c, timestamp=float(i))
    pipe.finish()
    pipe.close()
    assert pipe.volume.sharded and pipe.volume.mesh.size == 8
    assert pipe.texture._labels_dev.shape == (pipe.volume.cfg.capacity + 1,)
    (tex, recs), (rtex, rrecs) = _texture_state(pipe), _texture_state(ports[10][1])
    assert tex.keys() == rtex.keys() and recs.keys() == rrecs.keys() and len(recs) > 20
    assert all(tex[s][:2] == rtex[s][:2] for s in tex)
    obj = pipe.export_textured(str(tmp_path))
    assert sum(ln.startswith("v ") for ln in open(obj)) > 100


@pytest.mark.parametrize("n", [10, 11])
def test_sharded_textured_equals_unsharded_port(ports, n, tmp_path):
    shd, ref, _ = ports[n]
    assert shd.volume.sharded and shd.volume.mesh.size == 8 and not ref.volume.sharded
    cap = ref.volume.cfg.capacity
    assert (shd.volume.cfg.capacity + 1) % 8 == 0
    np.testing.assert_array_equal(shd.trajectory(), ref.trajectory())
    (tex, recs), (rtex, rrecs) = _texture_state(shd), _texture_state(ref)
    assert tex.keys() == rtex.keys() and len(tex) > 20
    assert recs.keys() == rrecs.keys() and len(recs) > 20
    for got, want in [(tex[s], rtex[s]) for s in tex] + [(recs[s], rrecs[s]) for s in recs]:
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            np.testing.assert_array_equal(a, b)
    ts, tr = shd.texture, ref.texture
    for a, b in ((ts._labels_dev, tr._labels_dev), (ts._stats_dev, tr._stats_dev),
                 (ts._failed_dev, tr._failed_dev)):
        assert len(a) == shd.mesher.pool_rows.n_rows and len(b) == cap + 1
        assert torch.equal(a[:cap], b[:cap])
        assert bool((a[cap:] == b[cap]).all())      # every row past cap as the trash row
    assert ts.kf_stack.present == tr.kf_stack.present
    for p, name in ((shd, "shd"), (ref, "ref")):
        p.export_textured(str(tmp_path / name))
    for ext in ("obj", "mtl", "png"):
        got = (tmp_path / "shd" / f"model.{ext}").read_bytes()
        assert got and got == (tmp_path / "ref" / f"model.{ext}").read_bytes(), ext
    np.testing.assert_array_equal(ts.atlas.image, tr.atlas.image)
