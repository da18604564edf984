"""The multichip map cycle (models/reconstruction.make_multichip_full_step,
make_multichip_step) and dryrun_multichip, port against JAX.

Both packages take __graft_entry__.dryrun_multichip's inputs (drawn from
numpy.random.default_rng(0), `parallel/dryrun.multichip_inputs`): the
JAX step on its eight CPU devices, the port's on an 8-shard CPU
DeviceMesh (`parallel/dryrun.multichip_cycle`). Tolerances: n_found,
the per-chunk vertex counts and the MRF labels equal; the TSDF weight sum rtol 1e-6 (sums of ±1 weights); the
poses atol 1e-5 (one GN round of float32 solves in another order); the
datacost column atol 1e-3 relative to its largest entry (sums of
quality over a chunk's voxels in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from texturefusion_tpu.config import CameraConfig as JCameraConfig
from texturefusion_tpu.config import tiny_test_config as jtiny
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.models import reconstruction as jrec
from texturefusion_tpu.ops import tsdf as jtsdf
from texturefusion_tpu.parallel import ba as jpba
from texturefusion_tpu.slam import fastba as jfastba
from texturefusion_tpu.texture import mrf as jmrf
from texturefusion_torch.config import CameraConfig, tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.models import reconstruction as trec
from texturefusion_torch.ops import tsdf as tsdf_ops
from texturefusion_torch.parallel import ba as pba
from texturefusion_torch.parallel import mesh as pmesh
from texturefusion_torch.parallel.dryrun import (dryrun_multichip, multichip_cycle,
                                                 multichip_inputs)
from texturefusion_torch.parallel.sharded_tsdf import ShardedRows
from texturefusion_torch.slam import fastba

torch.set_num_threads(2)

N, N_KF = 8, 8
CAP, MESH_U = 8 * N, 2 * N
CAM = dict(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5, far_plane=6.0)


def _jax_state(x, full=True):
    cfg = jtiny()
    m = Mesh(np.asarray(jax.devices()[:N]), ("shard",))
    sh, rep = NamedSharding(m, P("shard")), NamedSharding(m, P())
    n_vox = cfg.tsdf.chunk_size ** 3
    batch = jtsdf.ChunkBatch(*(jax.device_put(a, sh) for a in jtsdf.make_empty_batch(CAP, n_vox)))
    edges = jfastba.make_edges(16)
    p = jnp.asarray(x["points"])
    s = jfastba.preintegrate_edge(p, p, jnp.ones(32))
    edges = edges._replace(kf_i=edges.kf_i.at[0].set(0), kf_j=edges.kf_j.at[0].set(1),
                           s_w=edges.s_w.at[0].set(s[0]), s_p=edges.s_p.at[0].set(s[1]),
                           s_q=edges.s_q.at[0].set(s[2]), s_pp=edges.s_pp.at[0].set(s[3]),
                           s_qq=edges.s_qq.at[0].set(s[4]), s_pq=edges.s_pq.at[0].set(s[5]),
                           valid=edges.valid.at[0].set(True))
    edges = jax.tree.map(lambda a: jax.device_put(a, sh), jpba.pad_edges_for_mesh(edges, N))
    kw = dict(batch=batch, origins=jax.device_put(jnp.asarray(x["origins"]), sh),
              active=jax.device_put(jnp.ones(CAP, bool), sh),
              poses=jax.device_put(jnp.tile(jnp.eye(4), (N_KF, 1, 1)), rep), edges=edges)
    if full:
        return m, cfg, jrec.MultichipFullState(datacost=jax.device_put(jnp.zeros((CAP, N_KF)), sh),
                                               **kw)
    return m, cfg, jrec.MultichipState(**kw)


def _port_state(x, mesh):
    cfg = tiny_test_config()
    n_vox = cfg.tsdf.chunk_size ** 3
    edges = fastba.make_edges(16, "cpu")
    p = torch.as_tensor(x["points"])
    fastba.write_edges(edges, torch.zeros(1, dtype=torch.int64), 0, 1,
                       [s[None] for s in fastba.preintegrate_edge(p, p, torch.ones(32))])
    kw = dict(batch=ShardedRows.from_full(mesh, list(tsdf_ops.make_empty_batch(CAP, n_vox, "cpu"))),
              origins=ShardedRows.from_full(mesh, [torch.as_tensor(x["origins"])]),
              active=ShardedRows.from_full(mesh, [torch.ones(CAP, dtype=torch.bool)]),
              poses=torch.eye(4).repeat(N_KF, 1, 1),
              edges=pba.shard_edges(pba.pad_edges_for_mesh(edges, N), mesh))
    return cfg, trec.MultichipState(**kw)


def _full(rows: ShardedRows, field: int) -> np.ndarray:
    return rows.gather(np.arange(rows.n_rows))[field].numpy()


@pytest.fixture(scope="module")
def both_full():
    x = multichip_inputs(N)
    m, jcfg, jstate = _jax_state(x)
    jintr = jcam.Intrinsics.from_config(JCameraConfig(**CAM))
    jstep = jrec.make_multichip_full_step(m, jintr, jcfg.tsdf, jcfg.ba, N_KF, MESH_U,
                                          vert_cap=2048, tri_cap=4096)
    rgb = jnp.asarray(x["rgb"])
    problem = jmrf.MRFProblem(
        unary=jnp.asarray(x["unary"]), label_kf=jnp.asarray(x["label_kf"]),
        neighbors=jnp.asarray(x["neighbors"].astype(np.int32)),
        parity=jnp.arange(16, dtype=jnp.int32) % 2, init_label=jnp.zeros(16, jnp.int32),
        n_valid=jnp.ones(16, bool))
    jout = jstep(jstate, jnp.asarray(x["depth"]), rgb, jnp.abs(rgb[..., 0]), jnp.eye(4),
                 jnp.int32(1), jnp.ones(N_KF, bool),
                 jnp.arange(MESH_U, dtype=jnp.int32) % CAP, problem)

    tout = multichip_cycle(pmesh.make_mesh(N, "cpu"), N)
    return jout, tout


def test_multichip_full_step_matches_jax(both_full):
    (jstate, jfound, jvc, jlab), (tstate, tfound, tvc, tlab) = both_full
    assert int(tfound) == int(jfound) > 0
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
    assert np.asarray(jvc).sum() > 0
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    w = _full(tstate.batch, 1)
    np.testing.assert_allclose(w.sum(), float(jnp.sum(jstate.batch.weight)), rtol=1e-6)
    np.testing.assert_array_equal(w, np.asarray(jstate.batch.weight))
    np.testing.assert_allclose(tstate.poses.numpy(), np.asarray(jstate.poses), atol=1e-5)
    dc, jdc = _full(tstate.datacost, 0), np.asarray(jstate.datacost)
    np.testing.assert_allclose(dc, jdc, atol=1e-3 * max(np.abs(jdc[jdc > -1e10]).max(), 1.0))
    assert (dc[:, 1] != 0).any() and (dc[:, [0] + list(range(2, N_KF))] == 0).all()


def test_multichip_step_matches_jax():
    x = multichip_inputs(N)
    m, jcfg, jstate = _jax_state(x, full=False)
    jintr = jcam.Intrinsics.from_config(JCameraConfig(**CAM))
    rgb = jnp.asarray(x["rgb"])
    jout = jrec.make_multichip_step(m, jintr, jcfg.tsdf, jcfg.ba, N_KF)(
        jstate, jnp.asarray(x["depth"]), rgb, jnp.abs(rgb[..., 0]), jnp.eye(4),
        jnp.ones(N_KF, bool))
    mesh = pmesh.make_mesh(N, "cpu")
    cfg, state = _port_state(x, mesh)
    intr = cam.Intrinsics.from_config(CameraConfig(**CAM))
    trgb = torch.as_tensor(x["rgb"])
    tout = trec.make_multichip_step(mesh, intr, cfg.tsdf, cfg.ba, N_KF)(
        state, torch.as_tensor(x["depth"]), trgb, trgb[..., 0].abs(), torch.eye(4),
        torch.ones(N_KF, dtype=torch.bool))
    for f, name in enumerate(("sdf", "weight")):
        np.testing.assert_allclose(_full(tout.batch, f), np.asarray(getattr(jout.batch, name)),
                                   atol=1e-4 if name == "sdf" else 1e-6)
    np.testing.assert_allclose(tout.poses.numpy(), np.asarray(jout.poses), atol=1e-5)
    assert state.batch.per_shard("sharded_step") == [1] * N


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_cpu_shards(n):
    r = dryrun_multichip(n, device="cpu")
    assert r["shards"] == n and r["pipeline_active"] > 0 and r["pipeline_weight"] > 0
    assert r["vcount"].shape == (2 * n,) and r["labels"].shape == (16,)
