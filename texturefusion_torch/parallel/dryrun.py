"""One whole multi-device map cycle, then the live pipeline, on a mesh.

Port of __graft_entry__.dryrun_multichip: the same inputs, drawn from
numpy.random.default_rng(0) in the same order, and the same checks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from texturefusion_torch.parallel.mesh import DeviceMesh, make_mesh


def _camera():
    from texturefusion_torch.config import CameraConfig
    return CameraConfig(width=64, height=48, fx=52.0, fy=52.0, cx=31.5, cy=23.5,
                        far_plane=6.0)


def multichip_inputs(n_devices: int) -> dict:
    """The map cycle's inputs as __graft_entry__.dryrun_multichip draws them
    from numpy.random.default_rng(0), as numpy arrays: chunk origins
    [8n, 3], the edge's points [32, 3], depth [48, 64], rgb [48, 64, 3]
    and the MRF problem's unary [16, 4], label_kf [16, 4] and neighbors
    [16, 6]."""
    cap = 8 * n_devices
    rng = np.random.default_rng(0)
    out = {"origins": (rng.integers(-3, 3, (cap, 3)) * 0.4).astype(np.float32),
           "points": rng.uniform(-1, 1, (32, 3)).astype(np.float32),
           "depth": rng.uniform(0.5, 2.5, (48, 64)).astype(np.float32),
           "rgb": rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)}
    out["unary"] = rng.uniform(0, 1, (16, 4)).astype(np.float32)
    out["label_kf"] = rng.integers(0, 8, (16, 4)).astype(np.int32)
    out["neighbors"] = rng.integers(0, 16, (16, 6))
    return out


def multichip_cycle(mesh: DeviceMesh, n_devices: int):
    """One full map cycle (make_multichip_full_step) over `mesh` on
    dryrun_multichip's inputs for n_devices (8·n_devices slots,
    2·n_devices meshed chunks; the mesh size must divide the slots).
    Returns (state after the step, n_found, vcount, labels)."""
    from texturefusion_torch.config import tiny_test_config
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.models.reconstruction import (
        MultichipFullState, make_multichip_full_step)
    from texturefusion_torch.ops import tsdf as tsdf_ops
    from texturefusion_torch.parallel import ba as pba
    from texturefusion_torch.parallel.sharded_tsdf import ShardedRows
    from texturefusion_torch.slam import fastba
    from texturefusion_torch.texture import mrf as mrf_ops

    dev0 = mesh.devices[0]
    cfg = tiny_test_config()
    # tiny shapes: the camera scaled down, a few chunks and edges a shard
    intr = cam.Intrinsics.from_config(_camera())
    n_kf = 8
    cap = 8 * n_devices
    n_vox = cfg.tsdf.chunk_size ** 3
    mesh_u = n_devices * 2
    x = multichip_inputs(n_devices)

    def dev(a):
        return torch.as_tensor(a, device=dev0)

    step = make_multichip_full_step(mesh, intr, cfg.tsdf, cfg.ba, n_kf, mesh_u,
                                    vert_cap=2048, tri_cap=4096)
    # a small pose graph, one edge, padded and sharded over the edges
    edges = fastba.make_edges(max(16, n_devices), dev0)
    p = dev(x["points"])
    fastba.write_edges(edges, torch.zeros(1, dtype=torch.int64, device=dev0), 0, 1,
                       [s[None] for s in fastba.preintegrate_edge(
                           p, p, torch.ones(32, device=dev0))])
    state = MultichipFullState(
        batch=ShardedRows.from_full(mesh, list(tsdf_ops.make_empty_batch(cap, n_vox, "cpu"))),
        origins=ShardedRows.from_full(mesh, [torch.as_tensor(x["origins"])]),
        active=ShardedRows.from_full(mesh, [torch.ones(cap, dtype=torch.bool)]),
        datacost=ShardedRows.from_full(mesh, [torch.zeros((cap, n_kf))]),
        poses=torch.eye(4, device=dev0).repeat(n_kf, 1, 1),
        edges=pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh))
    depth, rgb = dev(x["depth"]), dev(x["rgb"])
    nodes = 16
    # a small replicated MRF problem (labels over observed keyframes)
    problem = mrf_ops.MRFProblem(
        unary=dev(x["unary"]), label_kf=dev(x["label_kf"]), neighbors=dev(x["neighbors"]),
        parity=torch.arange(nodes, dtype=torch.int32, device=dev0) % 2,
        init_label=torch.zeros(nodes, dtype=torch.int64, device=dev0),
        n_valid=torch.ones(nodes, dtype=torch.bool, device=dev0))
    return step(state, depth, rgb, torch.abs(rgb[..., 0]), torch.eye(4, device=dev0), 1,
                torch.ones(n_kf, dtype=torch.bool, device=dev0),
                torch.arange(mesh_u, dtype=torch.int64, device=dev0) % cap, problem)


def dryrun_multichip(n_devices: int, device="cuda", mesh: Optional[DeviceMesh] = None) -> dict:
    """Run ONE full map cycle (chunk discovery, chunk-sharded TSDF
    integration, marching cubes across shards, texture datacost, MRF view
    selection, an edge-sharded BA round) over an n_devices mesh of
    `device` (or over `mesh`, e.g. several shards of one GPU), then the
    live ReconstructionPipeline, tsdf_sharded, on three tiny frames.
    Raises AssertionError when a check fails; returns what it checked."""
    from texturefusion_torch.config import ParallelConfig, tiny_test_config
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.pipeline import ReconstructionPipeline
    from texturefusion_torch.io import synthetic

    if mesh is None:
        mesh = make_mesh(n_devices, device)
    n_devices = mesh.size
    dev0 = mesh.devices[0]
    out, n_found, vcount, labels = multichip_cycle(mesh, n_devices)
    weight_sum = float(sum(part[1].sum().item() for part in out.batch.parts))
    assert torch.isfinite(out.poses).all()
    assert weight_sum >= 0.0
    assert int(n_found) >= 0
    assert tuple(vcount.shape) == (2 * n_devices,)
    assert labels.shape[0] == 16

    # ---- the live pipeline, chunk-sharded over the same mesh: tracking,
    # discovery, the allocation loop, sharded integration, the sharded
    # mesh pool and BA, on tiny frames
    pcfg = tiny_test_config().replace(
        camera=_camera(), parallel=ParallelConfig(tsdf_sharded=True, n_devices=n_devices))
    traj = synthetic.orbit_trajectory(3)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(),
                                             cam.Intrinsics.from_config(_camera()), traj,
                                             device=dev0)
    pipe = ReconstructionPipeline(pcfg, device=dev0, mesh=mesh)
    for i in range(3):
        pipe.process_frame(torch.as_tensor(np.asarray(depths[i])),
                           torch.as_tensor(np.asarray(rgbs[i])), timestamp=float(i))
    pipe.finish()
    pipe_weight = float(pipe.volume.dense_batch()[0].weight.sum())
    assert pipe.volume.sharded
    assert pipe.volume.n_active() > 0
    assert pipe_weight > 0.0
    return {"shards": n_devices, "n_found": int(n_found), "vcount": vcount.cpu().numpy(),
            "labels": labels.cpu().numpy(), "weight_sum": weight_sum,
            "poses": out.poses.cpu().numpy(), "pipeline_active": pipe.volume.n_active(),
            "pipeline_weight": pipe_weight}
