#!/usr/bin/env python3
"""Multi-device scaling benchmark of the PyTorch port: the chunk-sharded
TSDF integration step, edge-sharded BA, the dense-vs-Schur BA crossover
and the full multichip map cycle, on 1 device and on N.

The port's counterpart of examples/bench_multichip.py: the same inputs,
drawn from the same numpy generators in the same order, and the same
rates (steps/s, Gauss-Newton iterations/s, ms a GN iteration). A mesh is
a `parallel.mesh.DeviceMesh`:

    python3 tools/bench_multichip.py [--cap 4096] [--device cuda|cpu]
                                     [--devices N | --shards-on-one-card N]

--devices N takes the first N cards (`make_mesh(N, "cuda")`, which raises
with fewer); the default is every visible card. --shards-on-one-card N
puts N shards on the first card (`DeviceMesh(["cuda:0"] * N)`): they
share its stream, so those rows measure the sharding's overhead on one
card, not scaling, as the JAX script's virtual CPU devices do. With
--device cpu the mesh's devices are the CPU's virtual shards. --device
cuda without CUDA raises. Imports no jax and no image library.

The rows are updated in place (the JAX step donates its buffers and
adopts the new ones): repeated steps change the values, not the work.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# test_parallel.py's Schur tolerances: the Schur poses against the dense ones
BA_RTOL, BA_ATOL = 2e-3, 2e-4


def make_bench_mesh(device="cuda", devices=None, shards_on_one_card=None):
    """The mesh of a run: `shards_on_one_card` shards of the first device,
    or the first `devices` devices (all visible when None)."""
    from texturefusion_torch.parallel.mesh import DeviceMesh, make_mesh
    from texturefusion_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if shards_on_one_card is not None:
        first = torch.device(dev.type, 0) if dev.type == "cuda" else dev
        return DeviceMesh([first] * int(shards_on_one_card))
    return make_mesh(devices, dev.type)


def sync_mesh(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _vga():
    from texturefusion_torch.config import CameraConfig
    from texturefusion_torch.core import camera as cam
    return cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))


def bench_sharded_tsdf(mesh, cap: int, n_iters: int = 20) -> dict:
    """The all-slots integration step (sharded_integrate_step, K2 on every
    CUDA shard) over `cap` slots of random origins, one VGA frame:
    {"steps_s", "batch": the rows after 1 + n_iters steps}."""
    from texturefusion_torch.config import TSDFConfig
    from texturefusion_torch.parallel import sharded_tsdf
    intr = _vga()
    cfg = TSDFConfig(voxel_resolution=0.02, capacity=cap)
    dev0 = mesh.devices[0]
    batch, origins = sharded_tsdf.make_sharded_batch(cap, cfg.chunk_size ** 3, mesh)
    rng = np.random.default_rng(0)
    origins.put(np.arange(cap), [torch.as_tensor(
        (rng.integers(-10, 10, (cap, 3)) * 0.16).astype(np.float32))])
    active = sharded_tsdf.ShardedRows.from_full(mesh, [torch.ones(cap, dtype=torch.bool)])
    depth = torch.as_tensor(rng.uniform(0.5, 3.0, (intr.height, intr.width)).astype(np.float32),
                            device=dev0)
    rgb = torch.as_tensor(rng.uniform(0, 1, (intr.height, intr.width, 3)).astype(np.float32),
                          device=dev0)
    quality = torch.zeros_like(depth)
    pose = torch.eye(4, device=dev0)
    step = sharded_tsdf.sharded_integrate_step(mesh, intr, cfg)
    step(batch, origins, active, depth, rgb, quality, pose, 1.0)
    sync_mesh(mesh)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        step(batch, origins, active, depth, rgb, quality, pose, 1.0)
    sync_mesh(mesh)
    return {"steps_s": n_iters / (time.perf_counter() - t0), "batch": batch}


def _tiled(sums, n: int) -> dict:
    """One edge's moment sums (preintegrate_edge's s_p ... s_pq) on n edges."""
    return {k: a.expand(n, *a.shape).clone()
            for k, a in zip(("s_p", "s_q", "s_pp", "s_qq", "s_pq"), sums[1:])}


def bench_distributed_ba(mesh, n_kf: int = 64, n_edges: int = 512, n_iters: int = 10) -> float:
    """distributed_gn (4 iterations a round) on n_edges random chain edges
    over n_kf keyframes: Gauss-Newton iterations/s."""
    from texturefusion_torch.config import BAConfig
    from texturefusion_torch.parallel import ba as pba
    from texturefusion_torch.slam import fastba
    dev0 = mesh.devices[0]
    rng = np.random.default_rng(1)
    ki = rng.integers(0, n_kf - 1, n_edges)
    p = rng.uniform(-1, 1, (n_edges, 64, 3)).astype(np.float32)
    # the JAX script pre-integrates edges 0-7 and writes edge 0's sums to all
    s = fastba.preintegrate_edge(torch.as_tensor(p[0]), torch.as_tensor(p[0]), torch.ones(64))
    edges = fastba.EdgeSums(
        kf_i=torch.as_tensor(ki), kf_j=torch.as_tensor(ki + 1),
        s_w=torch.full((n_edges,), 64.0), **_tiled(s, n_edges),
        valid=torch.ones(n_edges, dtype=torch.bool))
    edges = pba.shard_edges(pba.pad_edges_for_mesh(fastba.EdgeSums(*(a.to(dev0) for a in edges)),
                                                   mesh.size), mesh)
    poses = torch.eye(4, device=dev0).repeat(n_kf, 1, 1)
    active = torch.ones(n_kf, dtype=torch.bool, device=dev0)
    cfg = BAConfig(gn_iterations_per_round=4)
    pba.distributed_gn(poses, edges, n_kf, active, cfg, mesh)
    sync_mesh(mesh)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        pba.distributed_gn(poses, edges, n_kf, active, cfg, mesh)
    sync_mesh(mesh)
    return n_iters * cfg.gn_iterations_per_round / (time.perf_counter() - t0)


def _synthetic_pose_graph(n_kf: int, device="cpu", max_edges: int = 4096, window: int = 7,
                          seed: int = 2):
    """Loop-shaped pose graph: each keyframe links to its `window`
    predecessors plus n_kf/4 long-range loop closures, every edge with the
    sums of 64 points matched to themselves; padded to a power-of-two
    bucket of at least 16. Returns (EdgeSums, real edge count)."""
    from texturefusion_torch.slam import fastba
    rng = np.random.default_rng(seed)
    ki, kj = [], []
    for d in range(1, window + 1):
        i = np.arange(d, n_kf)
        ki.append(i - d)
        kj.append(i)
    n_loops = n_kf // 4
    ki.append(rng.integers(0, n_kf // 2, n_loops))
    kj.append(rng.integers(n_kf // 2, n_kf, n_loops))
    ki = np.concatenate(ki)[:max_edges]
    kj = np.concatenate(kj)[:max_edges]
    n_e = len(ki)
    e_bucket = 16
    while e_bucket < n_e:
        e_bucket *= 2
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    pts[:, 2] += 2.0
    s = fastba.preintegrate_edge(torch.as_tensor(pts), torch.as_tensor(pts), torch.ones(64))
    pad = np.zeros(e_bucket - n_e, np.int64)
    edges = fastba.EdgeSums(
        kf_i=torch.as_tensor(np.concatenate([ki, pad])),
        kf_j=torch.as_tensor(np.concatenate([kj, pad])),
        s_w=torch.full((e_bucket,), 64.0), **_tiled(s, e_bucket),
        valid=torch.as_tensor(np.arange(e_bucket) < n_e))
    return fastba.EdgeSums(*(a.to(device) for a in edges)), n_e


def bench_ba_scale(mesh, ks=(64, 128, 256, 512), n_iters: int = 3, sep_budget: int = 128,
                   rtol: float = BA_RTOL, atol: float = BA_ATOL) -> list:
    """Dense (distributed_gn) against Schur (schur_gn) ms a Gauss-Newton
    iteration on _synthetic_pose_graph(K) at each K, one iteration a
    round: the Schur crossover. K is padded with inactive keyframes to a
    multiple of the shards. Each row also holds the largest |Schur pose -
    dense pose| and whether the Schur poses lie within rtol / atol of the
    dense ones; raises when they do not."""
    from texturefusion_torch.config import BAConfig
    from texturefusion_torch.parallel import ba as pba
    from texturefusion_torch.parallel.mesh import pad_to_multiple
    dev0 = mesh.devices[0]
    cfg = BAConfig(gn_iterations_per_round=1)
    rows = []
    for k in ks:
        edges, n_e = _synthetic_pose_graph(k, dev0)
        shards = pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh)
        n_kf = pad_to_multiple(k, mesh.size)
        poses = torch.eye(4, device=dev0).repeat(n_kf, 1, 1)
        active = torch.arange(n_kf, device=dev0) < k
        runs = {"dense": lambda: pba.distributed_gn(poses, shards, n_kf, active, cfg, mesh),
                "schur": lambda: pba.schur_gn(poses, shards, n_kf, active, cfg, mesh,
                                              sep_budget=sep_budget)}
        row = {"K": k, "E": n_e, "n_dev": mesh.size}
        out = {}
        for name, fn in runs.items():
            out[name] = fn()[0]
            sync_mesh(mesh)
            t0 = time.perf_counter()
            for _ in range(n_iters):
                fn()
            sync_mesh(mesh)
            row[f"{name}_ms_per_gn_iter"] = ((time.perf_counter() - t0) * 1e3
                                             / (n_iters * cfg.gn_iterations_per_round))
        row["schur_max_abs_diff"] = float((out["schur"] - out["dense"]).abs().max())
        row["schur_within_tol"] = bool(torch.allclose(out["schur"], out["dense"], rtol=rtol,
                                                      atol=atol))
        print("ba_scale:", row, flush=True)
        if not row["schur_within_tol"]:
            raise AssertionError(f"bench_ba_scale: Schur poses off the dense ones at K={k}: "
                                 f"{row['schur_max_abs_diff']:.3e}")
        rows.append(row)
    return rows


def full_step_inputs(n_devices: int, cap: int = 512, n_kf: int = 16, nodes: int = 256,
                     n_labels: int = 8) -> dict:
    """bench_full_step's draws from numpy.random.default_rng(0), in the JAX
    script's order, as numpy arrays (cap trimmed to a multiple of the
    shards)."""
    intr = _vga()
    cap = max(cap, n_devices)
    cap -= cap % n_devices
    rng = np.random.default_rng(0)
    return {"cap": cap,
            "origins": (rng.integers(-8, 8, (cap, 3)) * 0.16).astype(np.float32),
            "points": rng.uniform(-1, 1, (32, 3)).astype(np.float32),
            "depth": rng.uniform(0.5, 3.0, (intr.height, intr.width)).astype(np.float32),
            "rgb": rng.uniform(0, 1, (intr.height, intr.width, 3)).astype(np.float32),
            "unary": rng.uniform(0, 1, (nodes, n_labels)).astype(np.float32),
            "label_kf": rng.integers(0, n_kf, (nodes, n_labels)).astype(np.int32),
            "neighbors": rng.integers(0, nodes, (nodes, 6)).astype(np.int32)}


def bench_full_step(mesh, cap: int = 512, n_iters: int = 10) -> dict:
    """The whole multichip map cycle (make_multichip_full_step: discovery,
    sharded integration, meshing across shards, datacost, MRF, one
    edge-sharded BA round) on the tiny test config at VGA, 16 keyframes, 64
    meshed chunks, a 256-node MRF: {"steps_s", and the last step's
    "n_found", "vcount", "labels", "state"}. Raises when its checks fail."""
    from texturefusion_torch.config import tiny_test_config
    from texturefusion_torch.models.reconstruction import (MultichipFullState,
                                                          make_multichip_full_step)
    from texturefusion_torch.ops import tsdf as tsdf_ops
    from texturefusion_torch.parallel import ba as pba
    from texturefusion_torch.parallel.sharded_tsdf import ShardedRows
    from texturefusion_torch.slam import fastba
    from texturefusion_torch.texture import mrf as mrf_ops
    cfg = tiny_test_config()
    intr = _vga()
    n_kf, mesh_u, nodes = 16, 64, 256
    x = full_step_inputs(mesh.size, cap, n_kf, nodes)
    cap = x["cap"]
    dev0 = mesh.devices[0]

    def dev(a):
        return torch.as_tensor(a, device=dev0)

    step = make_multichip_full_step(mesh, intr, cfg.tsdf, cfg.ba, n_kf, mesh_u)
    edges = fastba.make_edges(max(64, mesh.size), dev0)
    p = dev(x["points"])
    fastba.write_edges(edges, torch.zeros(1, dtype=torch.int64, device=dev0), 0, 1,
                       [s[None] for s in fastba.preintegrate_edge(
                           p, p, torch.ones(32, device=dev0))])
    state = MultichipFullState(
        batch=ShardedRows.from_full(
            mesh, list(tsdf_ops.make_empty_batch(cap, cfg.tsdf.chunk_size ** 3, "cpu"))),
        origins=ShardedRows.from_full(mesh, [torch.as_tensor(x["origins"])]),
        active=ShardedRows.from_full(mesh, [torch.ones(cap, dtype=torch.bool)]),
        datacost=ShardedRows.from_full(mesh, [torch.zeros((cap, n_kf))]),
        poses=torch.eye(4, device=dev0).repeat(n_kf, 1, 1),
        edges=pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh))
    rgb = dev(x["rgb"])
    problem = mrf_ops.MRFProblem(
        unary=dev(x["unary"]), label_kf=dev(x["label_kf"]), neighbors=dev(x["neighbors"]),
        parity=torch.arange(nodes, dtype=torch.int32, device=dev0) % 2,
        init_label=torch.zeros(nodes, dtype=torch.int64, device=dev0),
        n_valid=torch.ones(nodes, dtype=torch.bool, device=dev0))
    args = (dev(x["depth"]), rgb, rgb[..., 0].abs(), torch.eye(4, device=dev0), 1,
            torch.ones(n_kf, dtype=torch.bool, device=dev0),
            torch.arange(mesh_u, dtype=torch.int64, device=dev0) % cap, problem)
    state, n_found, vcount, labels = step(state, *args)
    sync_mesh(mesh)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, n_found, vcount, labels = step(state, *args)
    n_found = int(n_found)      # the host read the JAX script makes
    sync_mesh(mesh)
    rate = n_iters / (time.perf_counter() - t0)
    if not (bool(torch.isfinite(state.poses).all()) and n_found >= 0
            and tuple(vcount.shape) == (mesh_u,) and tuple(labels.shape) == (nodes,)):
        raise AssertionError(f"bench_full_step: n_found {n_found}, vcount {tuple(vcount.shape)}, "
                             f"labels {tuple(labels.shape)} or non-finite poses")
    return {"steps_s": rate, "n_found": n_found, "vcount": vcount, "labels": labels,
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--devices", type=int, default=None)
    group.add_argument("--shards-on-one-card", type=int, default=None)
    args = ap.parse_args(argv)
    one = make_bench_mesh(args.device, devices=1)
    many = make_bench_mesh(args.device, args.devices, args.shards_on_one_card)
    n = many.size
    one_device = len(set(many.devices)) == 1
    head = f"{n} shards, 1 device" if one_device else f"{n} devices"
    print(f"mesh: {many}" + ("; the shards share one device: the rows give the sharding's "
                             "overhead, not scaling" if one_device and n > 1 else ""))
    print(f"{'config':>34s} | {'1 device':>12s} | {head:>24s} | efficiency")
    fps1 = bench_sharded_tsdf(one, args.cap)["steps_s"]
    ba1 = bench_distributed_ba(one)
    full1 = bench_full_step(one)["steps_s"]
    if n > 1:
        fps_n = bench_sharded_tsdf(many, args.cap)["steps_s"]
        ba_n = bench_distributed_ba(many)
        full_n = bench_full_step(many)["steps_s"]
        print(f"{'sharded TSDF integrate (steps/s)':>34s} | {fps1:12.2f} | {fps_n:24.2f} | "
              f"{fps_n / (fps1 * n):.0%} per device")
        print(f"{'distributed BA (GN iters/s)':>34s} | {ba1:12.1f} | {ba_n:24.1f} | "
              f"{ba_n / ba1:.0%} vs 1 device")
        print(f"{'FULL map cycle (steps/s)':>34s} | {full1:12.2f} | {full_n:24.2f} | "
              f"{full_n / full1:.0%} vs 1 device")
    else:
        print(f"{'sharded TSDF integrate (steps/s)':>34s} | {fps1:12.2f} |")
        print(f"{'distributed BA (GN iters/s)':>34s} | {ba1:12.1f} |")
        print(f"{'FULL map cycle (steps/s)':>34s} | {full1:12.2f} |")
        print("single device only: scaling needs several")
    for row in bench_ba_scale(many):
        print(f"{'BA K=' + str(row['K']) + ' (ms a GN iteration)':>34s} | "
              f"dense {row['dense_ms_per_gn_iter']:.3f} | schur {row['schur_ms_per_gn_iter']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
