"""Keyframe and edge capacities that grow (ROADMAP fault h, repaired).

GCSLAM's keyframe-indexed state (the pose array, the descriptor DB and its
row map, the keypoint DB), the fusion side's observation columns and the
edge store start at `ba.max_keyframes` and `ba.max_edges` and double when
a session outgrows them (the STOPWATCH span `kf_grow`). A session that
grows its capacities from 8 keyframes and 32 edges gives what the same
session gives at capacities preset past its needs, bit for bit; with the
JAX package's fixed capacities it would raise at keyframe 8. BA at a
bucket past its initial capacity agrees with the benchmark's float64
reference, tfbench/reference/posegraph.py, within the chip check's
tolerance (chip_smoke.py `[kf-grow]`)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_long_scan import DEFAULT, GROWN, _cell, _frames, _scan
from tfbench.reference import posegraph
from texturefusion_torch.config import BAConfig, PipelineConfig
from texturefusion_torch.slam import fastba, gcslam, loopclosure, promote

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def sessions():
    """(grown, preset): (Outputs, counts) of the long-scan test's tiny
    session at initial capacities of 8 keyframes and 32 edges, and at
    128 and 1,024."""
    c = _cell()
    _, frames = _frames(c)
    return _scan(_cell(GROWN), frames, DEFAULT, "cpu"), _scan(c, frames, DEFAULT, "cpu")


def test_a_grown_session_equals_the_preset_one(sessions):
    """The session passes its initial capacities (a fixed capacity would
    raise at keyframe 8), doubles them at least twice, turns no edge
    away, and gives the preset session's keyframes, loop edges, poses,
    mesh, sampled voxels and textured vertices bit for bit."""
    (grown, g_counts), (preset, p_counts) = sessions
    assert grown.keyframes > 2 * GROWN["max_keyframes"]
    assert g_counts["edges"] > GROWN["max_edges"]
    assert g_counts["kf_grow"] >= 2 and p_counts["kf_grow"] == 0
    assert grown.keyframes == preset.keyframes
    assert g_counts["loop_edges"] == p_counts["loop_edges"] > 0
    assert g_counts["edges"] == p_counts["edges"]
    for name in ("poses", "verts", "vox_pos", "vox_sdf", "tex_verts", "tex_rgb"):
        a, b = getattr(grown, name), getattr(preset, name)
        assert a.shape == b.shape and np.array_equal(a, b), name


def test_a_full_db_raises_and_grows():
    """A DB that is full refuses a row with an IndexError, rather than
    dropping it; grown, it keeps its rows and takes the new one."""
    db = loopclosure.KeyframeDescriptorDB(sub_per_kf=4, max_keyframes=2, device="cpu")
    kp_db = promote.KeypointDB(2, 4, "cpu")
    desc = torch.arange(6 * 8, dtype=torch.int32).reshape(6, 8)
    valid = torch.ones(6, dtype=torch.bool)
    db.add(0, desc, valid)
    db.add(1, desc + 1, valid)
    with pytest.raises(IndexError):
        db.add(2, desc, valid)
    with pytest.raises(IndexError):
        kp_db.add(2, kp_db.kp)
    rows = db.desc.clone()
    db.grow(4)
    kp_db.grow(4)
    db.add(2, desc + 2, valid)
    assert db.desc.shape[0] == 4 and kp_db.kp.uv.shape[0] == 4 and len(db) == 3
    assert torch.equal(db.desc[:2], rows) and not db.valid[3].any()


def _se3(rng, rot_sigma, t_sigma):
    w, t = rng.normal(0, rot_sigma, 3), rng.normal(0, t_sigma, 3)
    m = np.zeros((4, 4))
    m[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    m[:3, 3] = t
    return torch.linalg.matrix_exp(torch.as_tensor(m)).numpy()


def pose_graph(seed: int, n_kf: int = 40, n_loop: int = 60, n_pts: int = 64):
    """A seeded random pose graph of a room loop: (initial poses [K, 4, 4],
    edges [(i, j, float64 sums)]). Keyframes on a 1.5 m circle, the
    initial poses off by ~1 cm and ~0.6 deg; odometry edges and random
    loop edges, each from 64 points 1.5-3.5 m ahead with 4 mm noise and
    5% outliers, Huber-weighted at the initial relative pose."""
    rng = np.random.default_rng(seed)
    true = np.tile(np.eye(4), (n_kf, 1, 1))
    for k in range(n_kf):
        a = 2 * np.pi * k / n_kf
        true[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        true[k, :3, 3] = [1.5 * np.sin(a), 0.05 * np.sin(3 * a), 1.5 * np.cos(a) - 1.5]
    init = np.stack([true[0]] + [true[k] @ _se3(rng, 0.01, 0.02) for k in range(1, n_kf)])
    pairs = [(k, k + 1) for k in range(n_kf - 1)]
    while len(pairs) < n_kf - 1 + n_loop:
        i, j = sorted(int(x) for x in rng.choice(n_kf, 2, replace=False))
        if j - i > 1 and (i, j) not in pairs:
            pairs.append((i, j))
    edges = []
    for i, j in pairs:
        q = rng.uniform(-1, 1, (n_pts, 3)) + [0.0, 0.0, 2.5]
        rel = np.linalg.inv(true[i]) @ true[j]
        p = q @ rel[:3, :3].T + rel[:3, 3] + rng.normal(0, 0.004, (n_pts, 3))
        out = rng.random(n_pts) < 0.05
        p[out] += rng.normal(0, 0.1, (int(out.sum()), 3))
        sums = posegraph.huber_sums(torch.as_tensor(p), torch.as_tensor(q),
                                    torch.ones(n_pts, dtype=torch.bool),
                                    torch.as_tensor(np.linalg.inv(init[i]) @ init[j]), 0.008)
        edges.append((i, j, sums))
    return init, edges


def ba_past_capacity(device, seed: int = 0):
    """GCSLAM's BA (fastba.optimize at its bucket) over a pose graph of 40
    keyframes from initial capacities of 16 keyframes and 32 edges; and
    the reference's BA on the same input, in float64 and in bfloat16.
    Returns (the BA's poses, its valid mask, the reference's poses, its
    valid mask, the bfloat16 reference's poses, the bucket's rows)."""
    cfg = dataclasses.replace(PipelineConfig(), ba=BAConfig(
        max_keyframes=16, max_edges=32, kf_bucket_floor=4, edge_bucket_floor=8))
    init, edges = pose_graph(seed)
    n = len(init)
    slam = gcslam.GCSLAM(cfg, device=device)
    slam.keyframes = [gcslam.KeyframeRecord(frame_index=k, slot=k, origin_index=0)
                      for k in range(n)]
    slam._grow_keyframes(n)
    slam._poses_np[:n] = init.astype(np.float32)
    for i, j, sums in edges:
        slam._append_edge(i, j, [s.float().to(device) for s in sums])
    rows = gcslam._next_bucket(n, cfg.ba.kf_bucket_floor, slam.kf_capacity)
    start = torch.as_tensor(slam._poses_np[:n], device=device)
    given = fastba.EdgeSums(*(a.clone() for a in slam.edges.head(slam.n_edges)))
    slam._run_ba()
    got = torch.as_tensor(slam.poses[:n])
    b = cfg.ba
    kw = dict(rounds=b.gn_rounds, iterations=b.gn_iterations_per_round,
              damping=b.levenberg_lambda, rollback=b.rollback_error_growth)
    active = torch.ones(n, dtype=torch.bool, device=device)
    ref, ref_valid, _ = posegraph.optimize(start, given, active, **kw)
    low, _, _ = posegraph.optimize(start, given, active, dtype=torch.bfloat16, **kw)
    return (got, slam.edges.valid[:slam.n_edges].cpu(), ref.cpu(), ref_valid.cpu(), low.cpu(),
            rows)


def _check_ba(device):
    got, valid, ref, ref_valid, low, rows = ba_past_capacity(device)
    assert rows == 64                      # past the initial capacity of 16
    assert torch.equal(valid, ref_valid) and not bool(valid.all())
    dt, dr = posegraph.pose_errors(got, ref)
    assert dt < posegraph.TOL_M and dr < posegraph.TOL_RAD, (dt, dr)
    low_dt, low_dr = posegraph.pose_errors(low, ref)
    assert low_dt > posegraph.TOL_M or low_dr > posegraph.TOL_RAD, (low_dt, low_dr)


def test_ba_past_its_capacity_agrees_with_the_reference():
    """At 40 keyframes from a capacity of 16 BA runs at the 64-row bucket,
    prunes the edges the reference prunes, and lands within 0.1 mm and
    1e-4 rad of the reference's float64 poses; the reference itself in
    bfloat16 does not."""
    _check_ba("cpu")


@pytest.mark.cuda
def test_ba_past_its_capacity_on_the_card():
    """The same on the card: the BA's rounds captured and replayed at the
    64-row bucket, the reference in float64 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _check_ba("cuda")
