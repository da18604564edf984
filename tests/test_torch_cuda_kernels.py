"""The CUDA kernels against their plain PyTorch versions, and their bindings.

Tests marked `cuda` need an NVIDIA GPU and skip without one; they import
no jax, so on the GPU machine they run without the repo's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -m cuda

The unmarked tests check, on any machine, what the wrappers refuse, that
the ctypes parameter block matches the C struct, that CPU tensors take
the plain versions, and that the port's entry points default to the card.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig, \
    tiny_test_config
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion.pipeline import TexturedPipeline
from texturefusion_torch.ops import cuda_kernels, preprocess, tsdf

torch.set_num_threads(2)

CONFIG = PipelineConfig(
    camera=CameraConfig(width=128, height=96, fx=100.0, fy=100.0, cx=63.5, cy=47.5,
                        far_plane=6.0),
    tsdf=TSDFConfig(voxel_resolution=0.05, capacity=64, max_update_chunks=16))
# (rtol, atol) of sdf, weight, color, color_count: tests/test_pallas_voxel.py's
ROW_TOL = ((1e-5, 1e-5), (1e-6, 1e-6), (1e-4, 1e-3), (1e-6, 1e-6))

# chunk-id sets of the K2 scenes (extent 0.4 m): the 12 chunks around a
# wall at z = 2 m; chunks at 0-0.8 m before a wall at 0.4 m (the TPU kernel
# clamped chunks this near); chunks from z = -0.4 m to 0.8 m and wider than
# the view before a wall at 0.6 m (behind the camera and partly outside it);
# 2048 chunks from z = -1.6 m to 4.4 m around a wall at 2 m, the default
# config's whole update budget; 72 chunks from z = 1.2 m to 2.4 m around a
# wall at 2 m, most in view (scenes of more than 16 chunks take WIDE_TSDF)
SCENES = {
    "wall": (2.0, [(x, y, 4) for x in range(-2, 2) for y in range(-1, 2)]),
    "near": (0.4, [(x, y, z) for x in range(-1, 1) for y in range(-1, 1) for z in (0, 1)]),
    "behind": (0.6, [(x, y, z) for x in (-3, -1, 0, 2) for y in (-1,) for z in (-1, 0, 1)]),
    "wide": (2.0, [(x, y, z) for x in range(-8, 8) for y in range(-8, 8)
                   for z in range(-4, 12, 2)]),
    "block": (2.0, [(x, y, z) for x in range(-3, 3) for y in range(-2, 2) for z in (3, 4, 5)]),
}
WIDE_TSDF = TSDFConfig(voxel_resolution=0.05, capacity=4096, max_update_chunks=2048)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(seed, pre_integrated, device, scene="wall", n_active=None):
    """Rows, the origins table, idx/active (n_active real lanes first, then
    the trash slot), depth/rgb/quality planes and an identity pose."""
    wall, ids = SCENES[scene]
    cfg = CONFIG.tsdf if len(ids) <= CONFIG.tsdf.max_update_chunks else WIDE_TSDF
    intr = cam.Intrinsics.from_config(CONFIG.camera)
    s1, v, u = cfg.capacity + 1, 512, cfg.max_update_chunks
    rng = np.random.default_rng(seed)
    d = (wall + rng.normal(0, 0.01 * wall, (intr.height, intr.width))).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    rgb = rng.random((intr.height, intr.width, 3)).astype(np.float32)
    q = rng.random((intr.height, intr.width)).astype(np.float32)
    if pre_integrated:
        w = rng.integers(0, 4, (s1, v)).astype(np.float32)
        rows = [rng.normal(0, 0.05, (s1, v)).astype(np.float32), w,
                (rng.random((s1, v, 3)) * 90).astype(np.float32), w.copy()]
    else:
        rows = [np.full((s1, v), 999.0, np.float32), np.zeros((s1, v), np.float32),
                np.zeros((s1, v, 3), np.float32), np.zeros((s1, v), np.float32)]
    ids = np.asarray(ids, np.int32)
    n = len(ids) if n_active is None else n_active
    slots = rng.permutation(cfg.capacity)[:n]
    idx = np.concatenate([slots, np.full(u - n, cfg.capacity)])
    origins = np.zeros((s1, 3), np.float32)
    origins[slots] = ids[:n] * (cfg.chunk_size * cfg.voxel_resolution)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (tsdf.ChunkBatch(*(t(a) for a in rows)), t(origins), t(idx.astype(np.int64)),
            t(np.arange(u) < n), t(d), t(rgb), t(q), torch.eye(4, device=device),
            intr, cfg), n


@pytest.mark.cuda
@pytest.mark.parametrize("radius,shape", [(1, (120, 160)), (4, (120, 160)), (8, (120, 160)),
                                          (4, (479, 641)), (1, (479, 641)), (8, (479, 641))])
def test_bilateral_kernel_matches_plain(cuda_device, radius, shape):
    rng = np.random.default_rng(radius)
    d = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    d[:, shape[1] // 2:] += 1.0
    d[rng.random(d.shape) < 0.05] = 0.0
    x = torch.as_tensor(d, device=cuda_device)
    before = cuda_kernels.LAUNCHES["bilateral"]
    got = preprocess.bilateral_filter(x, radius=radius)
    assert cuda_kernels.LAUNCHES["bilateral"] == before + 1
    ref = preprocess.bilateral_filter_plain(x, radius=radius)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert torch.equal(got == 0, ref == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,n_active,sign,pre,with_color", [
    ("wall", None, 1.0, False, True),      # 12 of 16 lanes, from an empty volume
    ("wall", None, 1.0, True, True),
    ("wall", None, -1.0, True, True),      # de-integration: weights fall to 0 and reset
    ("wall", None, 1.0, True, False),      # depth only: no rgb or quality
    ("wall", 1, 1.0, True, True),          # one active lane
    ("near", None, 1.0, True, True),
    ("behind", None, 1.0, False, True),
    ("behind", None, -1.0, True, True),
    ("wide", None, 1.0, False, True),      # 2048 lanes, from an empty volume
    ("wide", None, 1.0, True, True),
    ("wide", None, -1.0, True, True),
])
def test_tsdf_kernel_matches_plain(cuda_device, scene, n_active, sign, pre, with_color):
    """The kernel takes the real slots only, as TSDFVolume lists them; the
    plain version the padded list with its active flags."""
    args, n = _scene(0, pre, cuda_device, scene, n_active)
    kb, origins, idx, active, d, rgb, q, pose, intr, cfg = args
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    planes = (rgb, q) if with_color else (None, None)
    before = cuda_kernels.LAUNCHES["tsdf_integrate"]
    kq, ku = tsdf.integrate_frame_fused(kb, origins, idx[:n], None, d, *planes, pose, sign,
                                        intr, cfg, with_color=with_color)
    assert cuda_kernels.LAUNCHES["tsdf_integrate"] == before + 1
    pq, pu = tsdf.integrate_frame_fused_plain(pb, origins, idx, active, d, rgb, q, pose, sign,
                                              intr, cfg, with_color=with_color)
    cap = cfg.capacity
    for a, b, (rtol, atol) in zip(kb, pb, ROW_TOL):
        torch.testing.assert_close(a[:cap], b[:cap], rtol=rtol, atol=atol)
    assert kq.shape == ku.shape == (n,)
    torch.testing.assert_close(kq, pq[:n], rtol=1e-4, atol=1e-2)
    assert torch.equal(ku, pu[:n]) and bool(ku.any())
    if sign < 0:
        assert bool((kb.weight[idx[:n]] == 0).any())     # some voxels reset
    if scene == "behind":
        assert bool((kq[:n] < -1e10).any())              # partial / behind chunks flagged


def _frames(seed, n_frames, wall, intr, device, moved=False):
    """n_frames noisy depth planes of a wall and poses within ~1 cm /
    ~0.5 deg of the identity; `moved` draws a second set of poses, 6 mm /
    0.5 deg further (a drift correction)."""
    from texturefusion_torch.core import se3
    rng = np.random.default_rng(seed)
    d = (wall + rng.normal(0, 0.01 * wall, (n_frames, intr.height, intr.width))).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    xi = np.concatenate([rng.normal(0, 0.005, (n_frames, 3)),
                         rng.normal(0, 0.004, (n_frames, 3))], axis=1).astype(np.float32)
    poses = se3.se3_exp(torch.as_tensor(xi))
    if moved:
        poses = poses @ se3.se3_exp(torch.tensor([0.006, 0.0, 0.0, 0.0, 0.0087, 0.0]))
    return torch.as_tensor(d, device=device), poses.contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["wall", "wide"])
@pytest.mark.parametrize("n_frames,pre", [(1, False), (6, False), (6, True), (12, True)])
def test_frames_mode_matches_plain(cuda_device, scene, n_frames, pre):
    """K2's F-frame mode against integrate_depths_batched_plain: F = 1 and
    6 at +1; F = 12 is a drift reintegration, -1 x 6 at one set of poses
    and +1 x 6 at poses moved 6 mm / 0.5 deg. The kernel takes the real
    slots only; the plain version the padded list with its flags. Colour
    rows stay as they were."""
    args, n = _scene(3, pre, cuda_device, scene)
    kb, origins, idx, active, _, _, _, _, intr, cfg = args
    wall = SCENES[scene][0]
    if n_frames == 12:
        d, p_old = _frames(4, 6, wall, intr, cuda_device)
        _, p_new = _frames(4, 6, wall, intr, cuda_device, moved=True)
        depths, poses = torch.cat([d, d]), torch.cat([p_old, p_new])
        signs = [-1.0] * 6 + [1.0] * 6
    else:
        depths, poses = _frames(4, n_frames, wall, intr, cuda_device)
        signs = 1.0
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    colour = [a.clone() for a in (kb.color, kb.color_count)]
    before = cuda_kernels.LAUNCHES["tsdf_integrate_frames"]
    tsdf.integrate_depths_batched(kb, origins, idx[:n], None, depths, poses, signs, intr, cfg)
    assert cuda_kernels.LAUNCHES["tsdf_integrate_frames"] == before + 1
    tsdf.integrate_depths_batched_plain(pb, origins, idx, active, depths, poses, signs, intr,
                                        cfg)
    cap = cfg.capacity
    for a, b, (rtol, atol) in zip(kb, pb, ROW_TOL):
        torch.testing.assert_close(a[:cap], b[:cap], rtol=rtol, atol=atol)
    assert torch.equal(kb.color, colour[0]) and torch.equal(kb.color_count, colour[1])
    assert bool((kb.weight[idx[:n]] != pb.weight.new_tensor(0)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [1, 5, 6, 7, 12, cuda_kernels.MAX_FRAMES])
@pytest.mark.parametrize("mixed,flags", [(False, False), (True, True)])
def test_frames_mode_frame_counts_match_plain(cuda_device, n_frames, mixed, flags):
    """The F-frame mode against integrate_depths_batched_plain on 37 lanes
    (no multiple of a block's voxels or threads) of the "block" scene,
    pre-integrated: 1-64 frames (MAX_FRAMES), odd and even; signs all +1,
    or alternating -1 / +1 (the voxels that fall to w <= min_weight
    reset); the real slots alone, or the padded list with its active flags
    and one real lane turned off."""
    args, n = _scene(7, True, cuda_device, "block", n_active=37)
    kb, origins, idx, active, _, _, _, _, intr, cfg = args
    depths, poses = _frames(8, n_frames, SCENES["block"][0], intr, cuda_device)
    signs = [(-1.0) ** (f + 1) for f in range(n_frames)] if mixed else 1.0
    if flags:
        active[4] = False
        k_idx, k_active = idx, active
    else:
        k_idx, k_active = idx[:n], None
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    w0 = kb.weight.clone()
    before = cuda_kernels.LAUNCHES["tsdf_integrate_frames"]
    tsdf.integrate_depths_batched(kb, origins, k_idx, k_active, depths, poses, signs, intr, cfg)
    assert cuda_kernels.LAUNCHES["tsdf_integrate_frames"] == before + 1
    tsdf.integrate_depths_batched_plain(pb, origins, idx, active, depths, poses, signs, intr,
                                        cfg)
    cap = cfg.capacity
    for a, b, (rtol, atol) in zip(kb, pb, ROW_TOL):
        torch.testing.assert_close(a[:cap], b[:cap], rtol=rtol, atol=atol)
    assert bool((kb.weight != w0).any())
    if flags:
        assert torch.equal(kb.weight[idx[4]], w0[idx[4]])     # the lane turned off


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["wall", "wide"])
def test_reintegrate_kernel_matches_plain(cuda_device, scene):
    """reintegrate_frame_fused: two K2 launches (-1 at the old pose, +1 at
    the new) against the plain one-gather, two-update version."""
    args, n = _scene(5, True, cuda_device, scene)
    kb, origins, idx, active, d, rgb, q, _, intr, cfg = args
    wall = SCENES[scene][0]
    p_old = _frames(6, 1, wall, intr, cuda_device)[1][0]
    p_new = _frames(6, 1, wall, intr, cuda_device, moved=True)[1][0]
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    before = cuda_kernels.LAUNCHES["tsdf_integrate"]
    kq, ku = tsdf.reintegrate_frame_fused(kb, origins, idx[:n], None, d, rgb, q, p_old, p_new,
                                          intr, cfg)
    assert cuda_kernels.LAUNCHES["tsdf_integrate"] == before + 2
    pq, pu = tsdf.reintegrate_frame_fused_plain(pb, origins, idx, active, d, rgb, q, p_old,
                                                p_new, intr, cfg)
    cap = cfg.capacity
    for a, b, (rtol, atol) in zip(kb, pb, ROW_TOL):
        torch.testing.assert_close(a[:cap], b[:cap], rtol=rtol, atol=atol)
    torch.testing.assert_close(kq, pq[:n], rtol=1e-4, atol=1e-2)
    assert torch.equal(ku, pu[:n]) and bool(ku.any())


@pytest.mark.cuda
def test_tsdf_kernel_reads_the_active_flags(cuda_device):
    """A padded slot list with its active flags: a lane whose flag is off,
    real or padding, is left alone and reports nothing."""
    args, n = _scene(2, True, cuda_device)
    kb, origins, idx, active, d, rgb, q, pose, intr, cfg = args
    active[3] = False
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    kq, ku = tsdf.integrate_frame_fused(kb, origins, idx, active, d, rgb, q, pose, 1.0,
                                        intr, cfg)
    pq, pu = tsdf.integrate_frame_fused_plain(pb, origins, idx, active, d, rgb, q, pose, 1.0,
                                              intr, cfg)
    torch.testing.assert_close(kb.sdf[:cfg.capacity], pb.sdf[:cfg.capacity],
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(ku, pu) and not bool(ku[3]) and float(kq[3]) == 0.0
    assert not bool(ku[n:].any()) and bool((kq[n:] == 0).all())


@pytest.mark.cuda
def test_slice_gpu_matches_cpu(cuda_device):
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.io import synthetic
    config = tiny_test_config()
    intr = cam.Intrinsics.from_config(config.camera)
    poses = synthetic.orbit_trajectory(2)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses,
                                             device="cpu")
    vols = []
    for dev in ("cpu", cuda_device):
        vol = TSDFVolume(config, device=dev)
        for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
            dep, _, q, _, _, rgb = preprocess.preprocess_bundle(
                torch.as_tensor(d, device=dev), torch.as_tensor(c, device=dev), intr)
            vol.integrate_frame(dep, rgb, q, p, keyframe_id=i)
        vols.append(vol)
    np.testing.assert_array_equal(vols[0].ids, vols[1].ids)
    s = vols[0].active_slots()
    torch.testing.assert_close(vols[1].batch.weight[s].cpu(), vols[0].batch.weight[s])


def texture_cycle_inputs(seed, s=32, p=64, k=4, h=60, w=80, n=24, holes=0.0):
    """A random mesh pool (S slots, P vertices), a K-keyframe stack at
    h×w and a random problem over n of the slots. Each keyframe sees a
    plane at 2 m in a uniform colour with noise; a chunk's vertices lie
    on the plane (one in three chunks 1.5 m behind it: depth-wrong and
    occluded) with colours near that keyframe's (one in four far off:
    colour-wrong), inside or partly outside the view; `holes` of the
    depth pixels are 0 (the JAX package samples depth next to a hole
    otherwise, ROADMAP Queue 3 fault 10). Packed colours are
    uint32, as the JAX package holds them; `intr` is the Intrinsics
    fields. Shared with tests/test_torch_texture.py."""
    rng = np.random.default_rng(seed)
    intr = (70.0, 70.0, 39.5, 29.5, w, h, 0.01, 6.0)
    base = rng.integers(40, 200, (k, 3))
    img = np.clip(base[:, None, None, :] + rng.integers(-6, 7, (k, h, w, 3)), 0, 255)
    rgbp = (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)).astype(np.uint32)
    depth = (2.0 + rng.normal(0, 0.01, (k, h, w))).astype(np.float32)
    depth[rng.random(depth.shape) < holes] = 0.0
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.02, (k, 3))
    slot_idx = np.sort(rng.permutation(s)[:n]).astype(np.int64)
    kf_of_slot = rng.integers(0, k, s + 1)
    xy = rng.uniform(-1.4, 1.4, (s + 1, 1, 2)) + rng.normal(0, 0.15, (s + 1, p, 2))
    z = np.where(rng.random((s + 1, 1)) < 1 / 3, 3.5, 2.0) + rng.normal(0, 0.005, (s + 1, p))
    verts = np.concatenate([xy, z[..., None]], -1).astype(np.float32)
    far = rng.random(s + 1) < 0.25
    col = np.where(far[:, None, None], 255 - base[kf_of_slot][:, None, :],
                   base[kf_of_slot][:, None, :] + rng.integers(-8, 9, (s + 1, p, 3)))
    col = np.clip(col, 0, 255)
    colpk = (col[..., 0] | (col[..., 1] << 8) | (col[..., 2] << 16)).astype(np.uint32)
    vcount = rng.integers(0, p + 1, s + 1).astype(np.int32)
    vcount[rng.random(s + 1) < 0.1] = 0
    tcount = np.where(vcount > 0, rng.integers(1, 40, s + 1), 0).astype(np.int32)
    l = 4
    label_kf = np.full((n, l), -1, np.int32)
    unary = np.full((n, l), 1e9, np.float32)
    for i, sl in enumerate(slot_idx):
        m = rng.integers(1, l + 1)
        label_kf[i, :m] = np.concatenate([[kf_of_slot[sl]],
                                          rng.permutation([q for q in range(k)
                                                           if q != kf_of_slot[sl]])])[:m]
        unary[i, :m] = np.sort(rng.random(m))
    nbrs = np.full((n, 6), n, np.int32)
    for i in range(n - 1):
        nbrs[i, 0], nbrs[i + 1, 1] = i + 1, i
    arrs = dict(unary=unary, label_kf=label_kf, neighbors=nbrs,
                parity=(np.arange(n) % 2).astype(np.int32), init_label=np.zeros(n, np.int32),
                n_valid=rng.random(n) < 0.9)
    labels = np.where(rng.random(s + 1) < 0.5, rng.integers(0, k, s + 1), -1).astype(np.int32)
    # moments of 20 random colour pairs per slot: well-conditioned clusters
    tex_c, vox_c = rng.uniform(0.2, 0.8, (2, s + 1, 20, 3))
    stats = np.concatenate([
        np.full((s + 1, 1), 20.0), tex_c.sum(1), vox_c.sum(1),
        np.einsum("spc,spd->scd", tex_c, tex_c).reshape(-1, 9),
        np.einsum("spc,spd->scd", vox_c, vox_c).reshape(-1, 9)], axis=1).astype(np.float32)
    pool = (verts, colpk, vcount, tcount)
    return (arrs, slot_idx, labels, stats, rng.random(n) < 0.3, pool, rgbp, depth, poses,
            intr)


def port_texture_cycle(inputs, budget, device):
    """texture_cycle_incremental of the port on texture_cycle_inputs, on
    `device`: (outputs, labels_dev, stats_dev) as numpy."""
    from texturefusion_torch.config import TextureConfig
    from texturefusion_torch.texture import patch
    from texturefusion_torch.utils import convert
    arrs, slot_idx, labels, stats, remeshed, pool, rgbp, depth, poses, intr = inputs
    tlabels, tstats = convert.texture_rows_from_numpy(labels, stats, device=device)
    stack = convert.kf_stack_from_numpy(rgbp, depth, poses, device=device)
    tpool = convert.mesh_pool_from_numpy(pool[0], pool[1], pool[1],
                                         np.zeros((len(pool[0]), 1, 3)), pool[2], pool[3],
                                         device=device)
    out = patch.texture_cycle_incremental(
        convert.mrf_problem_from_numpy(**arrs, device=device),
        torch.as_tensor(slot_idx, device=device), tlabels, tstats, torch.full_like(tlabels, -1),
        torch.as_tensor(remeshed, device=device), tpool.verts, tpool.col_packed, tpool.vcount,
        tpool.tcount, stack.rgb_packed, stack.depth, torch.as_tensor(stack.poses, device=device),
        1, cam.Intrinsics(*intr), TextureConfig(), 12, budget)
    return [a.cpu().numpy() for a in out], tlabels.cpu().numpy(), tstats.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,budget", [(0, 16), (1, 64)])
def test_texture_cycle_gpu_matches_cpu(cuda_device, seed, budget):
    """One texture cycle (ICM, projection, wrong mapping, moments, the
    per-keyframe transfers through cuSOLVER's eigh) on the card against
    the CPU: the same rows, labels and flags, uv16 within 1, moments and
    transfers within 1e-4 (index_add_ sums in another order on the card)."""
    inputs = texture_cycle_inputs(seed, holes=0.03)
    g, gl, gs = port_texture_cycle(inputs, budget, cuda_device)
    c, cl, cs = port_texture_cycle(inputs, budget, "cpu")
    m = min(int(c[2]), budget)
    assert m >= 5 and int(g[2]) == int(c[2])
    for i in (0, 1, 4, 5, 6, 7):        # rows, keyframes, validity, bboxes, wrong
        np.testing.assert_array_equal(g[i][:m], c[i][:m])
    assert np.abs(g[3][:m].astype(np.int64) - c[3][:m])[c[4][:m]].max() <= 1
    np.testing.assert_array_equal(gl, cl)
    np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-4)
    for i in (8, 9, 10):
        np.testing.assert_allclose(g[i], c[i], atol=1e-4)


@pytest.mark.cuda
def test_texture_cycle_is_repeatable_on_the_card(cuda_device):
    """The same cycle twice on the card gives the same bits: the
    per-keyframe moment sums (texture/patch._segment_sum) add in one
    order. Through index_add_'s atomics the colour transfers differed in
    their last bits from call to call."""
    inputs = texture_cycle_inputs(4, s=4096, n=2048)
    (a, al, ast), (b, bl, bst) = (port_texture_cycle(inputs, 384, cuda_device)
                                  for _ in range(2))
    assert int(a[2]) >= 384
    for x, y in zip(a + [al, ast], b + [bl, bst]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", ["tiny", "vga"])
def test_features_gpu_match_cpu_bit_for_bit(cuda_device, camera):
    """A packed frame's grey image and keypoints (levels, validity,
    descriptors) are the same bits on the card as on the CPU
    (core/exact.py). A last-bit difference there flips descriptor bits,
    then matches, then promotions: on the tiny orbit at 14 frames the
    two devices once promoted 5 and 4 keyframes and parted by 57.5 mm."""
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.slam.features import extract_features
    config = tiny_test_config()
    if camera == "vga":
        config = PipelineConfig(camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005))
    intr = cam.Intrinsics.from_config(config.camera)
    poses = synthetic.orbit_trajectory(3)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses,
                                             device="cpu")
    for d, c in zip(depths, rgbs):
        packed = torch.as_tensor(preprocess.pack_frame(
            (d * config.camera.depth_scale).astype(np.uint16), (c * 255).astype(np.uint8)))
        out = []
        for dev in ("cpu", cuda_device):
            b = preprocess.preprocess_bundle(packed.to(dev), None, intr,
                                             depth_scale=config.camera.depth_scale)
            kp = extract_features(b[3], b[0], config.tracking, intr)
            out.append((b[3].cpu(), kp.level.cpu(), kp.valid.cpu(), kp.desc.cpu()))
        for x, y in zip(*out):
            assert torch.equal(x, y)
        assert int(out[0][2].sum()) > 100


def test_wrappers_refuse_cpu_and_wrong_types():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.bilateral_cuda(torch.zeros(8, 8))
    for radius in (-1, cuda_kernels.MAX_RADIUS + 1):
        with pytest.raises(ValueError, match="radius"):
            cuda_kernels.bilateral_cuda(torch.zeros(8, 8), radius=radius)
    with pytest.raises(ValueError, match="float32"):
        cuda_kernels.bilateral_cuda(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        cuda_kernels.bilateral_cuda(torch.zeros(2, 8, 8))

    (kb, origins, idx, active, d, rgb, q, pose, intr, cfg), _ = _scene(0, False, "cpu")

    def call(**change):
        a = dict(origins=origins, idx=idx, active=active, depth=d, rgb=rgb, quality=q,
                 cam_to_world=pose)
        a.update(change)
        return cuda_kernels.tsdf_integrate_cuda(
            *kb, a["idx"], a["active"], a["origins"], a["depth"], a["rgb"], a["quality"],
            a["cam_to_world"], 1.0, intr, cfg)

    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="float32"):
        call(depth=d.double())
    with pytest.raises(ValueError, match="int64"):
        call(idx=idx.int())
    with pytest.raises(ValueError, match="shape"):
        call(origins=origins[:-1])                   # the full table, not a gather
    with pytest.raises(ValueError, match="shape"):
        call(rgb=rgb[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        call(cam_to_world=pose.t())
    with pytest.raises(ValueError, match="required"):
        call(quality=None)
    with pytest.raises(ValueError, match="shape"):
        call(active=active[:-1])                     # one flag a lane


def test_frames_wrapper_refuses_cpu_and_wrong_frames():
    (kb, origins, idx, active, d, _, _, pose, intr, cfg), _ = _scene(0, False, "cpu")
    depths, poses = torch.stack([d, d]), torch.stack([pose, pose])

    def call(depths=depths, poses=poses, signs=(1.0, 1.0), sdf=kb.sdf):
        cuda_kernels.tsdf_integrate_frames_cuda(sdf, kb.weight, idx, active, origins, depths,
                                                poses, signs, intr, cfg)

    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(ValueError, match="frames"):
        call(signs=())
    with pytest.raises(ValueError, match="frames"):
        call(signs=(1.0,) * (cuda_kernels.MAX_FRAMES + 1))
    with pytest.raises(ValueError, match="shape"):
        call(signs=(1.0, 1.0, 1.0))                  # one pose and plane a sign
    with pytest.raises(ValueError, match="shape"):
        call(depths=d[None])
    with pytest.raises(ValueError, match="float32"):
        call(poses=poses.double())
    with pytest.raises(ValueError, match="rows"):
        call(sdf=kb.sdf[:, :256])
    with pytest.raises(ValueError, match="signs"):
        tsdf.integrate_depths_batched(kb, origins, idx, active, depths, poses, [1.0] * 3,
                                      intr, cfg)


def test_cpu_tensors_take_the_plain_lifecycle_passes():
    """reintegrate_frame_fused and integrate_depths_batched on CPU rows
    equal their plain versions and launch nothing."""
    before = dict(cuda_kernels.LAUNCHES)
    (kb, origins, idx, active, d, rgb, q, pose, intr, cfg), _ = _scene(1, True, "cpu")
    pb = tsdf.ChunkBatch(*(a.clone() for a in kb))
    moved = pose.clone()
    moved[0, 3] = 0.01
    got = tsdf.reintegrate_frame_fused(kb, origins, idx, active, d, rgb, q, pose, moved,
                                       intr, cfg)
    want = tsdf.reintegrate_frame_fused_plain(pb, origins, idx, active, d, rgb, q, pose, moved,
                                              intr, cfg)
    depths, poses = torch.stack([d, d]), torch.stack([pose, moved])
    tsdf.integrate_depths_batched(kb, origins, idx, active, depths, poses, [-1.0, 1.0],
                                  intr, cfg)
    tsdf.integrate_depths_batched_plain(pb, origins, idx, active, depths, poses, [-1.0, 1.0],
                                        intr, cfg)
    for a, b in zip(list(kb) + list(got), list(pb) + list(want)):
        assert torch.equal(a, b)
    assert bool(got[1].any())
    assert cuda_kernels.LAUNCHES == before


def _c_struct_fields(name: str):
    """(field, ctype, array length) of `struct name` in tsdf_integrate.cu."""
    with open(os.path.join(os.path.dirname(cuda_kernels.__file__), "..", "csrc",
                           "tsdf_integrate.cu")) as f:
        src = f.read()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    consts = dict((k, int(v)) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src))
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(None, 1)
            for nm in names.split(","):
                m = re.fullmatch(r"(\w+)(?:\[(\w+)\])?", nm.strip())
                n = m.group(2) or "0"
                fields.append((m.group(1), ctype, int(consts.get(n, n))))
    return fields


def test_frame_signs_struct_matches_cuda_source():
    ctypes_map = {"float": "c_float", "int": "c_int"}
    want = []
    for name, t in cuda_kernels.FrameSigns._fields_:
        n = getattr(t, "_length_", 0)
        want.append((name, (t._type_ if n else t).__name__, n))
    assert [(n, ctypes_map[t], k) for n, t, k in _c_struct_fields("FrameSigns")] == want
    assert want[1][2] == cuda_kernels.MAX_FRAMES


def test_params_struct_matches_cuda_source():
    with open(os.path.join(os.path.dirname(cuda_kernels.__file__), "..", "csrc",
                           "tsdf_integrate.cu")) as f:
        src = f.read()
    body = re.search(r"struct TsdfParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype, names = decl.split(None, 1)
            for name in names.split(","):
                m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", name.strip())
                fields.append((m.group(1), ctype, int(m.group(2) or 0)))
    ctypes_map = {"float": "c_float", "int": "c_int"}
    want = []
    for name, t in cuda_kernels.TsdfParams._fields_:
        n = getattr(t, "_length_", 0)
        want.append((name, (t._type_ if n else t).__name__, n))
    assert [(n, ctypes_map[t], k) for n, t, k in fields] == want


def test_cpu_tensors_take_the_plain_path():
    before = dict(cuda_kernels.LAUNCHES)
    x = torch.rand(16, 16) + 1.0
    torch.testing.assert_close(preprocess.bilateral_filter(x),
                               preprocess.bilateral_filter_plain(x))
    (kb, *args), _ = _scene(1, True, "cpu")
    tsdf.integrate_frame_fused(kb, *args[:6], args[6], 1.0, *args[7:])
    assert cuda_kernels.LAUNCHES == before


def test_entry_points_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU; the helpers below them take no default device."""
    from texturefusion_torch.core import camera, se3
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops import marching_cubes
    from texturefusion_torch.slam import fastba, gcslam, loopclosure, promote
    from texturefusion_torch.texture import kfstack, manager, mrf
    from texturefusion_torch.utils import convert

    def default(fn):
        return inspect.signature(fn).parameters["device"].default

    for fn in (TSDFVolume, gcslam.GCSLAM, synthetic.render_sequence,
               convert.volume_state_from_numpy, convert.keypoints_from_numpy,
               convert.edges_from_numpy, convert.poses_from_numpy,
               convert.descriptor_db_from_numpy, convert.mesh_pool_from_numpy,
               TexturedPipeline, manager.TextureManager, convert.mrf_problem_from_numpy,
               convert.kf_stack_from_numpy, convert.texture_rows_from_numpy):
        assert default(fn) == "cuda", fn
    for fn in (se3.identity, camera.pixel_grid, tsdf.make_empty_batch,
               marching_cubes.make_mesh_pool, promote.KeypointDB,
               loopclosure.KeyframeDescriptorDB, fastba.make_edges,
               kfstack.KeyframeStack, mrf.ViewSelector):
        assert default(fn) is inspect.Parameter.empty, fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            TSDFVolume(tiny_test_config())
