"""The port's texture stage, module by module, against the JAX package.

The same numpy inputs, drawn from seeded generators, go through each JAX
function and its counterpart in texturefusion_torch/texture/ on the CPU.
Tolerances: ICM labels equal, energies within 1e-4 relative; MRF
assembly equal on the real rows (the port does not pad the node count);
transfer matrices within 1e-4 on clusters whose covariance eigenvalues
are at least 1e-3, compensated colours within 2e-3; the packed bilinear
sampler within 1e-6; the texture cycle: projected rows, keyframes,
changed count, bboxes, labels, validity and wrong flags equal, uv16
within 1 (the two packages sum the 3-term projections in different
orders), colour moments rtol 1e-5 / atol 1e-4, transfers within 1e-4;
keyframe stacks equal; the atlas resize within one level of cv2's on at
least 99% of the values; atlas uvs equal; PNG round trips exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda_kernels import port_texture_cycle, texture_cycle_inputs
from test_torch_mesh import _sphere_volume_arrays
from texturefusion_tpu.config import TextureConfig as JTextureConfig
from texturefusion_tpu.config import tiny_test_config as jtiny
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.fusion.chunkmap import TSDFVolume as JVolume
from texturefusion_tpu.fusion.mesher import IncrementalMesher as JMesher
from texturefusion_tpu.texture import color as jcolor
from texturefusion_tpu.texture import mrf as jmrf
from texturefusion_tpu.texture import patch as jpatch
from texturefusion_tpu.texture.atlas import Atlas as JAtlas
from texturefusion_tpu.texture.kfstack import KeyframeStack as JStack
from texturefusion_tpu.texture.manager import TextureManager as JManager
from texturefusion_torch.config import TextureConfig, tiny_test_config
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.fusion.mesher import IncrementalMesher
from texturefusion_torch.io import png
from texturefusion_torch.texture import color as tcolor
from texturefusion_torch.texture import mrf as tmrf
from texturefusion_torch.texture import patch as tpatch
from texturefusion_torch.texture.atlas import Atlas, resize_bilinear
from texturefusion_torch.texture.kfstack import KeyframeStack
from texturefusion_torch.texture.manager import TextureManager
from texturefusion_torch.utils import convert

torch.set_num_threads(2)

CFG = tiny_test_config()


# ----------------------------------------------------------------- MRF


def _grid_problem(seed, n=300, l=8, n_kf=12):
    """n nodes at random cells of a 7³ grid, 6-neighbour lists (index n
    where absent), parity from the coordinates, l label slots of distinct
    keyframe ids (a random tail absent), random unaries and warm start."""
    rng = np.random.default_rng(seed)
    cells = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = cells[rng.permutation(len(cells))[:n]]
    index = {tuple(c): i for i, c in enumerate(coords.tolist())}
    offs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    nbrs = np.asarray([[index.get((x + a, y + b, z + c), n) for a, b, c in offs]
                       for x, y, z in coords.tolist()], np.int32)
    n_labels = rng.integers(1, l + 1, n)
    present = np.arange(l)[None, :] < n_labels[:, None]
    label_kf = np.where(present, np.argsort(rng.random((n, n_kf)), axis=1)[:, :l], -1)
    unary = np.where(present, rng.random((n, l)), 1e9).astype(np.float32)
    init = (rng.random(n) * n_labels).astype(np.int32)
    return dict(unary=unary, label_kf=label_kf.astype(np.int32), neighbors=nbrs,
                parity=(coords.sum(1) & 1).astype(np.int32), init_label=init,
                n_valid=rng.random(n) < 0.95)


def _both_problems(arrs):
    jp = jmrf.MRFProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tp = convert.mrf_problem_from_numpy(**arrs, device="cpu")
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_icm_matches_jax(seed):
    jp, tp = _both_problems(_grid_problem(seed))
    for sweeps in (1, 12):
        jl = np.asarray(jmrf.solve_icm(jp, 1.0, 0.5, sweeps=sweeps))
        tl = tmrf.solve_icm(tp, 1.0, 0.5, sweeps=sweeps)
        np.testing.assert_array_equal(tl.numpy(), jl)
        je = float(jmrf.mrf_energy(jp, jnp.asarray(jl), 1.0, 0.5))
        te = float(tmrf.mrf_energy(tp, tl, 1.0, 0.5))
        assert abs(te - je) <= 1e-4 * abs(je), (te, je)
    e0 = float(tmrf.mrf_energy(tp, tp.init_label, 1.0, 0.5))
    assert te <= e0 + 1e-6 and (tl != tp.init_label).any()


def _chain_problem():
    """tests/test_texture.py's 4-node chain: node 2 slightly prefers
    keyframe B, its neighbours prefer A; Potts smoothing flips it."""
    n, l = 4, 4
    unary = np.full((n, l), 1e9, np.float32)
    label_kf = np.full((n, l), -1, np.int32)
    label_kf[:, 0], label_kf[:, 1] = 10, 20
    unary[:, 0], unary[:, 1] = 0.1, 0.5
    unary[2, 0], unary[2, 1] = 0.5, 0.4
    nbrs = np.full((n, 6), n, np.int32)
    for i in range(n - 1):
        nbrs[i, 0] = i + 1
        nbrs[i + 1, 1] = i
    return dict(unary=unary, label_kf=label_kf, neighbors=nbrs,
                parity=np.arange(n, dtype=np.int32) % 2, init_label=np.zeros(n, np.int32),
                n_valid=np.ones(n, bool))


def test_icm_cases_of_the_jax_tests():
    """test_icm_smooths_labels, test_icm_never_increases_energy and
    test_icm_respects_strong_unary on the port."""
    arrs = _chain_problem()
    _, tp = _both_problems(arrs)
    sol = tmrf.solve_icm(tp, 1.0, 0.5, sweeps=8)
    assert (sol == 0).all(), sol
    assert float(tmrf.mrf_energy(tp, sol, 1.0, 0.5)) <= float(
        tmrf.mrf_energy(tp, tp.init_label, 1.0, 0.5)) + 1e-6
    arrs["unary"][2, 1], arrs["unary"][2, 0] = 0.0, 10.0
    _, tp = _both_problems(arrs)
    assert int(tmrf.solve_icm(tp, 1.0, 0.5, sweeps=8)[2]) == 1


def test_view_selector_matches_jax():
    """test_view_selector_end_to_end on both packages: the same labels and
    warm start."""
    observations = {0: {0: 5.0, 1: 1.0}, 1: {0: 4.0}, 2: {1: 3.0}, 3: {}}
    adjacency = {0: np.asarray([1]), 1: np.asarray([0, 2]), 2: np.asarray([1, 3]),
                 3: np.asarray([2])}
    ids = np.zeros((10, 3), np.int32)
    ids[:4, 0] = np.arange(4)
    tsel = tmrf.ViewSelector(max_labels=4, device="cpu")
    jsel = jmrf.ViewSelector(max_labels=4)
    got = tsel.select(observations, adjacency, ids, newest_kf=3)
    assert got == jsel.select(observations, adjacency, ids, newest_kf=3)
    assert got[0] == 0 and got[1] == 0 and got[2] == 1 and got[3] in (0, 1, 2)
    np.testing.assert_array_equal(tsel.labels, jsel.labels)


@pytest.mark.parametrize("newest_kf", [10, 70])
def test_build_problem_arrays_matches_jax(newest_kf):
    """Random observation table (96 keyframe columns, qualities ≤ 0 and
    ties included), meshed slots, neighbours and warm start: the JAX
    problem's real rows equal the port's, whose neighbour marker is its
    own node count."""
    rng = np.random.default_rng(newest_kf)
    cap, n_kf = 200, 96
    obs_q = np.round(rng.normal(1.0, 1.0, (cap + 1, n_kf)), 1).astype(np.float32)
    obs_mask = rng.random((cap + 1, n_kf)) < 0.2
    obs_mask[:, newest_kf + 1:] = False
    obs_mask[rng.random(cap + 1) < 0.1] = False                 # no observation at all
    meshed = np.sort(rng.permutation(cap)[:90])
    nbr = np.where(rng.random((90, 6)) < 0.5, rng.choice(meshed, (90, 6)), -1)
    ids = rng.integers(-20, 20, (cap, 3)).astype(np.int32)
    warm = np.where(rng.random(cap + 1) < 0.5, rng.integers(0, newest_kf + 1, cap + 1), -1)
    out = []
    for sel in (tmrf.ViewSelector(device="cpu"), jmrf.ViewSelector()):
        sel.ensure_capacity(cap + 1)
        sel.labels[:] = warm
        out.append(sel.build_problem_arrays(obs_q, obs_mask, meshed, nbr, ids, newest_kf))
    (tp, tsl, tkf), (jp, jsl, jkf) = out
    n = len(meshed)
    np.testing.assert_array_equal(tsl, jsl)
    np.testing.assert_array_equal(tkf, jkf[:n])
    assert tp.unary.shape == (n, 16)
    for name in ("unary", "label_kf", "parity", "init_label", "n_valid"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name))[:n], err_msg=name)
    jn = np.asarray(jp.neighbors)[:n]
    np.testing.assert_array_equal(tp.neighbors.numpy(),
                                  np.where(jn == jp.unary.shape[0], n, jn))
    assert (tp.neighbors.numpy() < n).any() and not tp.n_valid.numpy().all()


# ----------------------------------------------------------------- colour


def _clusters(seed, c=6, per=200):
    rng = np.random.default_rng(seed)
    cluster = np.repeat(np.arange(c), per).astype(np.int32)
    rot = np.linalg.qr(rng.normal(size=(c, 3, 3)))[0]
    lam = rng.uniform(1e-3, 0.02, (c, 3))
    cov = (rot * lam[:, None, :]) @ np.swapaxes(rot, 1, 2)
    vox = np.concatenate([rng.multivariate_normal(rng.uniform(0.3, 0.7, 3), cv, per)
                          for cv in cov]).astype(np.float32)
    tex = np.clip(vox * rng.uniform(0.7, 1.3, 3) + rng.normal(0, 0.05, vox.shape) + 0.05,
                  0, 1).astype(np.float32)
    return tex, vox, cluster, rng.random(len(cluster)).astype(np.float32)


def test_transfer_matrices_match_jax():
    tex, vox, cluster, w = _clusters(0)
    c = 6
    jt = [np.asarray(a) for a in jcolor.cluster_stats(jnp.asarray(tex), jnp.asarray(w),
                                                      jnp.asarray(cluster), c)]
    jv = [np.asarray(a) for a in jcolor.cluster_stats(jnp.asarray(vox), jnp.asarray(w),
                                                      jnp.asarray(cluster), c)]
    tt = tcolor.cluster_stats(torch.as_tensor(tex), torch.as_tensor(w), torch.as_tensor(cluster), c)
    tv = tcolor.cluster_stats(torch.as_tensor(vox), torch.as_tensor(w), torch.as_tensor(cluster), c)
    for a, b in zip(tt + tv, jt + jv):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert np.linalg.eigvalsh(jt[1]).min() >= 1e-3 and np.linalg.eigvalsh(jv[1]).min() >= 1e-3
    jm = np.asarray(jcolor.transfer_matrices(*(jnp.asarray(a) for a in (jt + jv))))
    tm = tcolor.transfer_matrices(*(torch.tensor(a) for a in (jt + jv)))
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-4)
    # an empty cluster (0 + εI) is finite on both sides, as the stack's
    # unused keyframe rows are
    z = np.zeros((1, 3, 3), np.float32)
    zt = tcolor.transfer_matrices(None, torch.as_tensor(z), None, torch.as_tensor(z))
    assert torch.isfinite(zt).all()


def test_compensate_matches_jax():
    tex, vox, cluster, w = _clusters(1)
    j = np.asarray(jcolor.compensate(jnp.asarray(tex), jnp.asarray(vox), jnp.asarray(w),
                                     jnp.asarray(cluster), 6))
    t = tcolor.compensate(torch.as_tensor(tex), torch.as_tensor(vox), torch.as_tensor(w),
                          torch.as_tensor(cluster), 6)
    np.testing.assert_allclose(t.numpy(), j, atol=2e-3)


def test_color_compensation_fixes_global_shift():
    """tests/test_texture.py's case on the port."""
    rng = np.random.default_rng(0)
    vox = rng.uniform(0.2, 0.8, (500, 3)).astype(np.float32)
    tex = np.clip(vox * 0.8 + 0.15, 0, 1).astype(np.float32)
    delta = tcolor.compensate(torch.as_tensor(tex), torch.as_tensor(vox), torch.ones(500),
                              torch.zeros(500, dtype=torch.int32), 1).numpy()
    corrected = tex + delta
    np.testing.assert_allclose(corrected.mean(0), vox.mean(0), atol=0.02)
    np.testing.assert_allclose(np.cov(corrected.T), np.cov(vox.T), atol=0.02)


# ----------------------------------------------------------------- patch


def test_bilinear_packed_matches_jax():
    rng = np.random.default_rng(3)
    rgbp = rng.integers(0, 1 << 24, (3, 30, 40)).astype(np.uint32)
    depth = rng.uniform(0.5, 4.0, (3, 30, 40)).astype(np.float32)
    row = rng.integers(0, 3, 7).astype(np.int32)
    uv = rng.uniform(-2.0, 42.0, (7, 50, 2)).astype(np.float32)
    jr, jd = jpatch._bilinear_packed(jnp.asarray(rgbp), jnp.asarray(depth), jnp.asarray(row),
                                     jnp.asarray(uv))
    tr, td, tok = tpatch._bilinear_packed(torch.tensor(rgbp.astype(np.int32)),
                                          torch.tensor(depth), torch.tensor(row),
                                          torch.tensor(uv))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    assert tok.all()


def test_bilinear_depth_skips_holes_fault_10():
    """ROADMAP Queue 3 fault 10: next to a hole (depth 0) the JAX sampler
    interpolates the zero in; the port averages the valid taps, and calls
    the sample ok when they carry more than half the weight."""
    depth = np.full((1, 4, 4), 2.0, np.float32)
    depth[0, 1, 2] = 0.0
    rgbp = np.zeros((1, 4, 4), np.uint32)
    uv = np.asarray([[[1.5, 1.5], [1.9, 1.1], [0.5, 0.5], [1.25, 1.25]]], np.float32)
    row = np.zeros(1, np.int32)
    jd = np.asarray(jpatch._bilinear_packed(jnp.asarray(rgbp), jnp.asarray(depth),
                                            jnp.asarray(row), jnp.asarray(uv))[1])[0]
    _, td, tok = tpatch._bilinear_packed(torch.tensor(rgbp.astype(np.int32)),
                                         torch.tensor(depth), torch.tensor(row), torch.tensor(uv))
    np.testing.assert_allclose(jd, [1.5, 0.38, 2.0, 1.625], rtol=1e-5)
    np.testing.assert_allclose(td.numpy()[0], [2.0, 2.0, 2.0, 2.0], rtol=1e-6)
    np.testing.assert_array_equal(tok.numpy()[0], [True, False, True, True])


@pytest.mark.parametrize("seed,budget", [(0, 16), (1, 64)])
def test_texture_cycle_incremental_matches_jax(seed, budget):
    inputs = texture_cycle_inputs(seed)
    arrs, slot_idx, labels, stats, remeshed, pool, rgbp, depth, poses, intr = inputs
    jl, js, jout = jpatch.texture_cycle_incremental(
        jmrf.MRFProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(slot_idx.astype(np.int32)), jnp.asarray(labels), jnp.asarray(stats),
        jnp.asarray(remeshed), *(jnp.asarray(a) for a in pool), jnp.asarray(rgbp),
        jnp.asarray(depth), jnp.asarray(poses), jnp.int32(1), jcam.Intrinsics(*intr),
        JTextureConfig(), 12, budget)
    jout = [np.asarray(a) for a in jout]
    t, tlabels, tstats = port_texture_cycle(inputs, budget, "cpu")
    names = tpatch.IncrementalCycleOut._fields
    m = min(int(t[2]), budget)
    assert 5 <= m and int(t[2]) == int(jout[2])
    for name in ("proj_rows", "proj_kf", "bbox_min", "bbox_max", "uv_valid", "wrong"):
        i = names.index(name)
        np.testing.assert_array_equal(t[i][:m], jout[i][:m], err_msg=name)
    ok = t[names.index("uv_valid")][:m]
    wrong = t[names.index("wrong")][:m]
    assert ok.any() and wrong.any() and not wrong.all()
    du = np.abs(t[3][:m].astype(np.int64) - jout[3][:m].astype(np.int64))
    assert du[ok].max() <= 1
    np.testing.assert_array_equal(tlabels, np.asarray(jl))
    np.testing.assert_allclose(tstats, np.asarray(js), rtol=1e-5, atol=1e-4)
    for name in ("t_mats", "mean_t", "mean_v"):
        i = names.index(name)
        np.testing.assert_allclose(t[i], jout[i], atol=1e-4, err_msg=name)


def test_wrong_chunks_wait_for_a_new_selection_fault_9():
    """ROADMAP Queue 3 fault 9: a second cycle on the same selection and
    meshes. The JAX package projects every chunk found wrong in the first
    cycle again (it keeps its old label, so it stays changed, though its
    selection did not move); the port projects none of them until its
    selection or its mesh changes."""
    arrs, slot_idx, labels, stats, _, pool, rgbp, depth, poses, intr = texture_cycle_inputs(2)
    no_remesh = np.zeros(len(slot_idx), bool)
    jprob = jmrf.MRFProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
    jl, js = jnp.asarray(labels), jnp.asarray(stats)
    tprob = convert.mrf_problem_from_numpy(**arrs, device="cpu")
    tl, ts = convert.texture_rows_from_numpy(labels, stats, device="cpu")
    tfailed = torch.full_like(tl, -1)
    stack = convert.kf_stack_from_numpy(rgbp, depth, poses, device="cpu")
    tpool = convert.mesh_pool_from_numpy(pool[0], pool[1], pool[1], np.zeros((33, 1, 3)),
                                         pool[2], pool[3], device="cpu")
    changed = []
    for _ in range(2):
        jl, js, jout = jpatch.texture_cycle_incremental(
            jprob, jnp.asarray(slot_idx.astype(np.int32)), jl, js, jnp.asarray(no_remesh),
            *(jnp.asarray(a) for a in pool), jnp.asarray(rgbp), jnp.asarray(depth),
            jnp.asarray(poses), jnp.int32(1), jcam.Intrinsics(*intr), JTextureConfig(), 12, 64)
        tout = tpatch.texture_cycle_incremental(
            tprob, torch.as_tensor(slot_idx), tl, ts, tfailed, torch.as_tensor(no_remesh),
            tpool.verts, tpool.col_packed, tpool.vcount, tpool.tcount, stack.rgb_packed,
            stack.depth, torch.as_tensor(stack.poses), 1, tcam.Intrinsics(*intr),
            TextureConfig(), 12, 64)
        changed.append((int(jout.n_changed), int(tout.n_changed), np.asarray(jout.wrong),
                        np.asarray(jout.proj_rows)))
    (j1, t1, wrong1, rows1), (j2, t2, _, rows2) = changed
    assert j1 == t1 > 0 and wrong1[:j1].sum() >= 2
    wrong_rows = set(rows1[:j1][wrong1[:j1]].tolist())
    assert j2 == len(wrong_rows) and set(rows2[:j2].tolist()) == wrong_rows
    assert t2 == 0
    np.testing.assert_array_equal(tfailed.numpy()[slot_idx[sorted(wrong_rows)]],
                                  np.asarray(jout.proj_kf)[:j2])


def test_keyframe_stack_matches_jax():
    """Rows written at slots 0, 1 and 5 of a stack that starts at 2 rows
    (growth to 8), and a pose refresh: the same packed words, depths,
    poses and capacity."""
    rng = np.random.default_rng(4)
    j, t = JStack(12, 16, initial=2), KeyframeStack(12, 16, initial=2, device="cpu")
    for slot in (0, 1, 5):
        rgb = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
        d = rng.random((12, 16)).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        j.add(slot, jnp.asarray(rgb), jnp.asarray(d), pose)
        t.add(slot, torch.as_tensor(rgb), torch.as_tensor(d), pose)
    for s in (1, 9):
        j.set_pose(s, np.full((4, 4), 2.0, np.float32))
        t.set_pose(s, np.full((4, 4), 2.0, np.float32))
    assert t.cap == j.cap == 8 and t.present == j.present == {0, 1, 5}
    np.testing.assert_array_equal(t.rgb_packed.numpy(), np.asarray(j.rgb_packed).astype(np.int32))
    np.testing.assert_array_equal(t.depth.numpy(), np.asarray(j.depth))
    np.testing.assert_array_equal(t.poses, j.poses)


# ----------------------------------------------------------------- atlas


@pytest.mark.parametrize("shape", [(17, 23), (150, 190), (96, 96), (1, 1), (3, 200)])
def test_resize_matches_cv2(shape):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    img = np.ascontiguousarray(np.cumsum(img, axis=1) % 256, np.uint8)   # some structure
    got = resize_bilinear(img, 96, 96).astype(np.int64)
    want = cv2.resize(img, (96, 96), interpolation=cv2.INTER_LINEAR).astype(np.int64)
    assert (np.abs(got - want) <= 1).mean() >= 0.99


def _patch_calls(seed, n=12):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    calls = []
    for i in range(n):
        lo = rng.uniform(0, 100, 2).round()
        hi = np.minimum(lo + rng.uniform(2, 60, 2).round(), [159, 119])
        calls.append((int(rng.integers(0, 40)), i % 3, lo, hi))
    return rgb, calls


def test_atlas_matches_jax():
    """The same patch calls (new slots, updates of a slot): equal records
    and uvs, images within one level on ≥ 99% of the values (cv2's fixed
    point against the port's float resize)."""
    pytest.importorskip("cv2")
    rgb, calls = _patch_calls(5)
    cfg_t, cfg_j = TextureConfig(atlas_size=1024), JTextureConfig(atlas_size=1024)
    t, j = Atlas(cfg_t, 0.05), JAtlas(cfg_j, 0.05)
    uv = np.random.default_rng(6).uniform(0, 160, (30, 2))
    for slot, kf, lo, hi in calls:
        t.add_or_update_patch(slot, kf, lo, hi, rgb)
        j.add_or_update_patch(slot, kf, lo, hi, rgb)
        np.testing.assert_array_equal(t.atlas_uv(slot, uv), j.atlas_uv(slot, uv))
    assert t.patches.keys() == j.patches.keys() and t.image.shape == j.image.shape
    assert [r.slot_index for r in t.patches.values()] == [r.slot_index for r in j.patches.values()]
    diff = np.abs(t.image.astype(np.int64) - j.image.astype(np.int64))
    assert (diff <= 1).mean() >= 0.99 and diff.max() <= 2


def test_atlas_overflow_and_release():
    """test_atlas_overflow on the port, then release: the slot returns to
    the free list and the next patch takes it."""
    small = TextureConfig(atlas_size=64, patch_scale=1000.0)
    atlas = Atlas(small, 0.05)   # 50 px patches: one slot in a 64 px atlas
    rgb = np.ones((120, 160, 3), np.float32)
    assert atlas.add_or_update_patch(0, 0, np.zeros(2), np.ones(2) * 5, rgb)
    assert atlas.add_or_update_patch(1, 0, np.zeros(2), np.ones(2) * 5, rgb) is None
    assert atlas.overflowed
    atlas.release(0)
    assert 0 not in atlas.patches and atlas.free == [0]
    assert atlas.add_or_update_patch(1, 0, np.zeros(2), np.ones(2) * 5, rgb).slot_index == 0
    assert (atlas.image[:50, :50] == 255).all()


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError):
        png.write_png(path, img.astype(np.float32))


def test_png_reads_in_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(8).integers(0, 256, (20, 31, 3)).astype(np.uint8)
    path = str(tmp_path / "b.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)


def test_sample_atlas_bottom_edge_fault_3_1():
    """ROADMAP Queue 3 fault 1: a uv on the bottom edge of the last
    materialized patch row. The JAX sampler clamps to the full atlas size
    and indexes one row past the image; the port clamps to the rows it
    has and returns that row's colour."""
    jm, tm = JManager(jtiny()), TextureManager(CFG, device="cpu")
    rows = tm.atlas.image.shape[0]
    assert rows == jm.atlas.image.shape[0] < tm.atlas.size
    for m in (jm, tm):
        m.atlas.image[rows - 1] = (10, 200, 30)
    uv = np.asarray([[0.25, 1.0 - (rows - 1) / tm.atlas.size]])
    with pytest.raises(IndexError):
        jm._sample_atlas(uv)
    np.testing.assert_allclose(tm._sample_atlas(uv), [[10 / 255, 200 / 255, 30 / 255]],
                               rtol=1e-6)
    inside = np.asarray([[0.25, 1.0 - (rows - 2.5) / tm.atlas.size]])
    np.testing.assert_array_equal(tm._sample_atlas(inside), jm._sample_atlas(inside))


# ----------------------------------------------------------------- graph


def test_chunk_adjacency_matches_jax():
    """Both packages allocate the sphere volume's 64 chunk ids and mark a
    random half meshed: the same meshed slots and neighbour slots."""
    arrs = _sphere_volume_arrays(2)
    ids = arrs[5][arrs[6]]
    tcfg = tiny_test_config().replace(
        tsdf=tiny_test_config().tsdf.__class__(voxel_resolution=0.05, capacity=96))
    jcfg = jtiny().replace(tsdf=jtiny().tsdf.__class__(voxel_resolution=0.05, capacity=96))
    tvol, jvol = TSDFVolume(tcfg, device="cpu"), JVolume(jcfg)
    np.testing.assert_array_equal(tvol.allocate(ids), jvol.allocate(ids))
    tm, jm = IncrementalMesher(tvol), JMesher(jvol)
    meshed = np.random.default_rng(9).permutation(tvol.active_slots())[:32]
    for m in (tm, jm):
        m.tcount[meshed] = 3
    (ts, tn), (js, jn) = tm.chunk_adjacency_arrays(), jm.chunk_adjacency_arrays()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tn, jn)
    assert (tn >= 0).any() and (tn < 0).any()
    got, want = tm.chunk_adjacency(), jm.chunk_adjacency()
    assert got.keys() == want.keys()
    for s in got:
        np.testing.assert_array_equal(got[s], want[s])
