"""Two-view registration and ICP, port against JAX.

Both packages register the same JAX-extracted keypoints with the same
RANSAC draws (the JAX key path replayed as Gumbel tensors). Tolerances:
`success` and the round-1 match indices are identical; pose and stats
within 1e-4; the final match indices and inlier masks agree on ≥ 99% of
the slots (a 3×3 SVD that differs by an ulp may flip a point sitting on
a threshold). kabsch and refine_pose_gn within 1e-5; both filters exact.
ICP: pose within 1e-4, inlier count within 1% , correspondences 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import batch_draws, round_draws
from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.core import se3 as jse3
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import hamming as jham
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.slam import features as jf
from texturefusion_tpu.slam import icp as jicp
from texturefusion_tpu.slam import matching as jm
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.ops import hamming as tham
from texturefusion_torch.ops import preprocess as tpre
from texturefusion_torch.slam import icp as ticp
from texturefusion_torch.slam import matching as tm
from texturefusion_torch.utils.convert import keypoints_from_numpy

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
TI = tcam.Intrinsics.from_config(CFG.camera)
K = CFG.tracking.max_features_pad


@pytest.fixture(scope="module")
def seq():
    poses = jsyn.orbit_trajectory(4)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    jkp = [jf.extract_features(jpre.rgb_to_gray(jnp.asarray(c)) * 255.0, jnp.asarray(d),
                               CFG.tracking, JI) for d, c in zip(depths[:3], rgbs[:3])]
    return poses, depths, jkp, [keypoints_from_numpy(k, "cpu") for k in jkp]


@pytest.mark.parametrize("ref,src,seed", [(0, 1, 0), (0, 2, 1), (1, 1, 2)])
def test_register_frames_matches_jax(seq, ref, src, seed):
    _, _, jkp, tkp = seq
    key = jax.random.PRNGKey(seed)
    jr = jm.register_frames(jkp[ref], jkp[src], key, CFG.tracking, JI)
    tr = tm.register_frames(tkp[ref], tkp[src], round_draws(key, CFG.tracking, K),
                            CFG.tracking, TI)
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.success)
    # round 1: appearance-only matching
    ks, kr = jkp[src], jkp[ref]
    j1 = jham.match_descriptors(ks.desc, ks.valid & ks.has_depth, kr.desc,
                                kr.valid & kr.has_depth, CFG.tracking.hamming_threshold)
    ts, trf = tkp[src], tkp[ref]
    t1 = tham.match_descriptors(ts.desc, ts.valid & ts.has_depth, trf.desc,
                                trf.valid & trf.has_depth, CFG.tracking.hamming_threshold)
    np.testing.assert_array_equal(t1[0].numpy(), np.asarray(j1[0]))
    np.testing.assert_array_equal(t1[2].numpy(), np.asarray(j1[2]))
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tr.stats.numpy(), np.asarray(jr.stats), atol=1e-4, rtol=1e-4)
    assert (tr.match_idx.numpy() == np.asarray(jr.match_idx)).mean() >= 0.99
    assert (tr.inliers.numpy() == np.asarray(jr.inliers)).mean() >= 0.99


def test_register_frames_recovers_gt(seq):
    poses, _, _, tkp = seq
    gen = torch.Generator().manual_seed(0)
    res = tm.register_frames(tkp[0], tkp[1], tm.ransac_draws(CFG.tracking, K, gen),
                             CFG.tracking, TI)
    assert bool(res.success)
    t_gt = np.linalg.inv(poses[0]) @ poses[1]
    delta = np.asarray(jse3.se3_log(jnp.asarray(np.linalg.inv(res.pose.numpy()) @ t_gt)))
    assert np.linalg.norm(delta[:3]) < 0.02 and np.linalg.norm(delta[3:]) < 0.02


def test_register_frames_batch_matches_jax(seq):
    _, _, jkp, tkp = seq
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, 2)
    jr = jm.register_frames_batch(jm.stack_keypoints([jkp[0], jkp[2]]), jkp[1], keys,
                                  CFG.tracking, JI)
    draws = torch.stack([round_draws(k, CFG.tracking, K) for k in keys])
    tr = tm.register_frames_batch(tm.stack_keypoints([tkp[0], tkp[2]]), tkp[1], draws,
                                  CFG.tracking, TI)
    np.testing.assert_array_equal(tr.success.numpy(), np.asarray(jr.success))
    np.testing.assert_allclose(tr.stats.numpy(), np.asarray(jr.stats), atol=1e-4, rtol=1e-4)
    assert torch.equal(batch_draws(key, 2, CFG.tracking, K), draws)


def test_kabsch_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    t_true = jse3.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.2, -0.1, 0.15], jnp.float32))
    p = np.array(jse3.transform_points(t_true, jnp.asarray(q)))
    p_noisy = p + rng.normal(0, 0.01, p.shape).astype(np.float32)
    w = rng.random(50).astype(np.float32)
    for pp in (p, p_noisy):
        want = np.asarray(jm.kabsch(jnp.asarray(pp), jnp.asarray(q), jnp.asarray(w)))
        got = tm.kabsch(torch.as_tensor(pp), torch.as_tensor(q), torch.as_tensor(w)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    got = tm.kabsch(torch.as_tensor(p), torch.as_tensor(q), torch.ones(50)).numpy()
    np.testing.assert_allclose(got, np.asarray(t_true), atol=1e-5)


def test_refine_pose_gn_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    t_true = jse3.se3_exp(jnp.asarray([0.05, 0.02, -0.03, 0.1, 0.05, -0.08], jnp.float32))
    p = np.asarray(jse3.transform_points(t_true, jnp.asarray(q))).copy()
    p[:10] += rng.uniform(0.5, 1.0, (10, 3))
    p = (p + rng.normal(0, 0.001, p.shape)).astype(np.float32)
    want = np.asarray(jm.refine_pose_gn(jse3.identity(), jnp.asarray(p), jnp.asarray(q),
                                        jnp.ones(100), 10, 0.008))
    got = tm.refine_pose_gn(torch.eye(4), torch.as_tensor(p), torch.as_tensor(q),
                            torch.ones(100), 10, 0.008).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(t_true), atol=2e-3)


def test_filters_match_jax():
    rng = np.random.default_rng(6)
    n = 120
    ok = rng.random(n) < 0.8
    a_src = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    a_ref = (a_src + rng.normal(0.3, 0.2, n)).astype(np.float32)
    a_ref[:30] = rng.uniform(-np.pi, np.pi, 30)
    want = np.asarray(jm._rotation_histogram_filter(jnp.asarray(ok), jnp.asarray(a_src),
                                                    jnp.asarray(a_ref)))
    got = tm._rotation_histogram_filter(torch.as_tensor(ok), torch.as_tensor(a_src),
                                        torch.as_tensor(a_ref)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < ok.sum()

    q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    q[:, 2] += 3.0
    p = q @ np.asarray(jse3.so3_exp(jnp.asarray([0.0, 0.2, 0.0]))).T.astype(np.float32)
    p = (p + np.float32(0.1)).astype(np.float32)
    p[:25] += rng.uniform(-0.5, 0.5, (25, 3)).astype(np.float32)
    want = np.asarray(jm._distance_consistency_filter(jnp.asarray(ok), jnp.asarray(p),
                                                      jnp.asarray(q)))
    got = tm._distance_consistency_filter(torch.as_tensor(ok), torch.as_tensor(p),
                                          torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < ok.sum()


def test_icp_matches_jax(seq):
    poses, depths, _, _ = seq
    d0, d1 = depths[0], depths[1]
    t_gt = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    init = np.asarray(jse3.compose(jnp.asarray(t_gt), jse3.se3_exp(
        jnp.asarray([0.01, -0.01, 0.02, 0.01, -0.005, 0.01], jnp.float32))))
    jn = jpre.extract_normal_map(jnp.asarray(d0), JI)
    tn = tpre.extract_normal_map(torch.as_tensor(d0), TI)
    jr = jicp.icp_refine(jnp.asarray(d0), jn, jnp.asarray(d1), jnp.asarray(init), JI,
                         stride=2, iters=12)
    tr = ticp.icp_refine(torch.as_tensor(d0), tn, torch.as_tensor(d1), torch.as_tensor(init),
                         TI, stride=2, iters=12)
    assert bool(tr.success) == bool(jr.success)
    np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), atol=1e-4, rtol=0)
    assert abs(int(tr.n_inliers) - int(jr.n_inliers)) <= 0.01 * int(jr.n_inliers)
    jp, jq, jw = jicp.icp_correspondences(jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(t_gt),
                                          JI, stride=4)
    tp, tq, tw = ticp.icp_correspondences(torch.as_tensor(d0), torch.as_tensor(d1),
                                          torch.as_tensor(t_gt), TI, stride=4)
    for a, b in ((tp, jp), (tq, jq), (tw, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    assert float(tw.sum()) > 100
