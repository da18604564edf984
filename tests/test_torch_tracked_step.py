"""frame_step_tracked2, the tracked path's per-frame step, port against JAX.

One tiny packed frame (with depth noise) is tracked against a keyframe
and the previous frame in both packages, with the same RANSAC draws
(fold_in(base_key, frame_idx), split in two, replayed as Gumbel
tensors). The JAX side rebuilds the body of frame_step_tracked2
(models/reconstruction.py:138-159) from its parts with the TPU kernel
`bilateral_filter_pallas` (interpret mode) as the bilateral step: on the
CPU, JAX's own bilateral replicates edges (ROADMAP fault 3.2), while the
port follows the Pallas kernel.

Tolerances: the bundle's depth within 2e-6 m (the bilateral sums run in
another order), gray within 3e-5 (an ulp at 255), rgb exact, normals
1e-4 (a cross product of noisy depth differences), quality 1e-3, blur
score rtol 1e-5; keypoints as in test_torch_features (level 0 identical,
all coordinates 1e-4); both registrations as in test_torch_matching
(success equal, stats 1e-4, ≥ 99% of match slots); the fused keyframe
weight equal on ≥ 99.9% of the pixels and the fused depth within 1e-4 m
wherever the weights agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import tracked2_draws
from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.ops.pallas_kernels import bilateral_filter_pallas
from texturefusion_tpu.slam import features as jf
from texturefusion_tpu.slam import matching as jm
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.models.reconstruction import (frame_step_tracked, frame_step_tracked2,
                                                      track_frame_fused)
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.ops import preprocess as tpre
from texturefusion_torch.utils.convert import keypoints_from_numpy

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
TI = tcam.Intrinsics.from_config(CFG.camera)
SCALE = CFG.camera.depth_scale
FRAME_IDX = 2


def _jax_bundle(packed):
    """preprocess_bundle with the Pallas bilateral filter."""
    p = jnp.asarray(packed)
    depth_raw = (p[..., 0].astype(jnp.float32) + p[..., 1].astype(jnp.float32) * 256.0) / SCALE
    rgb = p[..., 2:5].astype(jnp.float32) / 255.0
    depth = bilateral_filter_pallas(jpre.depth_clamp(depth_raw, JI.near, JI.far))
    normals = jpre.extract_normal_map(depth, JI)
    depth_refined = jpre.refine_depth_with_normals(depth, normals, JI)
    quality = jpre.observation_quality_map(rgb, depth_refined, normals, JI)
    gray = jpre.rgb_to_gray(rgb) * 255.0
    return depth_refined, normals, quality, gray, jpre.laplacian_blurriness(gray), rgb


def _jax_tracked2(packed, kp_ref, kp_prev, kf_depth, kf_weight, base_key, frame_idx, tcfg):
    """The body of frame_step_tracked2 (reconstruction.py:138-159)."""
    k1, k2 = jax.random.split(jax.random.fold_in(base_key, frame_idx))
    bundle = _jax_bundle(packed)
    kp = jf.extract_features(bundle[3], bundle[0], tcfg, JI)
    res_kf = jm.register_frames(kp_ref, kp, k1, tcfg, JI)
    lite = dataclasses.replace(tcfg, ransac_iterations=max(tcfg.ransac_iterations // 4, 64),
                               use_fine_search=False)
    res_ff = jm.register_frames(kp_prev, kp, k2, lite, JI)
    stats2 = jnp.concatenate([res_kf.stats, res_ff.stats, bundle[4].reshape(1)])
    fused, w = jpre.fuse_depth_into_keyframe(kf_depth, kf_weight, bundle[0], res_kf.pose, JI)
    fused = jnp.where(res_kf.success, fused, kf_depth)
    w = jnp.where(res_kf.success, w, kf_weight)
    return bundle, kp, res_kf, res_ff, stats2, fused, w


@pytest.fixture(scope="module")
def steps():
    poses = jsyn.orbit_trajectory(6)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    rng = np.random.default_rng(3)
    packed = []
    for d, c in zip(depths[:FRAME_IDX + 1], rgbs[:FRAME_IDX + 1]):
        dn = np.where(d > 0, d + rng.normal(0, 0.004, d.shape) * np.maximum(d, 0.5), 0.0)
        packed.append(jpre.pack_frame((dn * SCALE).astype(np.uint16), (c * 255).astype(np.uint8)))
    b0, b1 = _jax_bundle(packed[0]), _jax_bundle(packed[1])
    kp_ref = jf.extract_features(b0[3], b0[0], CFG.tracking, JI)
    kp_prev = jf.extract_features(b1[3], b1[0], CFG.tracking, JI)
    kf_depth, kf_weight = b0[0], (b0[0] > 0).astype(jnp.float32)
    base_key = jax.random.PRNGKey(7)
    want = _jax_tracked2(packed[FRAME_IDX], kp_ref, kp_prev, kf_depth, kf_weight, base_key,
                         FRAME_IDX, CFG.tracking)
    cuda_kernels.reset_launch_counts()
    inputs = (torch.tensor(packed[FRAME_IDX]), keypoints_from_numpy(kp_ref, "cpu"),
              torch.tensor(np.asarray(kf_depth)), torch.tensor(np.asarray(kf_weight)))
    draws = tracked2_draws(base_key, FRAME_IDX, CFG.tracking)
    got = frame_step_tracked2(inputs[0], None, inputs[1], keypoints_from_numpy(kp_prev, "cpu"),
                              *inputs[2:], 7, FRAME_IDX, TI, CFG.tracking, SCALE, draws=draws)
    return want, got, inputs, draws


def test_bundle_matches(steps):
    (jb, *_), (tb, *_), *_ = steps
    names = ("depth", "normals", "quality", "gray", "blur", "rgb")
    tols = (2e-6, 1e-4, 1e-3, 3e-5, None, 0.0)
    for name, t, j, atol in zip(names, tb, jb, tols):
        if atol is None:
            assert float(t) == pytest.approx(float(j), rel=1e-5)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0, err_msg=name)
    assert (tb[0] > 0).float().mean() > 0.9


def test_keypoints_match(steps):
    (_, jkp, *_), (_, tkp, *_), *_ = steps
    jkp = keypoints_from_numpy(jkp, "cpu")
    lvl0 = (jkp.level == 0).numpy()
    np.testing.assert_array_equal(tkp.desc.numpy()[lvl0], jkp.desc.numpy()[lvl0])
    np.testing.assert_array_equal(tkp.valid.numpy(), jkp.valid.numpy())
    np.testing.assert_array_equal(tkp.has_depth.numpy(), jkp.has_depth.numpy())
    np.testing.assert_allclose(tkp.uv.numpy(), jkp.uv.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tkp.points3d.numpy(), jkp.points3d.numpy(), atol=1e-4, rtol=0)
    assert int(tkp.valid.sum()) > 100


@pytest.mark.parametrize("which", [2, 3])
def test_registrations_match(steps, which):
    want, got, *_ = steps
    jr, tr = want[which], got[which]
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.success)
    np.testing.assert_allclose(tr.stats.numpy(), np.asarray(jr.stats), atol=1e-4, rtol=1e-4)
    assert (tr.match_idx.numpy() == np.asarray(jr.match_idx)).mean() >= 0.99
    assert (tr.inliers.numpy() == np.asarray(jr.inliers)).mean() >= 0.99


def test_stats2_and_fused_keyframe_match(steps):
    want, got, *_ = steps
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=1e-4, rtol=1e-4)
    assert got[4].shape == (43,)
    jd, jw = np.asarray(want[5]), np.asarray(want[6])
    td, tw = got[5].numpy(), got[6].numpy()
    same_w = tw == jw
    assert same_w.mean() >= 0.999
    np.testing.assert_allclose(td[same_w], jd[same_w], atol=1e-4, rtol=0)
    assert (tw > 1).mean() > 0.5                     # most keyframe pixels were refined


def test_k1_counted_on_the_tracked_step(steps):
    # the CPU tensors took K1's plain version: no kernel launch is counted
    assert cuda_kernels.LAUNCHES["bilateral"] == 0


def test_single_reference_steps_agree_with_tracked2(steps):
    """track_frame_fused and frame_step_tracked are frame_step_tracked2
    without the previous-frame registration: same draws, same results."""
    _, got, (packed, kp_ref, kf_depth, kf_weight), draws = steps
    bundle, kp, res = track_frame_fused(packed, None, kp_ref, draws[0], TI, CFG.tracking, SCALE)
    np.testing.assert_array_equal(res.stats.numpy(), got[2].stats.numpy())
    np.testing.assert_array_equal(kp.desc.numpy(), got[1].desc.numpy())
    out = frame_step_tracked(packed, None, kp_ref, kf_depth, kf_weight, 7, FRAME_IDX, TI,
                             CFG.tracking, SCALE, draws=draws[0])
    np.testing.assert_array_equal(out[2].stats.numpy(), got[2].stats.numpy())
    np.testing.assert_array_equal(out[3].numpy(), got[5].numpy())
    np.testing.assert_array_equal(out[4].numpy(), got[6].numpy())


def test_depth_refinements_match_jax():
    """fuse_depth_into_keyframe and refine_new_frame_from_keyframe on two
    rendered frames at their true relative pose: the agreement masks and
    weights on ≥ 99.9% of the pixels, depths within 1e-4 m elsewhere."""
    poses = jsyn.orbit_trajectory(6)
    depths, _ = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses[:2])
    rel = (np.linalg.inv(poses[0]) @ poses[1]).astype(np.float32)
    w0 = (depths[0] > 0).astype(np.float32)
    jd, jw = jpre.fuse_depth_into_keyframe(jnp.asarray(depths[0]), jnp.asarray(w0),
                                           jnp.asarray(depths[1]), jnp.asarray(rel), JI)
    td, tw = tpre.fuse_depth_into_keyframe(torch.tensor(depths[0]), torch.tensor(w0),
                                           torch.tensor(depths[1]), torch.tensor(rel), TI)
    same = tw.numpy() == np.asarray(jw)
    assert same.mean() >= 0.999 and (tw.numpy() > 1).mean() > 0.5
    np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same], atol=1e-4, rtol=0)
    jn = np.asarray(jpre.refine_new_frame_from_keyframe(jnp.asarray(depths[1]),
                                                        jnp.asarray(depths[0]),
                                                        jnp.asarray(rel), JI))
    tn = tpre.refine_new_frame_from_keyframe(torch.tensor(depths[1]), torch.tensor(depths[0]),
                                             torch.tensor(rel), TI).numpy()
    close = np.abs(tn - jn) <= 1e-4
    assert close.mean() >= 0.999 and (tn > 0).mean() > 0.9
