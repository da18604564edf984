"""Loop-closure scoring and the promotion probe, port against JAX.

Keyframe descriptor DB rows (host permutation + stable valid-first
partition) are identical. Similarities agree to rtol 1e-5 (the sums over
the query run in another order), salient scores to 1e-5, and the
selected candidate rows are the same. promote_probe with the JAX draws
injected: same candidate slots and admission flags, stats within 1e-4,
edge sums within rtol 1e-4, match indices on ≥ 99% of the slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_draws import batch_draws
from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as jcam
from texturefusion_tpu.io import synthetic as jsyn
from texturefusion_tpu.ops import preprocess as jpre
from texturefusion_tpu.slam import features as jf
from texturefusion_tpu.slam import loopclosure as jlc
from texturefusion_tpu.slam import matching as jm
from texturefusion_tpu.slam import promote as jpr
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.slam import loopclosure as tlc
from texturefusion_torch.slam import promote as tpr
from texturefusion_torch.utils.convert import descriptor_db_from_numpy, keypoints_from_numpy

torch.set_num_threads(2)

CFG = tiny_test_config()
JI = jcam.Intrinsics.from_config(CFG.camera)
TI = tcam.Intrinsics.from_config(CFG.camera)
MAX_KF = 8
KF_FRAMES = (0, 2, 4, 6, 8, 10)
QUERY = 11


@pytest.fixture(scope="module")
def state():
    poses = jsyn.loop_trajectory(12, radius=0.6)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    jkp = [jf.extract_features(jpre.rgb_to_gray(jnp.asarray(c)) * 255.0, jnp.asarray(d),
                               CFG.tracking, JI) for d, c in zip(depths, rgbs)]
    tkp = [keypoints_from_numpy(k, "cpu") for k in jkp]
    jdb = jlc.KeyframeDescriptorDB(max_keyframes=MAX_KF)
    tdb = tlc.KeyframeDescriptorDB(max_keyframes=MAX_KF, device="cpu")
    jkdb = jpr.KeypointDB(MAX_KF, CFG.tracking.max_features_pad)
    tkdb = tpr.KeypointDB(MAX_KF, CFG.tracking.max_features_pad, "cpu")
    for slot, f in enumerate(KF_FRAMES):
        jdb.add(slot, jkp[f].desc, jkp[f].valid)
        tdb.add(slot, tkp[f].desc, tkp[f].valid)
        jkdb.add(slot, jkp[f])
        tkdb.add(slot, tkp[f])
    return jkp, tkp, jdb, tdb, jkdb, tkdb


def test_db_rows_identical(state):
    _, _, jdb, tdb, _, _ = state
    np.testing.assert_array_equal(tdb.desc.numpy(), np.asarray(jdb.desc).view(np.int32))
    np.testing.assert_array_equal(tdb.valid.numpy(), np.asarray(jdb.valid))
    assert tdb.kf_ids == jdb.kf_ids and tdb.valid[:len(KF_FRAMES)].any(1).all()
    db = descriptor_db_from_numpy(jdb.desc, jdb.valid, jdb.kf_ids, device="cpu")
    assert torch.equal(db.desc, tdb.desc) and db.kf_ids == tdb.kf_ids


@pytest.mark.parametrize("query", [QUERY, 3])
def test_similarity_and_candidates(state, query):
    jkp, tkp, jdb, tdb, _, _ = state
    want = jdb.similarity(jkp[query].desc, jkp[query].valid)
    got = tdb.similarity(tkp[query].desc, tkp[query].valid)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.max() > 0
    for thr in (1.5, 0.5):
        assert (tlc.select_candidates(got, thr, 5) == jlc.select_candidates(want, thr, 5))


def test_similarity_chunking_changes_nothing(state, monkeypatch):
    _, tkp, _, tdb, _, _ = state
    whole = tdb.similarity(tkp[QUERY].desc, tkp[QUERY].valid)
    monkeypatch.setattr(tlc, "_ROW_CHUNK_ELEMS", 1)            # one row per chunk
    np.testing.assert_array_equal(tdb.similarity(tkp[QUERY].desc, tkp[QUERY].valid), whole)


def test_salient_scores_match_jax():
    rng = np.random.default_rng(3)
    for n_rows in (0, 1, 2, 5, 12):
        sims = np.zeros(16, np.float32)
        sims[:n_rows] = rng.uniform(0, 10, n_rows)
        sims[max(n_rows - 3, 0):n_rows] += 8.0                  # a recent above-average run
        in_use = np.arange(16) < n_rows
        want = np.asarray(jpr.salient_scores(jnp.asarray(sims), jnp.asarray(in_use),
                                             jnp.int32(n_rows)))
        got = tpr.salient_scores(torch.as_tensor(sims), torch.as_tensor(in_use), n_rows)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("have_tracked", [False, True])
def test_promote_probe_matches_jax(state, have_tracked):
    jkp, tkp, jdb, tdb, jkdb, tkdb = state
    n_rows, last_slot, n_cand = len(KF_FRAMES), len(KF_FRAMES) - 1, 5
    r2s = np.full(MAX_KF, -1, np.int32)
    r2s[:n_rows] = np.arange(n_rows)
    key = jax.random.PRNGKey(11)
    tracked = np.zeros(21, np.float32)
    if have_tracked:
        tracked = np.asarray(jm.register_frames(jkp[KF_FRAMES[-1]], jkp[QUERY],
                                                jax.random.PRNGKey(1), CFG.tracking, JI).stats)
    args = (CFG.tracking.salient_score_threshold, CFG.ba.huber_delta, CFG.tracking)
    jp = jpr.promote_probe(jkdb.kp, jdb.desc, jdb.valid, jnp.asarray(r2s), jnp.int32(n_rows),
                           jnp.int32(last_slot), jkp[QUERY], jnp.asarray(tracked),
                           jnp.asarray(have_tracked), key, *args, JI, n_cand)
    tp = tpr.promote_probe(tkdb.kp, tdb.desc, tdb.valid, torch.as_tensor(r2s).long(), n_rows,
                           last_slot, tkp[QUERY], torch.tensor(tracked), have_tracked,
                           batch_draws(key, n_cand, CFG.tracking, CFG.tracking.max_features_pad),
                           *args, TI, n_cand)
    np.testing.assert_array_equal(tp.cand_slots.numpy(), np.asarray(jp.cand_slots))
    np.testing.assert_array_equal(tp.cand_ok.numpy(), np.asarray(jp.cand_ok))
    assert tp.cand_ok[1:].any()                      # a loop-closure candidate is admitted
    np.testing.assert_allclose(tp.stats.numpy(), np.asarray(jp.stats), atol=1e-4, rtol=1e-4)
    for name in ("s_w", "s_p", "s_q", "s_pp", "s_qq", "s_pq"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert (tp.midx.numpy() == np.asarray(jp.midx)).mean() >= 0.99
    np.testing.assert_allclose(tp.fetch.numpy(), np.asarray(jp.fetch), atol=1e-4, rtol=1e-4)
