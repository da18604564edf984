"""Keyframe-promotion probe: candidate selection, registration, edge sums.

Port of texturefusion_tpu/slam/promote.py (ref: GCSLAM/GCSLAM.cpp:52-185
update_keyframe, :6-50 candidate selection, BayesianFilter.hpp:31-91;
MultiViewGeometry.h:245-311 Huber pre-integration): similarity over the
keyframe descriptor DB → salient-score top-k rows → registration of the
new frame against each candidate's stacked keypoints → Huber edge sums.
The JAX package vmaps the candidates; here they are a loop over C ≤ 6.
The top-k breaks ties by the lowest index, as jax.lax.top_k does. The
JAX probe is one jitted program; `PROBE_PROGRAMS` is its counterpart on
the card, one captured CUDA graph (utils/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from texturefusion_torch.config import TrackingConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import hamming
from texturefusion_torch.slam import fastba
from texturefusion_torch.slam.features import Keypoints
from texturefusion_torch.slam.loopclosure import similarity_rows
from texturefusion_torch.slam.matching import register_frames, stack_results
from texturefusion_torch.utils import graphs
from texturefusion_torch.utils.capacity import grown


class KeypointDB:
    """Stacked keypoints of every keyframe, indexed by keyframe SLOT
    ([max_kf, pad, ...] tensors on the device; `grow` adds rows)."""

    def __init__(self, max_kf: int, pad: int, device):
        self.max_kf = max_kf
        z = lambda *s, dtype=torch.float32: torch.zeros((max_kf, pad) + s, dtype=dtype,  # noqa: E731
                                                        device=device)
        self.kp = Keypoints(uv=z(2), response=z(), angle=z(), level=z(dtype=torch.int32),
                            desc=z(hamming.WORDS, dtype=torch.int32),
                            valid=z(dtype=torch.bool), points3d=z(3),
                            has_depth=z(dtype=torch.bool))

    def grow(self, capacity: int) -> None:
        """Hold `capacity` slots; the new ones zero."""
        self.kp = Keypoints(*(grown(a, capacity) for a in self.kp))
        self.max_kf = capacity

    def add(self, slot: int, kp: Keypoints) -> None:
        for dst, src in zip(self.kp, kp):
            dst[slot] = src


def _device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor on `device`: a tensor as it is (cast), a Python value
    filled on the device (no copy from host memory)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def salient_scores(sims: torch.Tensor, in_use: torch.Tensor, n_rows) -> torch.Tensor:
    """The reference's salient score (ref: BayesianFilter.hpp:31-91): the
    trailing run of recent rows at or above the average is left out of
    the historical mean/σ; (sim − σ)/μ; 3 when every row is above the
    average, 1 when the history is too short. n_rows: a 0-d tensor (or a
    Python int), read on the device."""
    r_max = sims.shape[0]
    idxs = torch.arange(r_max, device=sims.device)
    nr = torch.clamp(_device_scalar(n_rows, torch.int64, sims.device), min=1).to(torch.float32)
    avg = torch.sum(sims) / nr
    below = in_use & (sims < avg)
    history_loop = torch.amax(torch.where(below, idxs, -1))
    hist = in_use & (idxs < history_loop)
    n_hist = torch.sum(hist).to(torch.float32)
    mean_hist = torch.sum(torch.where(hist, sims, 0.0)) / torch.clamp(n_hist, min=1.0)
    var = torch.sum(torch.where(hist, (sims - mean_hist) ** 2, 0.0))
    delta = torch.sqrt(var) / torch.clamp(torch.sqrt(n_hist - 1.0), min=1.0)
    scores = (sims - delta) / torch.clamp(mean_hist, min=1e-8)
    scores = torch.where((mean_hist < 1e-8) | (n_hist < 3), torch.ones_like(scores), scores)
    return torch.where(history_loop <= 0, torch.full_like(scores, 3.0), scores)


class PromoteProbe(NamedTuple):
    cand_slots: torch.Tensor   # [C] keyframe slots probed
    cand_ok: torch.Tensor      # [C] bool: candidate admissible & success
    stats: torch.Tensor        # [C, 21] per-candidate TwoViewResult.stats
    s_w: torch.Tensor          # [C] edge pre-integration sums...
    s_p: torch.Tensor          # [C, 3]
    s_q: torch.Tensor          # [C, 3]
    s_pp: torch.Tensor         # [C, 3, 3]
    s_qq: torch.Tensor         # [C, 3, 3]
    s_pq: torch.Tensor         # [C, 3, 3]
    midx: torch.Tensor         # [C, P] per-candidate match indices
    minl: torch.Tensor         # [C, P] per-candidate inlier weights
    fetch: torch.Tensor        # [C·25] flat (slot, ok, stats[21], sim, salient)


def promote_probe(db_kp: Keypoints, db_desc: torch.Tensor, db_desc_valid: torch.Tensor,
                  row_to_slot: torch.Tensor, n_rows, last_slot, kp_new: Keypoints,
                  tracked_stats: torch.Tensor, have_tracked, gumbel_draws: torch.Tensor,
                  salient_threshold: float, huber_delta: float, cfg: TrackingConfig,
                  intr: cam.Intrinsics, n_cand: int) -> PromoteProbe:
    """Candidate selection + registration + edge pre-integration. Candidate 0
    is always the last keyframe; rows whose salient score is at or below
    the threshold are admitted only on a 3× inlier margin.
    n_rows (rows in use), last_slot and have_tracked are 0-d tensors read
    on the device, as the JAX program takes them (Python values are filled
    on the device); gumbel_draws: [n_cand, R, H, 4, K], one per candidate.
    The similarity is scored over all R rows of the DB and masked to the
    rows in use, so nothing here depends on the data's values on the host."""
    dev = db_desc.device
    r_max = db_desc.shape[0]
    n_rows = _device_scalar(n_rows, torch.int64, dev)
    last_slot = _device_scalar(last_slot, row_to_slot.dtype, dev)
    have_tracked = _device_scalar(have_tracked, torch.bool, dev)
    in_use = torch.arange(r_max, device=dev) < n_rows
    sims = similarity_rows(kp_new.desc, kp_new.valid, db_desc, db_desc_valid, r_max)
    sims = torch.where(in_use, sims, 0.0)
    salient = salient_scores(sims, in_use, n_rows)
    rank_sims = torch.where(in_use & (row_to_slot != last_slot), sims, -1.0)
    top_sims, top_rows = torch.sort(rank_sims, descending=True, stable=True)
    top_sims, top_rows = top_sims[:n_cand - 1], top_rows[:n_cand - 1]
    exists = top_sims > 0.0
    salient_ok = salient[top_rows] > salient_threshold
    cand_slots = torch.cat([last_slot.reshape(1), row_to_slot[top_rows]])
    # an unused row maps to slot −1, which indexes the last row as in JAX
    # (such a candidate has no similarity and is never admitted)
    slots_l = torch.remainder(cand_slots.long(), db_kp.uv.shape[0])
    kp_c = Keypoints(*(a[slots_l] for a in db_kp))
    res = stack_results([
        register_frames(Keypoints(*(a[c] for a in kp_c)), kp_new, gumbel_draws[c], cfg, intr)
        for c in range(n_cand)])
    # candidate 0: the frame step already registered vs the last keyframe
    stats = res.stats.clone()
    stats[0] = torch.where(have_tracked, tracked_stats, stats[0])
    strong = stats[:, 1] >= 3.0 * cfg.min_matches
    admissible = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            exists & (salient_ok | strong[1:])])
    ok = admissible & (stats[:, 0] > 0.5)
    pose = stats[:, 5:21].reshape(-1, 4, 4)
    p = torch.stack([kp_c.points3d[c][res.match_idx[c]] for c in range(n_cand)])
    q = kp_new.points3d.expand_as(p)
    sums = fastba.preintegrate_from_registration(p, q, res.inliers.to(torch.float32), pose,
                                                 huber_delta)
    cand_sim = torch.cat([torch.zeros(1, device=dev), top_sims])
    cand_sal = torch.cat([torch.zeros(1, device=dev), salient[top_rows]])
    fetch = torch.cat([cand_slots[:, None].to(torch.float32), ok[:, None].to(torch.float32),
                       stats, cand_sim[:, None], cand_sal[:, None]], dim=1)
    return PromoteProbe(cand_slots, ok, stats, *sums, midx=res.match_idx.to(torch.int32),
                        minl=res.inliers.to(torch.float32), fetch=fetch.reshape(-1))


# the probe as the JAX package runs it, one jitted program per (cfg, intr,
# n_cand, thresholds and input shapes; a DB of another capacity is another
# program): one captured program on the card, its statics passed as keywords
PROBE_PROGRAMS = graphs.program("probe", promote_probe)
