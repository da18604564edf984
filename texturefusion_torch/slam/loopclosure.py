"""Loop-closure candidate scoring: Hamming similarity + salience.

Port of texturefusion_tpu/slam/loopclosure.py (ref: GCSLAM/MILD/
loop_closure_detector.hpp:56-231, LUT exp(−d²/900) :100-109, IDF :214-228;
BayesianFilter.hpp:31-91; GCSLAM.cpp:6-50). Each keyframe keeps a fixed
random subsample of its descriptors; a query scores against every stored
keyframe, exactly.

The JAX kernel forms [Q, K·S] distances over the whole DB and XLA fuses
them away; eager torch would materialise them (1024 × 512·256 words).
So `similarity_rows` scores only the rows in use, in row chunks. Unused
rows hold no valid descriptor and add nothing to the sums, the IDF's
document frequency or the keyframe count, so the scores are the same.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from texturefusion_torch.ops import hamming
from texturefusion_torch.utils.capacity import grown

_ROW_CHUNK_ELEMS = 1 << 25   # Q·rows·S distances per chunk (128 MiB of f32)


class KeyframeDescriptorDB:
    """Per-keyframe descriptor subsamples, stacked on the device;
    `max_keyframes` rows until its owner grows them (`grow`)."""

    def __init__(self, sub_per_kf: int = 256, max_keyframes: int = 512, *, device):
        self.sub = sub_per_kf
        self.max_kf = max_keyframes
        self.desc = torch.zeros((max_keyframes, sub_per_kf, hamming.WORDS),
                                dtype=torch.int32, device=device)
        self.valid = torch.zeros((max_keyframes, sub_per_kf), dtype=torch.bool, device=device)
        self.kf_ids: List[int] = []

    def add(self, kf_id: int, desc: torch.Tensor, valid: torch.Tensor, seed: int = 0) -> None:
        """Insert a keyframe's descriptors, subsampled along a host
        permutation `default_rng(seed + kf_id)` and stably partitioned
        valid-first on the device."""
        k = len(self.kf_ids)
        if k >= self.max_kf:
            raise IndexError(f"the descriptor DB holds {self.max_kf} rows, all in use: "
                             "grow it first")
        n = desc.shape[0]
        if n == 0:
            return
        rng = np.random.default_rng(seed + kf_id)
        order = torch.as_tensor(rng.permutation(max(n, self.sub)) % n, device=desc.device)
        v_perm = valid[order]
        part = torch.argsort((~v_perm).to(torch.int8), stable=True)
        sel = order[part][:self.sub]
        self.desc[k] = desc[sel]
        self.valid[k] = v_perm[part][:self.sub]
        self.kf_ids.append(kf_id)

    def grow(self, capacity: int) -> None:
        """Hold `capacity` rows; the new ones empty."""
        self.desc = grown(self.desc, capacity)
        self.valid = grown(self.valid, capacity, False)
        self.max_kf = capacity

    def __len__(self) -> int:
        return len(self.kf_ids)

    def similarity(self, query_desc: torch.Tensor, query_valid: torch.Tensor) -> np.ndarray:
        """Similarity of the query frame to every stored keyframe: [K]."""
        if not self.kf_ids:
            return np.zeros(0, np.float32)
        return similarity_rows(query_desc, query_valid, self.desc, self.valid,
                               len(self.kf_ids)).cpu().numpy()


def similarity_rows(qdesc: torch.Tensor, qvalid: torch.Tensor, db_desc: torch.Tensor,
                    db_valid: torch.Tensor, n_rows: int) -> torch.Tensor:
    """sim[r] = Σ_q idf_q · exp(−dmin_qr²/900) over DB rows r < n_rows: [n_rows]."""
    q, _ = qdesc.shape
    s = db_desc.shape[1]
    qbits = hamming.unpack_bits(qdesc)
    step = max(1, _ROW_CHUNK_ELEMS // max(q * s, 1))
    dmins = []
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        bits = hamming.unpack_bits(db_desc[r0:r1].reshape(-1, hamming.WORDS))
        d = hamming.hamming_from_bits(qbits, bits)                       # [Q, rows·S]
        ok = db_valid[r0:r1].reshape(1, -1) & qvalid[:, None]
        d = torch.where(ok, d, 1 << 14).reshape(q, r1 - r0, s)
        dmins.append(torch.amin(d, dim=2).to(torch.float32))
    dmin = torch.cat(dmins, dim=1)                                        # [Q, n_rows]
    sim = torch.exp(-(dmin * dmin) / 900.0)
    sim = torch.where(dmin < 256.0, sim, 0.0)
    # IDF: a feature matching many keyframes is common texture
    n_kf = torch.clamp(torch.sum(torch.any(db_valid[:n_rows], dim=1)), min=1)
    df = torch.sum(dmin < 50.0, dim=1).to(torch.float32)
    idf = torch.log(n_kf.to(torch.float32) / (1.0 + df) + 1.0)
    return torch.sum(sim * idf[:, None], dim=0)


def select_candidates(sims: np.ndarray, salient_threshold: float = 1.5,
                      max_candidates: int = 5) -> List[int]:
    """Salient-score candidate selection over DB rows (ref: GCSLAM.cpp:6-50,
    BayesianFilter.hpp:31-91): the trailing run of recent above-average
    rows is left out of the historical mean/σ; score = (sim − σ)/μ; the
    top rows above the threshold. Returns DB rows."""
    n = len(sims)
    if n == 0:
        return []
    avg = float(sims.mean())
    history_loop = -1
    for i in range(n - 1, -1, -1):
        if sims[i] < avg:
            history_loop = i
            break
    if history_loop <= 0:
        salient = np.full(n, 3.0)
    else:
        hist = np.asarray(sims[:history_loop], np.float64)
        mean_hist = hist.mean()
        if mean_hist < 1e-8 or history_loop < 3:
            salient = np.ones(n)
        else:
            delta = np.linalg.norm(hist - mean_hist) / max(np.sqrt(len(hist) - 1.0), 1.0)
            salient = (sims - delta) / mean_hist
    cands = [int(i) for i in np.argsort(-sims) if salient[i] > salient_threshold]
    return cands[:max_candidates]
