"""MRF view selection: per-chunk keyframe labels by checkerboard ICM.

Port of texturefusion_tpu/texture/mrf.py (ref: Structure/TexMap.cpp:120-255
view_selection — graph :122-137, label sets :139-155, unaries 1 − q/qmax
:157-180, PairwisePotts with edge weight adjacent_cost, warm start from
labelstorage :200-225, label 0 = undefined with the second-newest-keyframe
fallback :228-246).

The problem is Potts-pairwise with small per-node label sets (the
keyframes that observed each chunk, at most max_labels) over the
6-neighbour chunk grid, which is 2-colourable by the parity of the chunk
coordinates. Checkerboard ICM is therefore exact coordinate descent over
[nodes, max_labels] costs: 2 × sweeps half-sweeps of a few tensor ops
each, with no host read inside.

The problem is assembled on the host (numpy) at its true node count: the
JAX package pads it to a node bucket so that its jitted solver compiles
once per size, which the port does not need. The keyframe columns of the
observation table are still sliced to a power-of-two bucket (`kcap`):
argpartition orders tied qualities by the table's width, so the label
order, and with it the warm start, equals the JAX package's only at the
same width.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MRFProblem(NamedTuple):
    unary: torch.Tensor       # [N, L] f32 unary costs (1e9 for absent labels)
    label_kf: torch.Tensor    # [N, L] int32 keyframe id per label slot (-1 absent)
    neighbors: torch.Tensor   # [N, 6] int64 node index (N = no neighbour)
    parity: torch.Tensor      # [N] int32 0/1 — checkerboard colour
    init_label: torch.Tensor  # [N] int64 initial label slot (warm start)
    n_valid: torch.Tensor     # [N] bool — node participates


def solve_icm(problem: MRFProblem, potts_weight: float, edge_weight: float,
              sweeps: int = 12) -> torch.Tensor:
    """Checkerboard ICM fixed point. Returns [N] int64 label slot per node."""
    n, l = problem.unary.shape
    dev = problem.unary.device
    # neighbour index n → a virtual node whose keyframe ids (-2) equal no
    # real label; its label is 0
    label_kf_pad = torch.cat([problem.label_kf,
                              torch.full((1, l), -2, dtype=torch.int32, device=dev)])
    nbr_label_kf = label_kf_pad[problem.neighbors]                  # [N, 6, L]
    nbr_real = (problem.neighbors < n)[..., None]                   # [N, 6, 1]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    w = potts_weight * edge_weight
    labels = problem.init_label
    for i in range(sweeps * 2):
        lab_pad = torch.cat([labels, zero])
        nbr_kf = torch.gather(nbr_label_kf, 2, lab_pad[problem.neighbors][..., None])  # [N, 6, 1]
        # Potts: pay when our keyframe id differs from the neighbour's
        diff = (problem.label_kf[:, None, :] != nbr_kf) & nbr_real    # [N, 6, L]
        costs = problem.unary + diff.to(torch.float32).sum(dim=1) * w
        best = torch.argmin(costs, dim=-1)
        upd = (problem.parity == i % 2) & problem.n_valid
        labels = torch.where(upd, best, labels)
    return labels


def mrf_energy(problem: MRFProblem, labels: torch.Tensor,
               potts_weight: float, edge_weight: float) -> torch.Tensor:
    """Total labelling energy (ICM never increases it)."""
    n = problem.unary.shape[0]
    labels = labels.to(torch.int64)[:, None]
    u = torch.gather(problem.unary, 1, labels)[:, 0]
    u = torch.where(problem.n_valid, u, 0.0)
    my_kf = torch.gather(problem.label_kf, 1, labels)[:, 0]
    kf_pad = torch.cat([my_kf, torch.full((1,), -2, dtype=my_kf.dtype, device=my_kf.device)])
    nbr_kf = kf_pad[problem.neighbors]                              # [N, 6]
    nbr_real = (problem.neighbors < n) & problem.n_valid[:, None]
    # each undirected edge appears twice in the neighbour lists → ×0.5
    pair = ((nbr_kf != my_kf[:, None]) & nbr_real).sum() * (potts_weight * edge_weight) * 0.5
    return u.sum() + pair


class ViewSelector:
    """Builds MRF problems from the chunk graph and the observation table
    and keeps the warm-start labels (ref: TexMap labelstorage)."""

    def __init__(self, max_labels: int = 16, potts_weight: float = 1.0,
                 edge_weight: float = 0.5, sweeps: int = 12, *, device):
        self.max_labels = max_labels
        self.potts = potts_weight
        self.edge_w = edge_weight
        self.sweeps = sweeps
        self.device = torch.device(device)
        # slot -> chosen keyframe id, −1 = none yet (persistent warm start)
        self.labels = np.full(0, -1, np.int32)

    def ensure_capacity(self, n_slots: int) -> None:
        if len(self.labels) < n_slots:
            new = np.full(n_slots, -1, np.int32)
            new[: len(self.labels)] = self.labels
            self.labels = new

    def build_problem_arrays(self, obs_q: np.ndarray, obs_mask: np.ndarray,
                             meshed: np.ndarray, nbr_slots: np.ndarray,
                             chunk_ids: np.ndarray, newest_kf: int):
        """MRF assembly from the dense observation arrays and the adjacency
        (IncrementalMesher.chunk_adjacency_arrays), one node per meshed
        chunk. Returns (problem, slots [N] int64, label_kf [N, L] numpy)."""
        if len(meshed) == 0:
            return None, meshed, None
        self.ensure_capacity(len(chunk_ids) + 1)
        sl = np.asarray(meshed, np.int64)
        n = len(sl)
        l = self.max_labels

        # the active keyframe columns, bucketed to a power of two (see the
        # module docstring)
        kcap = 64
        while kcap < newest_kf + 1:
            kcap *= 2
        kcap = min(kcap, obs_q.shape[1])
        qs, ms = obs_q[sl, :kcap], obs_mask[sl, :kcap]
        q = np.where(ms & (qs > 0), qs, -np.inf)                # [N, K]
        l_eff = min(l, q.shape[1])
        # top-l labels per chunk by quality (argpartition + sort of l)
        part = np.argpartition(-q, l_eff - 1, axis=1)[:, :l_eff]
        pq = np.take_along_axis(q, part, axis=1)
        order = np.argsort(-pq, axis=1, kind="stable")
        top_kf = np.take_along_axis(part, order, axis=1).astype(np.int32)
        top_q = np.take_along_axis(pq, order, axis=1)           # [N, l_eff]
        has = np.isfinite(top_q)
        valid_row = has[:, 0]

        unary = np.full((n, l), 1e9, np.float32)
        label_kf = np.full((n, l), -1, np.int32)
        qmax = np.where(valid_row, top_q[:, 0], 1.0)
        with np.errstate(invalid="ignore"):
            u = 1.0 - top_q / qmax[:, None]
        unary[:, :l_eff] = np.where(has, u, 1e9).astype(np.float32)
        label_kf[:, :l_eff] = np.where(has, top_kf, -1)

        # chunks with no positive observation: label 0 = previous label
        # or the second-newest keyframe (ref: TexMap.cpp:228-246)
        fallback_kf = max(newest_kf - 1, 0)
        prev = self.labels[sl]                                  # [N]
        rows_nopos = np.nonzero(~valid_row)[0]
        lab0 = np.where(prev >= 0, prev, fallback_kf)
        label_kf[rows_nopos, 0] = lab0[rows_nopos]
        unary[rows_nopos, 0] = 1.0

        # warm start: previous label's slot index if still in the set
        eq = (top_kf == prev[:, None]) & has
        init = np.where(eq.any(axis=1), eq.argmax(axis=1), 0)
        parity = (chunk_ids[sl].sum(axis=1) & 1).astype(np.int32)

        # neighbour slot -> node row (n = no neighbour)
        row_lookup = np.full(len(chunk_ids) + 1, n, np.int64)
        row_lookup[sl] = np.arange(n)
        nbrs = np.full((n, 6), n, np.int64)
        nbr_w = nbr_slots[:, :6]
        nbrs[:, : nbr_w.shape[1]] = np.where(
            nbr_w >= 0, row_lookup[np.clip(nbr_w, 0, len(chunk_ids))], n)

        def t(a):
            return torch.as_tensor(a, device=self.device)

        problem = MRFProblem(unary=t(unary), label_kf=t(label_kf), neighbors=t(nbrs),
                             parity=t(parity), init_label=t(init.astype(np.int64)),
                             n_valid=t(valid_row))
        return problem, sl, label_kf

    def build_problem(self, observations: dict, adjacency: dict,
                      chunk_ids: np.ndarray, newest_kf: int):
        """Dict-input MRF assembly: slot → {kf: quality} and slot → neighbour
        slots, converted to the dense arrays of build_problem_arrays."""
        slots = sorted(adjacency.keys())
        if not slots:
            return None, [], None
        cap = len(chunk_ids)
        max_kf = max((max(d) for d in observations.values() if d), default=0) + 1
        obs_q = np.zeros((cap + 1, max_kf), np.float32)
        obs_mask = np.zeros((cap + 1, max_kf), bool)
        for s, d in observations.items():
            for kf, qv in d.items():
                obs_q[int(s), int(kf)] = qv
                obs_mask[int(s), int(kf)] = True
        nbr = np.full((len(slots), 6), -1, np.int64)
        for i, s in enumerate(slots):
            a = np.asarray(adjacency[s], np.int64)[:6]
            nbr[i, : len(a)] = a
        return self.build_problem_arrays(obs_q, obs_mask, np.asarray(slots, np.int64), nbr,
                                         chunk_ids, newest_kf)

    def adopt_solution(self, slots, label_kf: np.ndarray, sol, newest_kf: int) -> dict:
        """Solved label slots → keyframe ids; persists the warm start
        (ref: TexMap labelstorage + the label-0 fallback)."""
        fallback_kf = max(newest_kf - 1, 0)
        sl = np.asarray(slots, np.int64)
        if len(sl) == 0:
            return {}
        self.ensure_capacity(int(sl.max()) + 1)
        sol = sol.cpu().numpy() if isinstance(sol, torch.Tensor) else np.asarray(sol)
        kf = label_kf[np.arange(len(sl)), sol[: len(sl)]]
        prev = self.labels[sl]
        kf = np.where(kf >= 0, kf, np.where(prev >= 0, prev, fallback_kf)).astype(np.int32)
        self.labels[sl] = kf
        return {int(s): int(k) for s, k in zip(sl.tolist(), kf.tolist())}

    def select(self, observations: dict, adjacency: dict, chunk_ids: np.ndarray,
               newest_kf: int) -> dict:
        """observations: slot → {kf: quality}; adjacency: slot → neighbour
        slots; chunk_ids: [capacity, 3] chunk coordinates (parity). Returns
        slot → keyframe id."""
        problem, slots, label_kf = self.build_problem(observations, adjacency, chunk_ids,
                                                      newest_kf)
        if problem is None:
            return {}
        sol = solve_icm(problem, self.potts, self.edge_w, self.sweeps)
        return self.adopt_solution(slots, label_kf, sol, newest_kf)
