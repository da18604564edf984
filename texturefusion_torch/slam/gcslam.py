"""Globally-consistent SLAM: the keyframe tracking state machine.

Port of the synchronous control flow of texturefusion_tpu/slam/gcslam.py
(ref: GCSLAM/GCSLAM.{h,cpp} — update_frame :256-356 with the keyframe
decision :315-327, update_keyframe :52-185, select_closure_candidates
:6-50, updateMapOrigin :187-254). Features, registration, loop-closure
scoring and FastBA run as torch ops on the frame's device; this class is
the host-side control flow.

A tracked frame becomes a keyframe on disparity > 0.1, scale change
> 0.4, low overlap, or after 3 consecutive failures; blurred frames are
blocked (ref: BasicAPI.cpp:1256). When every candidate registration
fails, a new map origin starts (ref: GCSLAM.cpp:149-161), and a later
keyframe that registers to two origins merges them.

The JAX package's pipelined tracker is carried. With `defer_promote` a
steady-state promotion adopts the keyframe at once, at the tracked pose
composed onto the last keyframe's peeked pose, and the loop-closure
probe it dispatches is consumed a frame later (`consume_pending_promote`:
edges, the pose recomposed from the synced parent, the DB gate, BA). A
frame registered against a keyframe since superseded (`res_kf_slot` not
the last keyframe, the pipelined tracker's stale reference) is
re-anchored by composition and, with `refine_stale`, re-registered
against the adopted keyframe, adopted when the result lands
(`consume_pending_refine`). BA's poses are held pending as a fetch
(utils/async_fetch.py) and adopted at the first read of `poses`;
`keyframe_pose_peek` reads without adopting. One fault of the JAX
package is not copied (ROADMAP fault 16): its deferred probe takes the
new keyframe, adopted just before, as its candidate 0, so the tracked
registration becomes an edge from the keyframe to itself; the port
probes against the superseded keyframe, as the synchronous path does.
On one device BA runs at the JAX package's bucketed keyframe and edge
counts, so that its rounds are replayed as captured programs
(fastba.BA_ROUND_PROGRAMS), and the JAX package's Schur BA is the dense
solve; over a DeviceMesh BA is edge-sharded (`_run_ba`, parallel/ba.py).

The keyframe-indexed state (the pose array, the descriptor DB's rows and
their slots, the keypoint DB) starts at `ba.max_keyframes` rows and the
edge-indexed state (the edge sums, the raw matches) at `ba.max_edges`;
each doubles when a keyframe or an edge outgrows it (`_grow_keyframes`,
`_grow_edges`: the STOPWATCH span `kf_grow`), as upstream's vectors
grow. The JAX package's fixed capacities raise at keyframe 512 and turn
edges away past 4,096 (ROADMAP, its known fault 23).

On the card the promotion probe is one captured CUDA graph
(promote.PROBE_PROGRAMS), its scalars 0-d device tensors, as the
JAX package runs it as one jitted program; so is the stale-frame
refinement's registration (REFINE_PROGRAMS).

Random draws: every registration takes Gumbel draws from `draw_fn(cfg,
n)` ([R, H, 4, K], or [n, R, H, 4, K] for n candidates). By default they
come from one torch.Generator on the SLAM device, in the order the JAX
package splits its key.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig, TrackingConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import se3
from texturefusion_torch.io.prefetch import upload
from texturefusion_torch.parallel import ba as pba
from texturefusion_torch.parallel.mesh import DeviceMesh, config_mesh, pad_to_multiple
from texturefusion_torch.slam import fastba, loopclosure, promote
from texturefusion_torch.slam.features import Keypoints, extract_features
from texturefusion_torch.slam.matching import (TwoViewResult, lite_config, ransac_draws,
                                               register_frames, register_frames_batch,
                                               stack_keypoints)
from texturefusion_torch.utils import async_fetch, graphs
from texturefusion_torch.utils.capacity import doubled, grown
from texturefusion_torch.utils.stopwatch import STOPWATCH


@dataclasses.dataclass
class FrameRecord:
    index: int
    timestamp: float
    is_keyframe: bool = False
    keyframe_slot: int = -1             # slot of the owning keyframe
    rel_to_keyframe: np.ndarray = None  # [4,4]: p_kf = rel · p_frame
    tracking_success: bool = False
    origin_index: int = 0
    blurred: bool = False
    keypoints: Optional[Keypoints] = None   # kept for keyframes only
    rel_pose_dev: Optional[torch.Tensor] = None


@dataclasses.dataclass
class KeyframeRecord:
    frame_index: int
    slot: int                           # index into the pose array
    origin_index: int
    local_frames: List[int] = dataclasses.field(default_factory=list)
    reg_success_count: int = 0


def _refine_program(kp_ref: Keypoints, kp: Keypoints, draws: torch.Tensor, *,
                    cfg: TrackingConfig, intr: cam.Intrinsics) -> torch.Tensor:
    """The stale-frame refinement's registration: its stats [21]."""
    return register_frames(kp_ref, kp, draws, cfg, intr).stats


# the refinement as the JAX package runs it, one jitted register_frames per
# (cfg, intr, shapes): one captured program on the card
REFINE_PROGRAMS = graphs.program("refine", _refine_program)


def _next_bucket(n: int, lo: int, cap: int) -> int:
    """The least lo·2^k at or above n, at most `cap` (the current
    capacity): the JAX package's bucket of BA's keyframe and edge counts
    (its gcslam._next_bucket)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cap)


def _count_loop_edges(results, last_slot: int) -> None:
    """The STOPWATCH counter `loop_edges`: a new keyframe's accepted
    registrations to keyframes other than the one it was tracked against
    (results' first items are KeyframeRecords)."""
    STOPWATCH.count("loop_edges", sum(r[0].slot != last_slot for r in results))


class GCSLAM:
    def __init__(self, config: PipelineConfig, device="cuda",
                 draw_fn: Optional[Callable[[TrackingConfig, Optional[int]], torch.Tensor]] = None,
                 mesh: Optional[DeviceMesh] = None):
        """`mesh` shards BA's edges over its devices; without one, the
        config's parallel.n_devices picks a mesh under the JAX package's
        rule (more than one device, and that many exist)."""
        self.config = config
        self.cfg = config.tracking
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.device = torch.device(device)
        if mesh is None:
            mesh = config_mesh(config.parallel.n_devices, self.device, "GCSLAM")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.frames: List[FrameRecord] = []
        self.keyframes: List[KeyframeRecord] = []
        max_kf = config.ba.max_keyframes
        pad = config.tracking.max_features_pad
        # keyframe poses; BA's newest are pending until the first read of
        # `poses` (the fusion thread reads them too, hence the lock); the
        # pose array, the DBs and _row_to_slot hold kf_capacity rows
        self.kf_capacity = max_kf
        self._poses_np = np.tile(np.eye(4, dtype=np.float32), (max_kf, 1, 1))
        self._poses_pending = None        # (fetch handle, rows active at dispatch)
        self._pose_lock = threading.Lock()
        self.edge_capacity = config.ba.max_edges
        self.edges = fastba.make_edges(config.ba.max_edges, self.device)
        self.n_edges = 0
        # raw per-edge matches: finalBA re-pre-integrates edges with Huber
        # weights at the final poses (ref: GCSLAM.h:32-39 initGraphHuberNorm)
        self._edge_midx = torch.zeros((config.ba.max_edges, pad), dtype=torch.int32,
                                      device=self.device)
        self._edge_minl = torch.zeros((config.ba.max_edges, pad), device=self.device)
        self._edge_has = np.zeros(config.ba.max_edges, bool)
        self.db = loopclosure.KeyframeDescriptorDB(max_keyframes=max_kf, device=self.device)
        self.kp_db = promote.KeypointDB(max_kf, pad, self.device)
        self._row_to_slot = torch.full((max_kf,), -1, dtype=torch.int64, device=self.device)
        self.fail_count = 0
        self.origin_count = 1
        # the JAX class's seeds: base_key PRNGKey(7) seeds
        # frame_step_tracked2's per-frame generators, PRNGKey(42) this
        # class's own draws
        self.base_seed = 7
        self._gen = torch.Generator(device=self.device).manual_seed(42)
        self._draw_fn = draw_fn or self._generator_draws
        self._ba_errors = None       # the last BA's [rounds, 2] errors: a fetch handle or an array
        self.ba_keyframes = 0        # the most keyframes a BA has run over
        # deferred promotion: the probe dispatched at adoption, consumed
        # (edges, pose correction, BA) one frame later
        self._pending_promote: Optional[dict] = None
        self.promote_late = 0        # promotions consumed after their first chance
        # frames finalized against a superseded keyframe, and their
        # re-registrations against the adopted one, adopted when they land
        self.stale_frames: List[int] = []
        self._pending_refine: List[dict] = []
        self.refine_dispatched = 0
        self.refine_adopted = 0
        self._kf_depth = None        # last keyframe depth/normals, for ICP only
        self._kf_normals = None
        self._prev_kp = None         # previous frame's keypoints: f2f fallback

    # ------------------------------------------------------------ helpers

    def _generator_draws(self, cfg: TrackingConfig, n: Optional[int] = None) -> torch.Tensor:
        batch = () if n is None else (n,)
        return ransac_draws(cfg, self.cfg.max_features_pad, self._gen, batch)

    def _draws(self, cfg: TrackingConfig, n: Optional[int] = None) -> torch.Tensor:
        return self._draw_fn(cfg, n).to(self.device)

    def _register(self, kp_ref: Keypoints, kp: Keypoints) -> TwoViewResult:
        return register_frames(kp_ref, kp, self._draws(self.cfg), self.cfg, self.intr)

    @property
    def poses(self) -> np.ndarray:
        """Keyframe pose array; adopts a pending BA result first."""
        self._sync_poses()
        return self._poses_np

    @poses.setter
    def poses(self, value: np.ndarray) -> None:
        with self._pose_lock:
            self._poses_pending = None
            self._poses_np = value

    def _sync_poses(self) -> None:
        # called from the tracking and the fusion threads
        with self._pose_lock:
            if self._poses_pending is not None:
                handle, n_active = self._poses_pending
                self._poses_pending = None
                # only the rows active at dispatch: a keyframe promoted
                # while the fetch was in flight keeps its own pose
                fetched = async_fetch.resolve(handle).reshape(-1, 4, 4)
                self._poses_np[:n_active] = fetched[:n_active]

    def keyframe_pose_peek(self, slot: int) -> np.ndarray:
        """A keyframe's pose without adopting a pending BA result (at
        most one BA round stale), for provisional uses that are validated
        against the synced pose later."""
        with self._pose_lock:
            return self._poses_np[slot].copy()

    @property
    def last_ba_errors(self) -> List[np.ndarray]:
        """The last BA's (error before, error after) per round; read on demand."""
        return [] if self._ba_errors is None else list(async_fetch.resolve(self._ba_errors))

    @last_ba_errors.setter
    def last_ba_errors(self, value) -> None:
        self._ba_errors = np.asarray(value, np.float32) if len(value) else None

    @property
    def last_keyframe(self) -> Optional[KeyframeRecord]:
        return self.keyframes[-1] if self.keyframes else None

    def keyframe_pose(self, slot: int) -> np.ndarray:
        return self.poses[slot].copy()       # a copy: read from two threads

    def frame_pose(self, idx: int) -> np.ndarray:
        """World pose of any frame: keyframe pose ∘ stored relative pose
        (ref: MultiViewGeometry.cpp:1149-1156)."""
        f = self.frames[idx]
        kf_pose = self.poses[f.keyframe_slot]
        if f.is_keyframe:
            return kf_pose
        return np.asarray(kf_pose @ f.rel_to_keyframe)

    def trajectory(self) -> np.ndarray:
        self.consume_pending_refine(force=True)
        return np.stack([self.frame_pose(i) for i in range(len(self.frames))])

    # ------------------------------------------------------------ capacities

    def _grow_keyframes(self, n: int) -> None:
        """Double the keyframe-indexed state until it holds n keyframes:
        the pose array (new rows identity), the descriptor DB's rows and
        their slots, the keypoint DB (the STOPWATCH span `kf_grow`)."""
        if n <= self.kf_capacity:
            return
        cap = doubled(self.kf_capacity, n)
        with STOPWATCH.time("kf_grow", kf=n - 1):
            with self._pose_lock:
                self._poses_np = grown(self._poses_np, cap, np.eye(4, dtype=np.float32))
            self._row_to_slot = grown(self._row_to_slot, cap, -1)
            self.db.grow(cap)
            self.kp_db.grow(cap)
            self.kf_capacity = cap

    def _grow_edges(self, n: int) -> None:
        """Double the edge-indexed state until it holds n edges: the edge
        sums (new rows invalid) and the raw matches (the span `kf_grow`)."""
        if n <= self.edge_capacity:
            return
        cap = doubled(self.edge_capacity, n)
        with STOPWATCH.time("kf_grow", kf=len(self.keyframes) - 1):
            self.edges = fastba.EdgeSums(*(grown(a, cap) for a in self.edges))
            self._edge_midx = grown(self._edge_midx, cap)
            self._edge_minl = grown(self._edge_minl, cap)
            self._edge_has = grown(self._edge_has, cap, False)
            self.edge_capacity = cap

    # ------------------------------------------------------------ edges

    def _append_edge(self, kf_i_slot, kf_j_slot, sums, matches=None) -> None:
        self._grow_edges(self.n_edges + 1)
        e = torch.tensor([self.n_edges], device=self.device)
        fastba.write_edges(self.edges, e, kf_i_slot, kf_j_slot, [s[None] for s in sums])
        if matches is not None:
            self._store_edge_matches(self.n_edges, *matches)
        self.n_edges += 1

    def _add_virtual_edge(self, kf_i_slot: int, kf_j_slot: int, rel_pose: np.ndarray,
                          n_pts: int = 64, weight: float = 0.5) -> None:
        """Odometry-prior edge from a relative pose without shared features:
        virtual points p = T_rel·q tie the two keyframes in FastBA."""
        rng = np.random.default_rng(kf_j_slot)
        q = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
        q[:, 2] += 2.0
        qj = torch.as_tensor(q, device=self.device)
        pj = se3.transform_points(torch.as_tensor(rel_pose.astype(np.float32),
                                                  device=self.device), qj)
        sums = fastba.preintegrate_edge(pj, qj, torch.full((n_pts,), weight, device=self.device))
        self._append_edge(kf_i_slot, kf_j_slot, sums)

    def _add_edge(self, kf_i_slot: int, kf_j_slot: int, kp_ref: Keypoints,
                  kp_src: Keypoints, res: TwoViewResult) -> None:
        """Pre-integrate a successful registration into the edge store
        (ref: MultiViewGeometry.h:245-311; GCSLAM.cpp:178-183)."""
        inl = res.inliers.to(torch.float32)
        sums = fastba.preintegrate_from_registration(
            kp_ref.points3d[res.match_idx], kp_src.points3d, inl, res.pose,
            self.config.ba.huber_delta)
        self._append_edge(kf_i_slot, kf_j_slot, sums, (res.match_idx, inl))

    def _store_edge_matches(self, e: int, midx, minl) -> None:
        self._edge_midx[e] = midx
        self._edge_minl[e] = minl
        self._edge_has[e] = True

    def _run_ba(self) -> None:
        """FastBA over all keyframes (ref: optimizeKeyFrameMap
        MultiViewGeometry.cpp:1209-1217, at every new keyframe). On one
        device it is dense, at the JAX package's buckets of the keyframe and
        edge counts (`_next_bucket`), the rows past the true count identity
        poses, pinned and inactive, the edges past it invalid: the captured
        rounds are replayed while the counts stay in their buckets. From
        `schur_min_keyframes` on, the JAX package runs its
        keyframe-partitioned Schur BA on a 1-device mesh, where one block
        holds every keyframe, no edge crosses a block, the separator set is
        empty and the step is the dense −H⁻¹b. With a mesh the edges are
        sharded over it (parallel/ba.py): Schur GN from
        `schur_min_keyframes` on, else distributed GN, with the keyframes
        padded by pinned inactive ones to a mesh multiple. Pin, damping,
        non-finite guard, rollback and pruning are the same on every path."""
        n_kf = len(self.keyframes)
        if n_kf < 2 or self.n_edges < 1:
            return
        cfg = self.config.ba
        if self.mesh is None:
            n_rows = _next_bucket(n_kf, cfg.kf_bucket_floor, self.kf_capacity)
            edges = self.edges.head(_next_bucket(self.n_edges, cfg.edge_bucket_floor,
                                                 self.edge_capacity))
            dev = self.device
        else:
            n_rows = pad_to_multiple(n_kf, self.mesh.size)
            edges = self.edges.head(self.n_edges)
            dev = self.mesh.devices[0]
        with STOPWATCH.time("t_ba_possync"):
            current = self.poses[:n_kf]
        # identity rows past the true count, pinned and inactive (the pose
        # array need not hold n_rows rows when the mesh size does not divide
        # its capacity)
        pad = np.tile(np.eye(4, dtype=np.float32), (n_rows - n_kf, 1, 1))
        poses = torch.as_tensor(np.concatenate([current, pad]), device=dev)
        active = torch.arange(n_rows, device=dev) < n_kf
        if self.mesh is None:
            new_poses, edges, errs = fastba.optimize(poses, edges, n_rows, active, cfg)
            valid = edges.valid[:self.n_edges]
        else:
            new_poses, valid, errs = pba.ba_rounds(
                poses, edges, n_rows, active, cfg, self.mesh,
                use_schur=n_kf >= cfg.schur_min_keyframes,
                sep_budget=cfg.schur_separator_budget)
        new_poses = new_poses[:n_kf]
        # the errors stay on the device until read; the poses are fetched
        # without waiting and adopted at the next read of `poses`
        self._ba_errors = async_fetch.fetch_async(errs)
        self.ba_keyframes = max(self.ba_keyframes, n_kf)
        handle = async_fetch.fetch_async(new_poses.reshape(-1))
        # published under the lock: _sync_poses on the fusion thread reads
        # and clears the same field
        with self._pose_lock:
            self._poses_pending = (handle, n_kf)
        self.edges.valid[:self.n_edges] = valid.to(self.device)

    # ------------------------------------------------------------ keyframes

    def _promote_keyframe(self, frame: FrameRecord, kp: Keypoints,
                          pose_world: np.ndarray) -> KeyframeRecord:
        slot = len(self.keyframes)
        self._grow_keyframes(slot + 1)
        # stored without adopting a pending BA result: its rows stop
        # below this slot
        with self._pose_lock:
            self._poses_np[slot] = pose_world
        kf = KeyframeRecord(frame_index=frame.index, slot=slot,
                            origin_index=frame.origin_index)
        self.keyframes.append(kf)
        frame.is_keyframe = True
        frame.keyframe_slot = slot
        frame.rel_to_keyframe = np.eye(4, dtype=np.float32)
        frame.keypoints = kp
        self.kp_db.add(slot, kp)
        return kf

    def _update_keyframe(self, frame: FrameRecord, kp: Keypoints,
                         tracked: Optional[TwoViewResult],
                         fallback_pose: Optional[np.ndarray] = None,
                         tracked_stats: Optional[np.ndarray] = None) -> None:
        """New-keyframe path: loop-closure candidates + registrations + edge
        insertion + FastBA (ref: GCSLAM.cpp:52-185 update_keyframe). One
        origin with a non-empty DB takes the promotion probe; several
        origins take the legacy path, which also probes each other
        origin's newest keyframe."""
        last_slot = self.last_keyframe.slot
        if (self.cfg.defer_promote and tracked is not None and tracked_stats is not None
                and self.origin_count == 1 and len(self.db) > 0):
            # steady state with the tracked pose on the host: adopt the
            # keyframe now, consume the probe a frame later (the
            # reference blocks its tracking thread here, GCSLAM.cpp:52-185)
            self._promote_dispatch(frame, kp, tracked_stats)
            return
        probe = None
        if self.origin_count == 1 and len(self.db) > 0:
            results, probe = self._probe_candidates(kp, tracked_stats)
        else:
            results = self._legacy_candidates(kp, tracked, tracked_stats, last_slot)

        if not results:
            if fallback_pose is not None:
                # frame-to-frame chaining kept a valid pose: promote in the
                # SAME origin with an odometry-prior edge for BA
                frame.origin_index = self.keyframes[last_slot].origin_index
                frame.tracking_success = True
                kf = self._promote_keyframe(frame, kp, fallback_pose.astype(np.float32))
                rel = np.linalg.inv(self.poses[last_slot]) @ fallback_pose
                self._add_virtual_edge(last_slot, kf.slot, rel)
                self._db_add(kf.slot, kp)
                self._run_ba()
                self.fail_count = 0
                return
            # registration failed everywhere → new map origin (ref: GCSLAM.cpp:149-161)
            self.origin_count += 1
            frame.origin_index = self.origin_count - 1
            frame.tracking_success = False
            self._promote_keyframe(frame, kp, self.poses[last_slot])
            self.fail_count = 0
            return

        # pose from the minimum-disparity successful match in the OLDEST
        # origin, so merges re-anchor younger maps onto older ones
        # (ref: GCSLAM.cpp:124-147 best match; :187-254 origin merge)
        oldest = min(r[0].origin_index for r in results)
        best = min((r for r in results if r[0].origin_index == oldest),
                   key=lambda r: float(r[1][3]))
        kf_best = best[0]
        pose_world = self.poses[kf_best.slot] @ best[1][5:21].reshape(4, 4)
        frame.origin_index = kf_best.origin_index
        frame.tracking_success = True
        kf = self._promote_keyframe(frame, kp, pose_world.astype(np.float32))

        if probe is not None:
            self._append_probe_edges(probe, [r[2] for r in results], kf.slot)
        else:
            for kf_c, _stats, sums, matches in results:
                self._append_edge(kf_c.slot, kf.slot, sums, matches)
        _count_loop_edges(results, last_slot)
        kf.reg_success_count = len(results)

        # map-origin merging (ref: GCSLAM.cpp:187-254 updateMapOrigin)
        adopted = kf.origin_index
        pose_new = self.poses[kf.slot]
        for kf_c, stats_c, *_ in results:
            o = kf_c.origin_index
            if o == adopted:
                continue
            pose_new_in_o = self.keyframe_pose(kf_c.slot) @ stats_c[5:21].reshape(4, 4)
            t_align = (pose_new @ np.linalg.inv(pose_new_in_o)).astype(np.float32)
            for other in self.keyframes:
                if other.origin_index == o:
                    self.poses[other.slot] = t_align @ self.poses[other.slot]
                    other.origin_index = adopted
                    self.frames[other.frame_index].origin_index = adopted
            for f in self.frames:
                if f.origin_index == o:
                    f.origin_index = adopted

        # descriptor DB insertion gated on match count (ref: GCSLAM.cpp:171-177)
        if len(results) < 4:
            self._db_add(kf.slot, kp)
        self._run_ba()
        self.fail_count = 0

    def _db_add(self, slot: int, kp: Keypoints) -> None:
        row = len(self.db)
        self.db.add(slot, kp.desc, kp.valid)
        if len(self.db) > row:
            self._row_to_slot[row] = slot

    def _dispatch_probe(self, kp: Keypoints, tracked_stats: Optional[np.ndarray],
                        last_slot: int):
        """Launch the promotion probe (candidate selection, registration,
        edge pre-integration; slam/promote.py) with `last_slot` as its
        candidate 0; returns (probe, n_cand, fetch handle of its results)."""
        n_cand = max(self.cfg.max_candidates, 2)
        have_tracked = tracked_stats is not None
        dev = self.device
        # the scalars filled on the device, the stats through a pinned
        # buffer: no blocking copy (and no wait for the queue) here
        ts = (upload(np.asarray(tracked_stats, np.float32), dev) if have_tracked
              else torch.zeros(21, device=dev))
        probe = promote.PROBE_PROGRAMS(
            self.kp_db.kp, self.db.desc, self.db.valid, self._row_to_slot,
            torch.full((), len(self.db), dtype=torch.int64, device=dev),
            torch.full((), last_slot, dtype=self._row_to_slot.dtype, device=dev), kp, ts,
            torch.full((), have_tracked, dtype=torch.bool, device=dev),
            self._draws(self.cfg, n_cand),
            salient_threshold=float(self.cfg.salient_score_threshold),
            huber_delta=float(self.config.ba.huber_delta), cfg=self.cfg, intr=self.intr,
            n_cand=n_cand)
        return probe, n_cand, async_fetch.fetch_async(probe.fetch)

    def _probe_results(self, n_cand: int, fetched: np.ndarray):
        """The probe's fetched rows -> [(KeyframeRecord, stats[21], row)]:
        the successful candidates, each slot once."""
        fetched = fetched.reshape(n_cand, 25)
        results = []
        seen = set()
        for i in range(n_cand):
            slot = int(fetched[i, 0])
            if fetched[i, 1] < 0.5 or slot in seen:
                continue
            seen.add(slot)
            results.append((self.keyframes[slot], fetched[i, 2:23], i))
        return results

    def _probe_candidates(self, kp: Keypoints, tracked_stats: Optional[np.ndarray]):
        """The promotion probe against the last keyframe, read at once.
        Returns ([(KeyframeRecord, stats[21], row)], probe)."""
        probe, n_cand, handle = self._dispatch_probe(kp, tracked_stats,
                                                     self.last_keyframe.slot)
        return self._probe_results(n_cand, async_fetch.resolve(handle)), probe

    def _append_probe_edges(self, probe: promote.PromoteProbe, rows: List[int],
                            kf_slot: int) -> int:
        """Append the taken probe candidates as edges + raw-match rows."""
        if not rows:
            return 0
        n0, n = self.n_edges, len(rows)
        self._grow_edges(n0 + n)
        e = torch.arange(n0, n0 + n, device=self.device)
        r = torch.as_tensor(rows, device=self.device)
        sums = [s[r] for s in (probe.s_w, probe.s_p, probe.s_q, probe.s_pp, probe.s_qq,
                               probe.s_pq)]
        fastba.write_edges(self.edges, e, probe.cand_slots[r], kf_slot, sums)
        self._edge_midx[e] = probe.midx[r]
        self._edge_minl[e] = probe.minl[r]
        self._edge_has[n0:n0 + n] = True
        self.n_edges += n
        return n

    def _promote_dispatch(self, frame: FrameRecord, kp: Keypoints,
                          tracked_stats: np.ndarray) -> None:
        """Adopt the keyframe now at the tracked pose, dispatch the
        loop-closure probe, and leave edges, the pose correction and BA to
        consume_pending_promote (usually the next frame)."""
        with STOPWATCH.time("pd_consume"):
            self.consume_pending_promote()           # at most one in flight
        last_slot = self.last_keyframe.slot
        rel = tracked_stats[5:21].reshape(4, 4).astype(np.float32)
        # peeked parent (at most one BA round stale): the consume step
        # recomposes this pose from the synced parent before BA, whose
        # initial poses must agree with what it reads (the JAX package
        # measured 32 -> 758 mm ATE from a stale-against-synced mismatch)
        pose_prov = (self.keyframe_pose_peek(last_slot) @ rel).astype(np.float32)
        frame.origin_index = self.keyframes[last_slot].origin_index
        frame.tracking_success = True
        kf = self._promote_keyframe(frame, kp, pose_prov)
        # candidate 0 is the superseded keyframe, the one `tracked_stats`
        # registered against (ROADMAP fault 16: the JAX package passes the
        # new keyframe here)
        with STOPWATCH.time("pd_probe"):
            probe, n_cand, handle = self._dispatch_probe(kp, tracked_stats, last_slot)
        self._pending_promote = {"probe": probe, "n_cand": n_cand, "handle": handle,
                                 "kf_slot": kf.slot, "last_slot": last_slot, "rel": rel,
                                 "frame": len(self.frames)}
        self.fail_count = 0

    def consume_pending_promote(self, force: bool = True) -> None:
        """Apply a deferred promotion's probe: loop-closure edges, the
        minimum-disparity pose, the descriptor-DB gate, BA (the deferred
        tail of ref GCSLAM.cpp:52-185). Idempotent. With force=False it
        waits while the probe's results have not landed, for up to three
        frames."""
        pend = self._pending_promote
        if pend is None:
            return
        waited = len(self.frames) - pend["frame"]
        if not force and not pend["handle"].done() and waited < 3:
            return
        self._pending_promote = None
        self.promote_late += waited > 0
        with STOPWATCH.time("t_promote_consume"):
            fetched = async_fetch.resolve(pend["handle"])
        results = self._probe_results(pend["n_cand"], fetched)
        kf = self.keyframes[pend["kf_slot"]]
        fr = self.frames[kf.frame_index]
        if not results:
            # candidate 0 carries the tracked stats validated at dispatch,
            # so even the tracked registration failed: a new map origin, as
            # the synchronous path (ref: GCSLAM.cpp:149-161), before this
            # keyframe's fusion cycle (only origin 0 fuses)
            self.origin_count += 1
            kf.origin_index = self.origin_count - 1
            fr.origin_index = kf.origin_index
            fr.tracking_success = False
            self._db_add(kf.slot, fr.keypoints)
            return
        # the minimum-disparity match (ref: GCSLAM.cpp:124-147), composed
        # from the synced parent
        best = min(results, key=lambda r: float(r[1][3]))
        if best[0].slot != pend["last_slot"]:
            pose_world = self.poses[best[0].slot] @ best[1][5:21].reshape(4, 4)
        else:
            pose_world = self.poses[pend["last_slot"]] @ pend["rel"]
        self.poses[kf.slot] = pose_world.astype(np.float32)
        self._append_probe_edges(pend["probe"], [r[2] for r in results], kf.slot)
        _count_loop_edges(results, pend["last_slot"])
        kf.reg_success_count = len(results)
        if len(results) < 4:          # ref: GCSLAM.cpp:171-177 DB insertion gate
            self._db_add(kf.slot, fr.keypoints)
        with STOPWATCH.time("cpp_ba"):
            self._run_ba()

    def _legacy_candidates(self, kp: Keypoints, tracked: Optional[TwoViewResult],
                           tracked_stats: Optional[np.ndarray], last_slot: int):
        """Candidate path for several origins or an empty DB. Returns
        [(KeyframeRecord, stats[21], sums, (match_idx, inlier weights))]."""
        sims = self.db.similarity(kp.desc, kp.valid)
        rows = loopclosure.select_candidates(sims, self.cfg.salient_score_threshold,
                                             self.cfg.max_candidates)
        cand_slots = [last_slot]
        for r in rows:
            s = self.db.kf_ids[r]
            if s not in cand_slots:
                cand_slots.append(s)
        # disconnected origins: always probe each other origin's newest
        # keyframe so the maps can re-merge
        if self.origin_count > 1:
            seen_origins = {self.keyframes[last_slot].origin_index}
            for other in reversed(self.keyframes):
                if other.origin_index not in seen_origins:
                    seen_origins.add(other.origin_index)
                    if other.slot not in cand_slots:
                        cand_slots.append(other.slot)
        huber = self.config.ba.huber_delta
        results = []
        to_register = []
        for slot in cand_slots:
            kf_c = self.keyframes[slot]
            if kf_c.slot == last_slot and tracked is not None:
                st = (tracked_stats if tracked_stats is not None
                      else tracked.stats.cpu().numpy())
                kp_ref = self.frames[kf_c.frame_index].keypoints
                inl = tracked.inliers.to(torch.float32)
                sums = fastba.preintegrate_from_registration(
                    kp_ref.points3d[tracked.match_idx], kp.points3d, inl, tracked.pose, huber)
                results.append((kf_c, st, sums, (tracked.match_idx, inl)))
                continue
            to_register.append(slot)
        if to_register:
            kp_refs = stack_keypoints([self.frames[self.keyframes[s].frame_index].keypoints
                                       for s in to_register])
            bres = register_frames_batch(kp_refs, kp, self._draws(self.cfg, len(to_register)),
                                         self.cfg, self.intr)
            stats_all = bres.stats.cpu().numpy()
            for i, slot in enumerate(to_register):
                if stats_all[i, 0] > 0.5:
                    kp_ref_i = self.frames[self.keyframes[slot].frame_index].keypoints
                    inl = bres.inliers[i].to(torch.float32)
                    sums = fastba.preintegrate_from_registration(
                        kp_ref_i.points3d[bres.match_idx[i]], kp.points3d, inl,
                        bres.pose[i], huber)
                    results.append((self.keyframes[slot], stats_all[i], sums,
                                    (bres.match_idx[i], inl)))
        return results

    # ------------------------------------------------------------ main entry

    def update_frame(self, gray: torch.Tensor, depth: torch.Tensor, timestamp: float = 0.0,
                     blurred=False, kp: Optional[Keypoints] = None,
                     res: Optional[TwoViewResult] = None, res_kf_slot: Optional[int] = None,
                     stats: Optional[np.ndarray] = None, res_ff=None,
                     stats_ff: Optional[np.ndarray] = None) -> FrameRecord:
        """Track one frame (ref: GCSLAM.cpp:256-356 update_frame).
        `blurred` is a bool or a zero-argument callable, evaluated only
        at promotion time. `kp`/`res`/`stats` (and `res_ff`/`stats_ff`,
        vs the previous frame) accept frame_step_tracked2's results;
        `res_kf_slot` names the keyframe `res` was computed against: when
        a newer keyframe exists by now (the pipelined tracker dispatches
        frames ahead of its decisions), the frame takes the stale-reference
        path. A deferred promotion and landed refinements are consumed
        first."""
        with STOPWATCH.time("t_u_pp"):
            self.consume_pending_promote(force=False)
            self.consume_pending_refine()
        frame = FrameRecord(index=len(self.frames), timestamp=timestamp)
        self.frames.append(frame)
        if kp is None:
            kp = extract_features(gray, depth, self.cfg, self.intr)

        if not self.keyframes:
            frame.tracking_success = True
            kf = self._promote_keyframe(frame, kp, np.eye(4, dtype=np.float32))
            self._db_add(kf.slot, kp)
            self._store_icp_reference(depth)
            self._prev_kp = kp
            return frame

        last_kf = self.last_keyframe
        if res is not None and res_kf_slot is not None and res_kf_slot != last_kf.slot:
            if stats is None:
                stats = res.stats.cpu().numpy()
            return self._update_frame_stale(frame, kp, res_kf_slot, last_kf, stats, stats_ff)
        kp_ref = self.frames[last_kf.frame_index].keypoints
        if res is None:
            res = self._register(kp_ref, kp)
        if stats is None:
            stats = res.stats.cpu().numpy()
        success = bool(stats[0] > 0.5)
        if not success and stats_ff is None:
            # borderline RANSAC draws: one retry with fresh draws before
            # declaring a tracking failure
            res = self._register(kp_ref, kp)
            stats = res.stats.cpu().numpy()
            success = bool(stats[0] > 0.5)

        # frame-to-frame fallback: chain through the previous frame when
        # the keyframe baseline got too wide for direct registration
        chained_pose = None
        if not success and self._prev_kp is not None and len(self.frames) > 1:
            prev = self.frames[-2]
            if prev.keyframe_slot == last_kf.slot and prev.rel_to_keyframe is not None:
                if stats_ff is None:
                    stats_ff = self._register(self._prev_kp, kp).stats.cpu().numpy()
                if stats_ff[0] > 0.5:
                    rel = prev.rel_to_keyframe @ stats_ff[5:21].reshape(4, 4)
                    chained_pose = self.poses[last_kf.slot] @ rel
                    frame.rel_to_keyframe = rel.astype(np.float32)

        # optional dense ICP refinement against the keyframe depth
        # (ref: settings.yaml use_icp_registration; preIntegrateICP)
        if success and self.cfg.use_icp and self._kf_depth is not None:
            from texturefusion_torch.slam import icp as icp_mod
            icp_res = icp_mod.icp_refine(self._kf_depth, self._kf_normals, depth, res.pose,
                                         self.intr)
            if bool(icp_res.success):
                # blend feature and ICP poses on the tangent space
                delta = se3.se3_log(se3.compose(se3.inverse(res.pose), icp_res.pose))
                blended = se3.compose(res.pose, se3.se3_exp(delta * self.cfg.icp_weight))
                res = res._replace(pose=blended)
                stats = np.concatenate([stats[:5], blended.reshape(-1).cpu().numpy()])

        promote_now = False
        if success:
            # promotion gates (ref: GCSLAM.cpp:315-327) plus an overlap gate
            # and a minimum frame gap (ref: settings.yaml keyframe_minimum_distance)
            overlap_low = float(stats[1]) < self.cfg.min_matches * 2
            far_enough = frame.index - last_kf.frame_index >= self.cfg.keyframe_min_distance
            if far_enough and (float(stats[3]) > self.cfg.minimum_disparity
                               or float(stats[4]) > self.cfg.scale_change_ratio
                               or overlap_low):
                is_blurred = blurred() if callable(blurred) else blurred
                frame.blurred = bool(is_blurred)
                promote_now = not is_blurred
        else:
            self.fail_count += 1
            if self.fail_count >= self.cfg.max_tracking_failures or chained_pose is not None:
                promote_now = True

        if success and not promote_now:
            frame.tracking_success = True
            frame.keyframe_slot = last_kf.slot
            frame.rel_to_keyframe = stats[5:21].reshape(4, 4).copy()
            frame.rel_pose_dev = res.pose
            frame.origin_index = last_kf.origin_index
            last_kf.local_frames.append(frame.index)
            self.fail_count = 0
            self._prev_kp = kp
            return frame

        if promote_now:
            self._update_keyframe(frame, kp, res if success else None,
                                  fallback_pose=chained_pose,
                                  tracked_stats=stats if success else None)
            self._store_icp_reference(depth)
            self._prev_kp = kp
            return frame

        # tracking failed, not promoting yet: hold the previous frame's pose
        # (constant-position model)
        frame.tracking_success = chained_pose is not None
        frame.keyframe_slot = last_kf.slot
        if frame.rel_to_keyframe is None:
            prev = self.frames[-2] if len(self.frames) > 1 else None
            if (prev is not None and prev.keyframe_slot == last_kf.slot
                    and prev.rel_to_keyframe is not None):
                frame.rel_to_keyframe = prev.rel_to_keyframe.copy()
            else:
                frame.rel_to_keyframe = np.eye(4, dtype=np.float32)
        frame.origin_index = last_kf.origin_index
        self._prev_kp = kp
        return frame

    def _update_frame_stale(self, frame: FrameRecord, kp: Keypoints, res_kf_slot: int,
                            last_kf: KeyframeRecord, stats: np.ndarray,
                            stats_ff: Optional[np.ndarray]) -> FrameRecord:
        """Finalize a frame registered against a keyframe that has been
        superseded since (the pipelined tracker). Its pose re-anchors by
        composition p_new_kf^-1 · p_old_kf · rel; the promotion gates are
        skipped for it (its disparity is against the old keyframe)."""
        self.stale_frames.append(frame.index)
        frame.keyframe_slot = last_kf.slot
        frame.origin_index = last_kf.origin_index
        frame.is_keyframe = False
        prev = self.frames[-2] if len(self.frames) > 1 else None
        prev_rel = (prev.rel_to_keyframe if prev is not None and prev.keyframe_slot == last_kf.slot
                    else None)
        if stats[0] > 0.5:
            # one peeked snapshot for both keyframes: only their relative
            # transform matters, and the re-registration below replaces
            # the composition anyway
            with self._pose_lock:
                pose_old_kf = self._poses_np[res_kf_slot].copy()
                pose_new_kf = self._poses_np[last_kf.slot].copy()
            rel = np.linalg.inv(pose_new_kf) @ pose_old_kf @ stats[5:21].reshape(4, 4)
            frame.tracking_success = True
            frame.rel_to_keyframe = rel.astype(np.float32)
            last_kf.local_frames.append(frame.index)
            self.fail_count = 0
        elif stats_ff is not None and stats_ff[0] > 0.5 and prev_rel is not None:
            # the registration against the superseded keyframe failed:
            # chain through the frame-to-frame result
            frame.tracking_success = True
            frame.rel_to_keyframe = (prev_rel @ stats_ff[5:21].reshape(4, 4)).astype(np.float32)
            last_kf.local_frames.append(frame.index)
            self.fail_count = 0
        else:
            # or hold the previous pose
            self.fail_count += 1
            frame.tracking_success = False
            frame.rel_to_keyframe = (prev_rel.copy() if prev_rel is not None
                                     else np.eye(4, dtype=np.float32))
        if self.cfg.refine_stale:
            # re-register directly against the adopted keyframe off the
            # critical path, adopted when it lands
            self._dispatch_refine(frame, kp, last_kf)
        self._prev_kp = kp
        return frame

    def _dispatch_refine(self, frame: FrameRecord, kp: Keypoints,
                         last_kf: KeyframeRecord) -> None:
        """Re-register a stale-finalized frame against its adopted keyframe
        with the lite settings (a quarter of the hypotheses, no fine
        search: the baseline is at most a keyframe interval), as one call
        of REFINE_PROGRAMS: on the card one replay of a captured program,
        its draws made outside and copied in; the span `stale_refine`."""
        with STOPWATCH.time("stale_refine", frame=frame.index):
            kp_ref = self.frames[last_kf.frame_index].keypoints
            cfg_lite = lite_config(self.cfg)
            stats = REFINE_PROGRAMS(kp_ref, kp, self._draws(cfg_lite), cfg=cfg_lite,
                                    intr=self.intr)
            self._pending_refine.append({"frame": frame.index, "kf_slot": last_kf.slot,
                                         "fetch": async_fetch.fetch_async(stats)})
        self.refine_dispatched += 1

    def consume_pending_refine(self, force: bool = False) -> None:
        """Adopt the landed re-registrations of stale-finalized frames: the
        direct relative pose replaces the composed one; a failed one keeps
        it. Waits for none unless force=True."""
        keep = []
        for p in self._pending_refine:
            if not force and not p["fetch"].done():
                keep.append(p)
                continue
            st = async_fetch.resolve(p["fetch"])
            f = self.frames[p["frame"]]
            if st[0] > 0.5 and not f.is_keyframe and f.keyframe_slot == p["kf_slot"]:
                f.rel_to_keyframe = st[5:21].reshape(4, 4).astype(np.float32).copy()
                f.rel_pose_dev = None
                f.tracking_success = True     # a failed stale registration is rescued
                self.refine_adopted += 1
        self._pending_refine = keep

    def _store_icp_reference(self, depth: torch.Tensor) -> None:
        if self.cfg.use_icp:
            from texturefusion_torch.ops import preprocess
            self._kf_depth = depth
            self._kf_normals = preprocess.extract_normal_map(depth, self.intr)

    def final_ba(self) -> None:
        """Final global optimization (ref: GCSLAM.h:32-39 finalBA): re-weight
        every edge with Huber norms at the CURRENT poses, then BA. A
        deferred promotion and every refinement are consumed first."""
        self.consume_pending_promote()
        self.consume_pending_refine(force=True)
        n = self.n_edges
        if n > 0 and self._edge_has[:n].any():
            n_kf = max(len(self.keyframes), 1)
            new = fastba.reweight_edges(
                torch.as_tensor(self.poses[:n_kf], device=self.device), self.edges.head(n),
                self.kp_db.kp.points3d, self._edge_midx[:n], self._edge_minl[:n],
                torch.as_tensor(self._edge_has[:n], device=self.device),
                self.config.ba.huber_delta)
            for dst, src in zip(self.edges, new):
                dst[:n] = src
        self._run_ba()
