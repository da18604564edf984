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

What the JAX package adds to hide a high-latency device link is not
carried: deferred promotion (`defer_promote` is ignored: promotion is
synchronous), the pipelined tracker's stale-reference path, async pose
fetches and the BA bucket floors (BA runs at the true keyframe and edge
counts). The branch that is not ported raises NotImplementedError: a
`res_kf_slot` that is not the last keyframe. On one device the JAX
package's Schur BA is the dense solve; over a DeviceMesh BA is
edge-sharded (`_run_ba`, parallel/ba.py).

Random draws: every registration takes Gumbel draws from `draw_fn(cfg,
n)` ([R, H, 4, K], or [n, R, H, 4, K] for n candidates). By default they
come from one torch.Generator on the SLAM device, in the order the JAX
package splits its key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig, TrackingConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.core import se3
from texturefusion_torch.parallel import ba as pba
from texturefusion_torch.parallel.mesh import DeviceMesh, config_mesh, pad_to_multiple
from texturefusion_torch.slam import fastba, loopclosure, promote
from texturefusion_torch.slam.features import Keypoints, extract_features
from texturefusion_torch.slam.matching import (TwoViewResult, ransac_draws, register_frames,
                                               register_frames_batch, stack_keypoints)


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
        self.poses = np.tile(np.eye(4, dtype=np.float32), (max_kf, 1, 1))
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
        self.last_ba_errors: List[np.ndarray] = []
        self.ba_keyframes = 0        # the most keyframes a BA has run over
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
    def last_keyframe(self) -> Optional[KeyframeRecord]:
        return self.keyframes[-1] if self.keyframes else None

    def keyframe_pose(self, slot: int) -> np.ndarray:
        return self.poses[slot].copy()

    def frame_pose(self, idx: int) -> np.ndarray:
        """World pose of any frame: keyframe pose ∘ stored relative pose
        (ref: MultiViewGeometry.cpp:1149-1156)."""
        f = self.frames[idx]
        kf_pose = self.poses[f.keyframe_slot]
        if f.is_keyframe:
            return kf_pose
        return np.asarray(kf_pose @ f.rel_to_keyframe)

    def trajectory(self) -> np.ndarray:
        return np.stack([self.frame_pose(i) for i in range(len(self.frames))])

    # ------------------------------------------------------------ edges

    def _append_edge(self, kf_i_slot, kf_j_slot, sums, matches=None) -> None:
        e = torch.tensor([self.n_edges], device=self.device)
        fastba.write_edges(self.edges, e, kf_i_slot, kf_j_slot, [s[None] for s in sums])
        if matches is not None:
            self._store_edge_matches(self.n_edges, *matches)
        self.n_edges += 1

    def _add_virtual_edge(self, kf_i_slot: int, kf_j_slot: int, rel_pose: np.ndarray,
                          n_pts: int = 64, weight: float = 0.5) -> None:
        """Odometry-prior edge from a relative pose without shared features:
        virtual points p = T_rel·q tie the two keyframes in FastBA."""
        if self.n_edges >= self.config.ba.max_edges:
            return
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
        if self.n_edges >= self.config.ba.max_edges:
            return
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
        MultiViewGeometry.cpp:1209-1217, at every new keyframe), at the true
        keyframe and edge counts. On one device it is dense at any keyframe
        count: from `schur_min_keyframes` on, the JAX package runs its
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
        edges = self.edges.head(self.n_edges)
        if self.mesh is None:
            poses = torch.as_tensor(self.poses[:n_kf], device=self.device)
            active = torch.ones(n_kf, dtype=torch.bool, device=self.device)
            new_poses, edges, errs = fastba.optimize(poses, edges, n_kf, active, cfg)
            valid = edges.valid
        else:
            n_pad = pad_to_multiple(n_kf, self.mesh.size)
            dev0 = self.mesh.devices[0]
            # identity rows past the true count: the pose array need not
            # hold n_pad rows when the mesh size does not divide its capacity
            pad = np.tile(np.eye(4, dtype=np.float32), (n_pad - n_kf, 1, 1))
            poses = torch.as_tensor(np.concatenate([self.poses[:n_kf], pad]), device=dev0)
            active = torch.arange(n_pad, device=dev0) < n_kf
            new_poses, valid, errs = pba.ba_rounds(
                poses, edges, n_pad, active, cfg, self.mesh,
                use_schur=n_kf >= cfg.schur_min_keyframes,
                sep_budget=cfg.schur_separator_budget)
            new_poses = new_poses[:n_kf]
        self.last_ba_errors = list(errs.cpu().numpy())
        self.ba_keyframes = max(self.ba_keyframes, n_kf)
        self.poses[:n_kf] = new_poses.cpu().numpy()
        self.edges.valid[:self.n_edges] = valid.to(self.device)

    # ------------------------------------------------------------ keyframes

    def _promote_keyframe(self, frame: FrameRecord, kp: Keypoints,
                          pose_world: np.ndarray) -> KeyframeRecord:
        slot = len(self.keyframes)
        self.poses[slot] = pose_world
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
                if self.n_edges < self.config.ba.max_edges:
                    self._append_edge(kf_c.slot, kf.slot, sums, matches)
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

    def _probe_candidates(self, kp: Keypoints, tracked_stats: Optional[np.ndarray]):
        """Candidate selection + registration + edge pre-integration
        (slam/promote.py). Returns ([(KeyframeRecord, stats[21], row)], probe)."""
        n_cand = max(self.cfg.max_candidates, 2)
        have_tracked = tracked_stats is not None
        ts = torch.as_tensor(np.asarray(tracked_stats, np.float32) if have_tracked
                             else np.zeros(21, np.float32), device=self.device)
        probe = promote.promote_probe(
            self.kp_db.kp, self.db.desc, self.db.valid, self._row_to_slot, len(self.db),
            self.last_keyframe.slot, kp, ts, have_tracked, self._draws(self.cfg, n_cand),
            self.cfg.salient_score_threshold, self.config.ba.huber_delta, self.cfg,
            self.intr, n_cand)
        fetched = probe.fetch.cpu().numpy().reshape(n_cand, 25)
        results = []
        seen = set()
        for i in range(n_cand):
            slot = int(fetched[i, 0])
            if fetched[i, 1] < 0.5 or slot in seen:
                continue
            seen.add(slot)
            results.append((self.keyframes[slot], fetched[i, 2:23], i))
        return results, probe

    def _append_probe_edges(self, probe: promote.PromoteProbe, rows: List[int],
                            kf_slot: int) -> int:
        """Append the taken probe candidates as edges + raw-match rows."""
        rows = rows[:self.config.ba.max_edges - self.n_edges]
        if not rows:
            return 0
        n0, n = self.n_edges, len(rows)
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
        `res_kf_slot` names the keyframe `res` was computed against and
        must be the last keyframe."""
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
            raise NotImplementedError(
                f"res was registered against keyframe {res_kf_slot}, not the last keyframe "
                f"{last_kf.slot}: the pipelined tracker's stale-reference path is not ported")
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

    def _store_icp_reference(self, depth: torch.Tensor) -> None:
        if self.cfg.use_icp:
            from texturefusion_torch.ops import preprocess
            self._kf_depth = depth
            self._kf_normals = preprocess.extract_normal_map(depth, self.intr)

    def final_ba(self) -> None:
        """Final global optimization (ref: GCSLAM.h:32-39 finalBA): re-weight
        every edge with Huber norms at the CURRENT poses, then BA."""
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
