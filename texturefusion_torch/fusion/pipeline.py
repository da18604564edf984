"""End-to-end reconstruction pipeline: tracking, fusion at the tracked
poses, drift reintegration, meshing and the map's lifecycle.

Port of texturefusion_tpu/fusion/pipeline.py `ReconstructionPipeline`
(ref: GCFusion/MobileFusion.{h,cpp} — tsdfFusion :274-406,
ReIntegrateKeyframe :114-221, IntegrateFrame :223-250,
clearRedudentFrameMemory :71-90, MapManagement :92-112; main.cpp:102-211
per-frame loop), with the JAX package's synchronous behaviour
(ParallelConfig pipelined_tracking=False, async_cycle_results=False):
each frame is tracked and decided in the call that takes it.

Per frame: preprocessing (first frame) or `frame_step_tracked2` against
the last keyframe and the previous frame, then GCSLAM.update_frame. A
promotion stores the keyframe's fusion state and runs a fusion cycle for
the keyframe before it:
  1. drift reintegration of integrated keyframes whose BA pose moved
     (fusion/dynamics.py): over the recorded chunk set when it is still
     valid, else a de-integration and a fresh integration;
  2. integration of the finished keyframe (origin 0 only; a fresh
     discovery at its current pose) and of its local frames, depth only;
  3. incremental meshing;
  4. the texture stage (TexturedPipeline) and GC of empty chunks;
  5. the keyframe device budget, and chunk streaming when
     tsdf.max_resident_chunks > 0.

TexturedPipeline adds the texture stage (texture/manager.py) to each
cycle and to finish(), and the textured OBJ/MTL/PNG export.

With parallel.async_fusion the cycles run in order on one worker thread
with its own CUDA stream (the reference's map thread,
MobileFusion.cpp:92-112). What the JAX package does to hide a slow
device link is not carried: the pipelined tracker (pipelined_tracking,
pipeline_depth, pipeline_max_ride and async_cycle_results are read and
ignored), the discovery prefetch and its deferred integration, the
deferred GC probe and the async pose fetch (drift is measured at the
current poses).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import time
import types
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.fusion import dynamics
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.fusion.mesher import IncrementalMesher
from texturefusion_torch.fusion.streaming import ChunkStreamer
from texturefusion_torch.models.reconstruction import frame_step_tracked2
from texturefusion_torch.ops import preprocess
from texturefusion_torch.parallel.mesh import DeviceMesh, same_device, tsdf_mesh
from texturefusion_torch.slam.gcslam import GCSLAM
from texturefusion_torch.texture.manager import TextureManager
from texturefusion_torch.utils.stopwatch import STOPWATCH


@dataclasses.dataclass
class KeyframeFusionState:
    """Everything needed to (re-)integrate a keyframe."""

    kf_slot: int
    frame_index: int
    depth: torch.Tensor                 # refined depth, on the pipeline's device
    rgb: torch.Tensor                   # uint8 [H, W, 3], on the device
    quality: torch.Tensor
    local_depths: List[torch.Tensor]    # depth-only local frames
    local_rel_poses: List[np.ndarray]   # frame -> keyframe relative poses
    local_frame_idx: List[int] = dataclasses.field(default_factory=list)
    depth_weight: Optional[torch.Tensor] = None   # running refinement weight
    integrated_pose: Optional[np.ndarray] = None
    integrated: bool = False
    rgb_host: Optional[np.ndarray] = None         # uint8 host copy
    integrated_ids: Optional[np.ndarray] = None   # chunk ids [N, 3] at integration

    def rgb_np(self) -> np.ndarray:
        """Host uint8 copy, read once."""
        if self.rgb_host is None:
            self.rgb_host = self.rgb.cpu().numpy()
        return self.rgb_host

    def release_device_memory(self) -> None:
        """Move what an integrated keyframe needs only for a rare drift
        reintegration (local depths, quality) to host memory and drop the
        refinement weight, which only the newest keyframe uses (ref:
        clearRedudentFrameMemory MobileFusion.cpp:71-90)."""
        self.local_depths = [d.cpu() for d in self.local_depths]
        self.quality = self.quality.cpu()
        self.depth_weight = None


class ReconstructionPipeline:
    """`draw_fn` is GCSLAM's (every RANSAC draw of a promotion or retry);
    `frame_draws(frame_index)` returns the per-frame draws of
    frame_step_tracked2 (vs keyframe, vs previous frame). Both default to
    the seeded generators.

    `mesh` shards the TSDF rows and the mesh pool over its devices (slot s
    on shard s % n) and BA's edges; without one, parallel.tsdf_sharded
    builds a mesh of parallel.n_devices devices (all when None) of the
    pipeline's device type when more than one exists, as the JAX package
    does (fusion/pipeline.py:103-115)."""

    def __init__(self, config: PipelineConfig, device="cuda",
                 draw_fn: Optional[Callable] = None,
                 frame_draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
                 mesh: Optional[DeviceMesh] = None):
        self.config = config
        self.device = torch.device(device)
        if mesh is None and config.parallel.tsdf_sharded:
            mesh = tsdf_mesh(config.parallel.n_devices, self.device)
        if mesh is not None and not same_device(mesh.devices[0], self.device):
            raise ValueError(f"the mesh starts on {mesh.devices[0]}, the pipeline is on "
                             f"{self.device}")
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.slam = GCSLAM(config, device=self.device, draw_fn=draw_fn, mesh=mesh)
        self.volume = TSDFVolume(config, device=self.device, mesh=mesh)
        self.mesher = IncrementalMesher(self.volume)
        self.streamer = None
        if config.tsdf.max_resident_chunks > 0:
            self.streamer = ChunkStreamer(self.volume, config.tsdf.max_resident_chunks,
                                          offload_radius=config.tsdf.streaming_radius)
            self.volume.streamer = self.streamer
        self.kf_states: Dict[int, KeyframeFusionState] = {}
        self._frame_draws = frame_draws
        self._dispatch_count = 0
        self._kp_prev = None
        self.stats = {"frames": 0, "keyframes": 0, "reintegrations": 0,
                      "reintegrations_reuse": 0, "reintegrations_full": 0}
        # the map thread: cycles in order on one worker, on their own stream
        self._fusion_executor = None
        self._fusion_future = None
        self._fusion_stream = None
        if config.parallel.async_fusion:
            self._fusion_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fusion")
            if self.device.type == "cuda":
                self._fusion_stream = torch.cuda.Stream(self.device)

    # --------------------------------------------------------------- threads

    def _submit_fusion(self, slot: int) -> None:
        if self._fusion_executor is None:
            self.fusion_cycle(slot)
            return
        prev = self._fusion_future
        ready = None
        if self._fusion_stream is not None:
            # the keyframe tensors the cycle reads were made on this
            # (the tracking) stream: the fusion stream waits for them
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def run():
            if prev is not None:
                prev.result()           # cycles stay ordered; errors surface
            if self._fusion_stream is None:
                self.fusion_cycle(slot)
                return
            with torch.cuda.stream(self._fusion_stream):
                self._fusion_stream.wait_event(ready)
                self.fusion_cycle(slot)

        self._fusion_future = self._fusion_executor.submit(run)

    def _drain_fusion(self) -> None:
        """Join the fusion thread: after this the map may be read here."""
        if self._fusion_future is not None:
            self._fusion_future.result()
            self._fusion_future = None
        if self._fusion_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._fusion_stream)

    def _on_fusion_stream(self, *tensors: Optional[torch.Tensor]) -> None:
        """Tensors made on the tracking stream and read by the fusion
        thread: the caching allocator must not hand their memory back
        until the fusion stream's reads are done."""
        if self._fusion_stream is None:
            return
        stream = torch.cuda.current_stream(self.device)
        if stream == torch.cuda.default_stream(self.device):
            return
        for t in tensors:
            if t is not None and t.is_cuda:
                t.record_stream(stream)

    def close(self) -> None:
        """Join and stop the fusion thread."""
        self._drain_fusion()
        if self._fusion_executor is not None:
            self._fusion_executor.shutdown(wait=True)
            self._fusion_executor = None

    # --------------------------------------------------------------- frames

    def _to_device(self, x) -> Optional[torch.Tensor]:
        if x is None:
            return None
        return torch.as_tensor(x).to(self.device)

    def process_frame(self, depth_raw, rgb=None, timestamp: float = 0.0,
                      host_packed: Optional[np.ndarray] = None) -> None:
        """Track one frame; fuse at keyframe boundaries (ref:
        main.cpp:102-211). `depth_raw` is a packed [H, W, 5] uint8 frame
        (preprocess.pack_frame) with rgb=None, or a depth plane with its
        rgb; numpy arrays or tensors on any device. `host_packed` is the
        caller's host copy of a packed frame: a keyframe then takes its
        host rgb from those bytes instead of reading the card."""
        with STOPWATCH.time("upload"):
            depth_raw, rgb = self._to_device(depth_raw), self._to_device(rgb)
        intr, tcfg = self.intr, self.config.tracking
        last_kf = self.slam.last_keyframe
        kw, fused_kf = {}, None
        blur_thresh = tcfg.blur_threshold
        with STOPWATCH.time("preprocess"):
            if last_kf is None:
                bundle = preprocess.preprocess_bundle(
                    depth_raw, rgb, intr, depth_scale=self.config.camera.depth_scale)
                blurred = ((lambda b=bundle[4]: bool(float(b) < blur_thresh))
                           if blur_thresh > 0 else False)
            else:
                kp_ref = self.slam.frames[last_kf.frame_index].keypoints
                kp_prev = self._kp_prev if self._kp_prev is not None else kp_ref
                st_ref = self.kf_states.get(last_kf.slot)
                if st_ref is not None:
                    # read once: the fusion thread's budget pass may drop
                    # depth_weight between a check and a use
                    kf_depth, kf_weight = st_ref.depth, st_ref.depth_weight
                    if kf_weight is None:
                        kf_weight = (kf_depth > 0).to(torch.float32)
                        st_ref.depth_weight = kf_weight
                else:
                    kf_depth = torch.zeros((intr.height, intr.width), device=self.device)
                    kf_weight = torch.zeros_like(kf_depth)
                draws = None
                if self._frame_draws is not None:
                    draws = tuple(d.to(self.device)
                                  for d in self._frame_draws(self._dispatch_count))
                bundle, kp, res, res_ff, stats2, f_depth, f_weight = frame_step_tracked2(
                    depth_raw, rgb, kp_ref, kp_prev, kf_depth, kf_weight, self.slam.base_seed,
                    self._dispatch_count, intr, tcfg, self.config.camera.depth_scale,
                    draws=draws)
                fused_kf = (f_depth, f_weight)
                self._kp_prev = kp
                s2 = stats2.cpu().numpy()           # the frame's one host read
                blurred = bool(s2[42] < blur_thresh) if blur_thresh > 0 else False
                kw = dict(kp=kp, res=res, res_kf_slot=last_kf.slot, stats=s2[:21],
                          res_ff=res_ff, stats_ff=s2[21:42])
        self._dispatch_count += 1
        depth_refined, _normals, quality, gray, _blur, rgb_f = bundle
        n_kf = len(self.slam.keyframes)
        t0 = time.perf_counter()
        frame = self.slam.update_frame(gray, depth_refined, timestamp, blurred=blurred, **kw)
        # a promotion's probes, edges and BA ran inside update_frame
        STOPWATCH.add("promotion" if len(self.slam.keyframes) > n_kf and n_kf else "tracking",
                      time.perf_counter() - t0)
        self.stats["frames"] += 1

        if frame.is_keyframe:
            host_rgb = None
            if host_packed is not None and host_packed.ndim == 3 and host_packed.shape[-1] == 5:
                host_rgb = np.ascontiguousarray(host_packed[..., 2:5])
            self.kf_states[frame.keyframe_slot] = KeyframeFusionState(
                kf_slot=frame.keyframe_slot, frame_index=frame.index, depth=depth_refined,
                rgb=(rgb_f * 255.0).to(torch.uint8), quality=quality, rgb_host=host_rgb,
                local_depths=[], local_rel_poses=[])
            self.stats["keyframes"] += 1
            # the previous keyframe is finished: its fusion cycle
            # (ref: MobileFusion.cpp:274-406 runs on kflist.size()-2)
            if frame.keyframe_slot >= 1:
                self._submit_fusion(frame.keyframe_slot - 1)
            return
        # a local frame: depth for the depth-only passes, and the
        # keyframe refinement (ref: main.cpp:124-135; MobileFusion.cpp:187-203)
        st = self.kf_states.get(frame.keyframe_slot)
        if st is None or not frame.tracking_success:
            return
        if len(st.local_depths) < self.config.tsdf.local_frames_per_keyframe:
            st.local_depths.append(depth_refined)
            st.local_rel_poses.append(frame.rel_to_keyframe)
            st.local_frame_idx.append(frame.index)
        if st.integrated:
            return
        with STOPWATCH.time("kf_refine"):
            if fused_kf is not None and frame.keyframe_slot == kw.get("res_kf_slot"):
                st.depth, st.depth_weight = fused_kf
            else:
                if st.depth_weight is None:
                    st.depth_weight = (st.depth > 0).to(torch.float32)
                rel = (frame.rel_pose_dev if frame.rel_pose_dev is not None
                       else torch.as_tensor(frame.rel_to_keyframe, dtype=torch.float32,
                                            device=self.device))
                st.depth, st.depth_weight = preprocess.fuse_depth_into_keyframe(
                    st.depth, st.depth_weight, depth_refined, rel, intr)

    def finish(self) -> None:
        """Fuse the keyframes left and reintegrate every drifted one at the
        final BA poses (ref: main.cpp:213-317)."""
        self._drain_fusion()
        self.slam.final_ba()
        for slot in range(len(self.slam.keyframes)):
            st = self.kf_states.get(slot)
            if st is not None and not st.integrated:
                self.fusion_cycle(slot)
        self._reintegrate_drifted(max_updates=len(self.slam.keyframes))
        self.mesher.update_meshes()
        self._texture_final()

    # --------------------------------------------------------------- fusion

    def _kf_rgb(self, st: KeyframeFusionState) -> torch.Tensor:
        return st.rgb.to(torch.float32) / 255.0

    def _recorded_slots(self, st: KeyframeFusionState, allocate: bool) -> np.ndarray:
        """The keyframe's integrated chunks at their current slots. GC and
        streaming recycle slots, so what is recorded is the chunk ids,
        and the slots are found again from them: offloaded chunks are
        restored first, and with `allocate` the chunks GC freed (they held
        no weight) are created again, so that a pass at a new pose can
        write into them. A slot that now holds another chunk is never
        written."""
        if self.streamer is not None:
            self.streamer.ensure_resident(st.integrated_ids)
        slots = (self.volume.allocate if allocate else self.volume.lookup)(st.integrated_ids)
        return slots[slots >= 0].astype(np.int64)

    def _integrate_keyframe(self, st: KeyframeFusionState, sign: float) -> None:
        vol = self.volume
        with STOPWATCH.time("i_pose"):
            pose = st.integrated_pose if sign < 0 else self.slam.keyframe_pose(st.kf_slot)
        depth, quality = st.depth.to(self.device), st.quality.to(self.device)
        self._on_fusion_stream(st.depth, st.rgb, st.quality, *st.local_depths)
        if sign < 0 and st.integrated_ids is not None:
            # de-integration touches exactly the integrated chunk set
            slots = self._recorded_slots(st, allocate=False)
        else:
            with STOPWATCH.time("i_disco"):
                slots = vol.discover_chunks(
                    depth, torch.as_tensor(pose, dtype=torch.float32, device=self.device),
                    allocate=sign > 0)
        with STOPWATCH.time("i_frame"):
            slots = vol.integrate_frame(depth, self._kf_rgb(st), quality, pose,
                                        keyframe_id=st.kf_slot, sign=sign, slots=slots)
        if sign > 0 and not st.integrated and st.local_frame_idx:
            # the local frames' final relative poses, frozen from here on so
            # that de-integration and reintegration cancel exactly
            st.local_rel_poses = [self.slam.frames[i].rel_to_keyframe
                                  for i in st.local_frame_idx]
        if st.local_depths:
            with STOPWATCH.time("i_locals"):
                vol.integrate_local_depths(st.local_depths,
                                           [pose @ rel for rel in st.local_rel_poses],
                                           slots, sign=sign)
        if sign > 0:
            st.integrated_pose = np.asarray(pose)
            st.integrated_ids = vol.ids[np.asarray(slots, np.int64)].copy()
            st.integrated = True
        else:
            st.integrated = False

    def fusion_cycle(self, finished_slot: int) -> None:
        """One map-thread cycle (ref: MobileFusion.cpp:274-406 tsdfFusion)."""
        with STOPWATCH.time("reintegration"):
            self._reintegrate_drifted()
        st = self.kf_states.get(finished_slot)
        if (st is not None and not st.integrated
                and self.slam.keyframes[finished_slot].origin_index == 0):
            # only origin-0 keyframes are fused (ref: MobileFusion.cpp:245)
            with STOPWATCH.time("integration"):
                self._integrate_keyframe(st, sign=1.0)
        with STOPWATCH.time("meshing"):
            self.mesher.update_meshes()
        self._texture_cycle()
        # housekeeping (ref: Chisel.h:184-216 GC; MobileFusion.cpp:71-90)
        with STOPWATCH.time("gc"):
            freed = self.volume.gc_new_chunks()
            if len(freed):
                self.mesher.drop(freed)
            self._keyframe_budget()
            if (self.streamer is not None
                    and self.volume.n_active() > self.config.tsdf.max_resident_chunks):
                cam_pos = self.slam.keyframe_pose(finished_slot)[:3, 3]
                before = self.volume.active_slots()
                # freeze the meshes before the slots are recycled: rows of
                # the chunks about to leave
                self.streamer.offload_cold(cam_pos)
                gone = np.setdiff1d(before, self.volume.active_slots())
                if len(gone):
                    self.mesher.freeze(gone)

    def _keyframe_budget(self) -> None:
        """Stage out the oldest integrated keyframes while the keyframe
        state on the device exceeds tsdf.keyframe_device_budget_mb."""
        budget = self.config.tsdf.keyframe_device_budget_mb * 2**20
        states = sorted(list(self.kf_states.items()), key=lambda kv: kv[0])  # a snapshot
        newest = states[-1][0] if states else -1
        resident = [st for s, st in states
                    if st.integrated and st.depth_weight is not None
                    and s != newest]      # tracking still refines the newest
        approx = sum(self._kf_device_bytes(st) for st in resident)
        for st in resident:
            if approx <= budget:
                break
            approx -= self._kf_device_bytes(st)
            st.release_device_memory()

    def _kf_device_bytes(self, st: KeyframeFusionState) -> int:
        """Bytes of a keyframe's stageable state on the pipeline's device
        (local depths, quality, refinement weight)."""
        ts = list(st.local_depths) + [st.quality, st.depth_weight]
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None and t.device == self.device)

    def _reintegrate_drifted(self, max_updates: int = 4) -> None:
        """De-integrate at the old pose, re-integrate at the optimized pose
        (ref: MobileFusion.cpp:114-221 ReIntegrateKeyframe; scheduling
        :289-315)."""
        slots = [s for s, st in list(self.kf_states.items()) if st.integrated]
        if not slots:
            return
        current = np.stack([self.slam.keyframe_pose(s) for s in slots])
        integrated = np.stack([self.kf_states[s].integrated_pose for s in slots])
        picked = dynamics.select_keyframes_to_update(
            dynamics.pose_drift_costs(current, integrated), max_updates)
        for i in picked:
            st = self.kf_states[slots[i]]
            pose_new, pose_old = current[i], st.integrated_pose
            # the recorded chunk set stays valid while the corrected pose
            # moved less than a fraction of the chunk extent: camera
            # translation plus the rotation's sweep at half the far plane
            # (ref: kf.validChunks reuse, MobileFusion.cpp:128-143)
            delta = float(np.linalg.norm(pose_new[:3, 3] - pose_old[:3, 3]))
            cosang = (np.trace(pose_new[:3, :3].T @ pose_old[:3, :3]) - 1) / 2
            sweep = delta + float(np.arccos(np.clip(cosang, -1.0, 1.0))) * self.intr.far * 0.5
            reuse = st.integrated_ids is not None and sweep < 0.75 * self.volume.extent
            with STOPWATCH.time("r_retract"):
                self.volume.retract_observations(st.kf_slot)
            if reuse:
                with STOPWATCH.time("r_fused"):
                    rec = self._recorded_slots(st, allocate=True)
                    self._on_fusion_stream(st.depth, st.rgb, st.quality, *st.local_depths)
                    self.volume.reintegrate_frame(
                        st.depth.to(self.device), self._kf_rgb(st),
                        st.quality.to(self.device), pose_old, pose_new, st.kf_slot, rec)
                    self.volume.reintegrate_local_depths(
                        st.local_depths, [pose_old @ r for r in st.local_rel_poses],
                        [pose_new @ r for r in st.local_rel_poses], rec)
                st.integrated_pose = np.asarray(pose_new)
                st.integrated_ids = self.volume.ids[rec].copy()
                self.stats["reintegrations_reuse"] += 1
            else:
                with STOPWATCH.time("r_deint"):
                    self._integrate_keyframe(st, sign=-1.0)
                with STOPWATCH.time("r_reint"):
                    self._integrate_keyframe(st, sign=+1.0)
                self.stats["reintegrations_full"] += 1
            self.stats["reintegrations"] += 1

    def _texture_cycle(self) -> None:
        """Hook for the texture stage of each fusion cycle (TexturedPipeline)."""

    def _texture_final(self) -> None:
        """Hook for the texture catch-up at the end of finish() (TexturedPipeline)."""

    # --------------------------------------------------------------- export

    def export_mesh(self, path: str, weld: bool = True) -> int:
        """PLY export; `weld` merges the chunk-boundary vertices that each
        chunk's mesh repeats, by clustering at a quarter voxel (ref:
        CompressMeshes Chisel.cpp:112-147). Returns the vertex count."""
        from texturefusion_torch.io import ply
        from texturefusion_torch.ops.simplify import simplify_by_clustering

        self._drain_fusion()
        verts, faces, colors, normals = self.mesher.full_mesh()
        if weld and len(verts):
            verts, faces, colors, normals = simplify_by_clustering(
                verts, faces, self.config.tsdf.voxel_resolution * 0.25, colors, normals)
        ply.save_ply(path, verts, faces, colors, normals)
        return len(verts)

    def trajectory(self) -> np.ndarray:
        return self.slam.trajectory()

    def save_trajectory(self, path: str, timestamps=None) -> None:
        from texturefusion_torch.io import ply
        if timestamps is None:
            timestamps = [f.timestamp for f in self.slam.frames]
        ply.save_trajectory_tum(path, timestamps, self.trajectory())

    def save_keyframe_textures(self, out_dir: str) -> int:
        """Per-keyframe %06d.cam + %06d.png dump (ref: main.cpp:287-313):
        the camera file holds the world-to-camera pose (3×4, row-major)
        and fx fy cx cy; the PNG the keyframe's rgb, written through
        io/png. Returns the number of keyframes written."""
        from texturefusion_torch.io import png

        self._drain_fusion()
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for slot, st in sorted(self.kf_states.items()):
            w2c = np.linalg.inv(self.slam.keyframe_pose(slot))
            vals = list(w2c[:3].reshape(-1)) + [self.intr.fx, self.intr.fy,
                                                self.intr.cx, self.intr.cy]
            with open(os.path.join(out_dir, f"{slot:06d}.cam"), "w") as f:
                f.write(" ".join(f"{v:.8f}" for v in vals) + "\n")
            png.write_png(os.path.join(out_dir, f"{slot:06d}.png"), st.rgb_np())
            n += 1
        return n

    def memory_stats(self) -> Dict[str, float]:
        """Approximate memory accounting in MB (ref: Frame::GetOccupiedMemorySize
        frame.h:68-99)."""
        self._drain_fusion()
        vol = self.volume

        def nbytes(t):
            return t.numel() * t.element_size()

        dev = vol.rows.nbytes()
        kf = sum(nbytes(st.depth) + nbytes(st.rgb) + nbytes(st.quality)
                 + sum(nbytes(d) for d in st.local_depths)
                 for st in self.kf_states.values())
        meshes = sum(sum(a.nbytes for a in m) for m in self.mesher.meshes.values())
        return {"device_tsdf_mb": float(dev) / 2**20,
                "keyframe_cache_mb": float(kf) / 2**20,
                "mesh_cache_mb": float(meshes) / 2**20,
                "chunks_active": float(vol.n_active())}

    def save_stats(self, out_dir: str) -> None:
        """stat.txt and chunk.txt (ref: main.cpp:213-235)."""
        os.makedirs(out_dir, exist_ok=True)
        mem = self.memory_stats()
        with open(os.path.join(out_dir, "stat.txt"), "w") as f:
            f.write(STOPWATCH.report() + "\n")
            for k, v in self.stats.items():
                f.write(f"{k}: {v}\n")
            for k, v in mem.items():
                f.write(f"{k}: {v:.2f}\n")
        with open(os.path.join(out_dir, "chunk.txt"), "w") as f:
            f.write(f"chunks_created {self.volume.chunks_created} "
                    f"active {self.volume.n_active()} "
                    f"meshed {len(self.mesher.meshes)}\n")


class TexturedPipeline(ReconstructionPipeline):
    """The pipeline with online texturing, the reference's whole
    TextureFusion behaviour (ref: MobileFusion.cpp:356-384, the texture
    stages of tsdfFusion). Each fusion cycle runs one texture cycle after
    meshing (STOPWATCH "texture"); finish() re-selects and patches every
    meshed chunk against the final observations and poses
    ("texture_final").

    With a sharded volume (`mesh`, or parallel.tsdf_sharded) the texture
    state and the keyframe stack stay on the pipeline's device, the
    mesh's first, and each cycle gathers the pool rows of the chunks it
    projects from their shards (IncrementalMesher.pool_reader). With the
    fusion thread those gathers run on it, after each shard's remesh: a
    copy between two cards follows the work queued on both cards'
    current streams of the thread that makes it."""

    def __init__(self, config: PipelineConfig, device="cuda",
                 draw_fn: Optional[Callable] = None,
                 frame_draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
                 mesh: Optional[DeviceMesh] = None):
        super().__init__(config, device=device, draw_fn=draw_fn, frame_draws=frame_draws,
                         mesh=mesh)
        self.texture = TextureManager(config, device=self.device)
        self.mesher.on_drop = self.texture.release
        # per submitted cycle, in order: the newest keyframe and each
        # keyframe's (rgb, depth, BA pose) as they were at submission.
        # Tracking replaces the newest keyframe's depth as it refines it,
        # on its own stream, and a later promotion's BA moves the poses;
        # the cycle reads the tensors covered by its event and the poses
        # a synchronous cycle would read.
        self._cycle_inputs = collections.deque()

    def _keyframe_inputs(self) -> dict:
        return {s: (st.rgb, st.depth, self.slam.keyframe_pose(s))
                for s, st in list(self.kf_states.items())}

    def _submit_fusion(self, slot: int) -> None:
        self._cycle_inputs.append((len(self.slam.keyframes) - 1, self._keyframe_inputs()))
        super()._submit_fusion(slot)

    def _tex_states(self, inputs: Optional[dict] = None) -> dict:
        """Keyframe slot → BA pose, rgb and depth tensors and the host rgb
        for the atlas blits; `inputs` from a submission, else current."""
        states = {}
        for slot, (rgb, depth, pose) in (inputs or self._keyframe_inputs()).items():
            self._on_fusion_stream(rgb, depth)
            states[slot] = types.SimpleNamespace(pose=pose, rgb=rgb, depth=depth,
                                                 rgb_host=self.kf_states[slot].rgb_np)
        return states

    def _texture_cycle(self) -> None:
        newest, inputs = (self._cycle_inputs.popleft() if self._cycle_inputs
                          else (len(self.slam.keyframes) - 1, None))
        if newest < 0:
            return
        with STOPWATCH.time("texture"):
            self.texture.update(self.volume, self.mesher, self._tex_states(inputs),
                                newest_kf=newest, remeshed=self.mesher.last_remeshed)

    def _texture_final(self) -> None:
        """Catch-up: every meshed chunk selected and patched again against
        the final observations and BA poses, in budget-limited passes."""
        if not self.slam.keyframes:
            return
        want = set(np.nonzero(self.mesher.tcount[:-1] > 0)[0].tolist())
        with STOPWATCH.time("texture_final"):
            for _ in range(16):
                self.texture.update(self.volume, self.mesher, self._tex_states(),
                                    newest_kf=len(self.slam.keyframes) - 1, remeshed=want)
                want = set()
                if not self.texture._carry or self.texture.atlas.overflowed:
                    break   # caught up, or no atlas space left to place work

    def export_textured(self, out_dir: str, name: str = "model") -> str:
        """OBJ + MTL + PNG of the textured resident chunks."""
        self._drain_fusion()
        return self.texture.export_textured(self.mesher, out_dir, name)
