"""Checkpoint / resume for the reconstruction pipeline.

Port of texturefusion_tpu/utils/checkpoint.py (the reference has no
mid-run snapshot; SURVEY.md §5). The same layout: one .npz of the dense
arrays, under the JAX package's key names where the state is the same,
and a `.meta` pickle of the host structures, each written atomically
(temporary file + rename). The `.meta` holds numpy arrays and Python
values only, never tensors, so a file does not depend on the device
that wrote it; `load_pipeline` puts the state on the pipeline's device.

A resumed run matches an uninterrupted one: beyond what the JAX package
saves, the checkpoint holds each keyframe's integrated chunk ids and
host rgb, the pipeline's frame counter and previous keypoints, GCSLAM's
generator state, previous keypoints, ICP reference and BA record, the
volume's set of chunks awaiting GC and the allocator's freed-slot order
(the JAX package drops the integrated chunk set and the draw state:
its faults 11 and 12). A CPU and a CUDA generator hold different state:
a file resumed on the other kind of device keeps that pipeline's seeded
draws, with a warning. The meshes are derived state: every active
chunk is remeshed at the next cycle. A TexturedPipeline's texture state
is not saved (nor in the JAX package): a resumed run textures its
chunks again from the restored keyframes.

A streaming map (tsdf.max_resident_chunks > 0) is refused: its
offloaded chunks live in the streamer's host store, which the JAX
checkpoint does not save either, so such a file could not resume.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

FORMAT = "texturefusion_torch/1"
# dummy chunk id (y, z) for a freed slot while the free list is rebuilt:
# the largest coordinate the allocator's 21-bit key packing holds
_FREED_ID = (1 << 20) - 1


def _atomic_write(path: str, writer) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        writer(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _kp_arrays(prefix: str, kp, arrays: Dict[str, np.ndarray]) -> None:
    if kp is not None:
        for name, a in zip(kp._fields, kp):
            arrays[f"{prefix}_{name}"] = _np(a)


def _kp_from(prefix: str, arrays, device, index=None):
    from texturefusion_torch.slam.features import Keypoints
    if f"{prefix}_uv" not in arrays:
        return None
    return Keypoints(**{name: torch.as_tensor(
        arrays[f"{prefix}_{name}"] if index is None else arrays[f"{prefix}_{name}"][index],
        device=device) for name in Keypoints._fields})


def pipeline_state(pipe) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(arrays, meta) of a ReconstructionPipeline / TexturedPipeline, after
    its fusion thread is joined."""
    if pipe.streamer is not None:
        raise NotImplementedError(
            "a streaming map (tsdf.max_resident_chunks > 0) cannot be checkpointed: its "
            "offloaded chunks are in the streamer's host store, which is not saved")
    pipe._drain_fusion()
    vol, slam = pipe.volume, pipe.slam
    batch, origins = vol.dense_batch()
    arrays: Dict[str, np.ndarray] = {
        "sdf": _np(batch.sdf), "weight": _np(batch.weight),
        "color": _np(batch.color), "color_count": _np(batch.color_count),
        "origins": _np(origins), "poses": slam.poses.copy(),
        "chunk_ids": vol.ids.copy(), "used": vol.used.copy(),
        "db_desc": _np(slam.db.desc), "db_valid": _np(slam.db.valid),
        "row_to_slot": _np(slam._row_to_slot),
        "edge_midx": _np(slam._edge_midx), "edge_minl": _np(slam._edge_minl),
        "edge_has": slam._edge_has.copy(),
        "gen_state": slam._gen.get_state().numpy(),
        "released": np.asarray(vol.released, np.int64),
        "new_since_gc": np.asarray(sorted(vol.new_since_gc), np.int64),
    }
    for name, a in zip(slam.edges._fields, slam.edges):
        arrays[f"edge_{name}"] = _np(a)
    _kp_arrays("kpdb", slam.kp_db.kp, arrays)
    if slam.keyframes:
        kps = [slam.frames[k.frame_index].keypoints for k in slam.keyframes]
        for name in kps[0]._fields:
            arrays[f"kp_{name}"] = np.stack([_np(getattr(kp, name)) for kp in kps])
    _kp_arrays("pipe_kp_prev", pipe._kp_prev, arrays)
    _kp_arrays("slam_prev_kp", slam._prev_kp, arrays)
    if slam._kf_depth is not None:
        arrays["icp_depth"], arrays["icp_normals"] = _np(slam._kf_depth), _np(slam._kf_normals)

    def kf_state(st) -> dict:
        return {"kf_slot": st.kf_slot, "frame_index": st.frame_index,
                "depth": _np(st.depth), "rgb": _np(st.rgb), "quality": _np(st.quality),
                "local_depths": [_np(d) for d in st.local_depths],
                "local_rel_poses": [np.asarray(p) for p in st.local_rel_poses],
                "local_frame_idx": list(st.local_frame_idx),
                "depth_weight": _np(st.depth_weight),
                "integrated_pose": st.integrated_pose, "integrated": st.integrated,
                "rgb_host": st.rgb_host, "integrated_ids": st.integrated_ids,
                # staged out to host memory by the keyframe device budget
                "on_host": st.quality.device != pipe.device}

    meta: Dict[str, Any] = {
        "format": FORMAT,
        "slot_of": dict(vol.slot_of), "observations": vol.observations,
        "dirty_mesh": set(vol.dirty_mesh), "chunks_created": vol.chunks_created,
        "n_edges": slam.n_edges, "origin_count": slam.origin_count,
        "fail_count": slam.fail_count, "ba_keyframes": slam.ba_keyframes,
        "last_ba_errors": [np.asarray(e) for e in slam.last_ba_errors],
        "frames": [{k: getattr(f, k) for k in
                    ("index", "timestamp", "is_keyframe", "keyframe_slot",
                     "tracking_success", "origin_index", "blurred", "rel_to_keyframe")}
                   for f in slam.frames],
        "keyframes": [{"frame_index": k.frame_index, "slot": k.slot,
                       "origin_index": k.origin_index, "local_frames": list(k.local_frames),
                       "reg_success_count": k.reg_success_count} for k in slam.keyframes],
        "db_kf_ids": list(slam.db.kf_ids),
        "kf_states": {s: kf_state(st) for s, st in pipe.kf_states.items()},
        "stats": dict(pipe.stats),
        "dispatch_count": pipe._dispatch_count,
        "gen_device": slam._gen.device.type,
    }
    return arrays, meta


def restore_pipeline_state(pipe, arrays, meta: Dict[str, Any]) -> None:
    """Put (arrays, meta) into a freshly constructed pipeline of the same
    config, on its device."""
    from texturefusion_torch.fusion.pipeline import KeyframeFusionState
    from texturefusion_torch.slam.gcslam import FrameRecord, KeyframeRecord

    dev = pipe.device

    def put(dst: torch.Tensor, name: str) -> None:
        dst.copy_(torch.as_tensor(np.asarray(arrays[name])).to(dst.dtype))

    vol = pipe.volume
    vol.rows.put(np.arange(vol.rows.n_rows), [torch.as_tensor(np.asarray(arrays[name])) for name in
                                              ("sdf", "weight", "color", "color_count",
                                               "origins")])
    vol.ids = np.array(arrays["chunk_ids"], np.int32)
    vol.used = np.array(arrays["used"], bool)
    vol.slot_of = {tuple(int(c) for c in k): int(v) for k, v in meta["slot_of"].items()}
    active = np.nonzero(vol.used)[0].astype(np.int64)
    released = np.asarray(arrays["released"], np.int64) if "released" in arrays \
        else np.zeros(0, np.int64)
    # the allocator's free list: the never-used slots in its initial order,
    # then the freed ones in the order they were freed (a LIFO)
    dummy = np.stack([released, np.full_like(released, _FREED_ID),
                      np.full_like(released, _FREED_ID)], axis=1).astype(np.int32)
    vol.alloc.import_state(np.concatenate([active, released]),
                           np.concatenate([vol.ids[active], dummy]))
    vol.alloc.release(released)
    vol.released = released.tolist()
    vol.observations = {int(k): dict(v) for k, v in meta["observations"].items()}
    vol.dirty_mesh = {int(s) for s in meta["dirty_mesh"]} | set(active.tolist())
    vol.chunks_created = int(meta["chunks_created"])
    vol.new_since_gc = (set(np.asarray(arrays["new_since_gc"]).tolist())
                        if "new_since_gc" in arrays else set())

    slam = pipe.slam
    slam.poses = np.array(arrays["poses"], np.float32)
    for dst, name in zip(slam.edges, slam.edges._fields):
        put(dst, f"edge_{name}")
    slam.n_edges = int(meta["n_edges"])
    slam.origin_count = int(meta["origin_count"])
    slam.fail_count = int(meta["fail_count"])
    slam.ba_keyframes = int(meta.get("ba_keyframes", 0))
    slam.last_ba_errors = list(meta.get("last_ba_errors", []))
    slam.frames = [FrameRecord(**f) for f in meta["frames"]]
    slam.keyframes = [KeyframeRecord(**k) for k in meta["keyframes"]]
    for i, k in enumerate(slam.keyframes):
        slam.frames[k.frame_index].keypoints = _kp_from("kp", arrays, dev, i)
    slam.db.kf_ids = [int(k) for k in meta["db_kf_ids"]]
    put(slam.db.desc, "db_desc")
    put(slam.db.valid, "db_valid")
    put(slam._edge_midx, "edge_midx")
    put(slam._edge_minl, "edge_minl")
    slam._edge_has = np.array(arrays["edge_has"], bool)
    put(slam._row_to_slot, "row_to_slot")
    for dst, name in zip(slam.kp_db.kp, slam.kp_db.kp._fields):
        put(dst, f"kpdb_{name}")
    if "gen_state" in arrays:
        if meta.get("gen_device") == slam._gen.device.type:
            slam._gen.set_state(torch.as_tensor(np.asarray(arrays["gen_state"], np.uint8)))
        else:
            # a CPU and a CUDA generator hold different kinds of state
            warnings.warn(f"checkpoint written with a {meta.get('gen_device')} generator: "
                          f"the {slam._gen.device.type} pipeline keeps its seeded draws")
    slam._prev_kp = _kp_from("slam_prev_kp", arrays, dev)
    if "icp_depth" in arrays:
        slam._kf_depth = torch.as_tensor(arrays["icp_depth"], device=dev)
        slam._kf_normals = torch.as_tensor(arrays["icp_normals"], device=dev)

    def kf_state(st: dict) -> KeyframeFusionState:
        side = torch.device("cpu") if st.get("on_host") else dev

        def t(a, where=dev):
            return None if a is None else torch.tensor(np.asarray(a), device=where)

        ids = st.get("integrated_ids")
        return KeyframeFusionState(
            kf_slot=int(st["kf_slot"]), frame_index=int(st["frame_index"]),
            depth=t(st["depth"]), rgb=t(st["rgb"]), quality=t(st["quality"], side),
            local_depths=[t(d, side) for d in st["local_depths"]],
            local_rel_poses=[np.asarray(p) for p in st["local_rel_poses"]],
            local_frame_idx=[int(i) for i in st["local_frame_idx"]],
            depth_weight=t(st["depth_weight"]),
            integrated_pose=(None if st["integrated_pose"] is None
                             else np.asarray(st["integrated_pose"])),
            integrated=bool(st["integrated"]), rgb_host=st.get("rgb_host"),
            integrated_ids=None if ids is None else np.asarray(ids, np.int32))

    pipe.kf_states = {int(s): kf_state(st) for s, st in meta["kf_states"].items()}
    pipe.stats = dict(meta["stats"])
    pipe._dispatch_count = int(meta.get("dispatch_count", len(slam.frames)))
    pipe._kp_prev = _kp_from("pipe_kp_prev", arrays, dev)


def save_pipeline(pipe, path: str) -> None:
    """Snapshot a pipeline to `path` (.npz) and `path + ".meta"` (pickle)."""
    arrays, meta = pipeline_state(pipe)

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)

    def write_meta(tmp):
        with open(tmp, "wb") as f:
            pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)

    _atomic_write(path, write_npz)
    _atomic_write(path + ".meta", write_meta)


def load_pipeline(pipe, path: str) -> None:
    """Restore what save_pipeline wrote into a freshly constructed pipeline
    of the same config, on the pipeline's device."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    with open(path + ".meta", "rb") as f:
        meta = pickle.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: format {meta.get('format')!r}, not {FORMAT!r} (a JAX "
                         f"checkpoint goes through utils/convert.restore_jax_checkpoint)")
    restore_pipeline_state(pipe, arrays, meta)
