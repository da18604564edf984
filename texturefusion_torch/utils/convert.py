"""State carried between the JAX package and the port, as numpy arrays.

The system has no weights: its state is the TSDF volume, the mesh pool
and the SLAM state (keypoints, pose-graph edges, keyframe poses, the
loop-closure descriptor DB). These build the port's objects from the
JAX package's arrays (fetched with np.asarray), so both packages can
start from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from texturefusion_torch.config import PipelineConfig
from texturefusion_torch.fusion.chunkmap import TSDFVolume
from texturefusion_torch.ops import marching_cubes as mc


def volume_state_from_numpy(config: PipelineConfig, sdf: np.ndarray,
                            weight: np.ndarray, color: np.ndarray,
                            color_count: np.ndarray, origins: np.ndarray,
                            ids: np.ndarray, used: np.ndarray,
                            device="cuda") -> TSDFVolume:
    """A port TSDFVolume holding these rows ([cap+1, 512], color
    [cap+1, 512, 3], origins [cap+1, 3]) with the allocated chunk ids
    (ids [cap, 3], used [cap]) registered at the same slots."""
    vol = TSDFVolume(config, device=device)
    for dst, src in zip(vol.batch, (sdf, weight, color, color_count)):
        dst.copy_(torch.tensor(np.asarray(src, np.float32)))
    vol.origins.copy_(torch.tensor(np.asarray(origins, np.float32)))
    slots = np.nonzero(np.asarray(used, bool))[0].astype(np.int64)
    slot_ids = np.asarray(ids, np.int32)[slots]
    vol.alloc.import_state(slots, slot_ids)
    vol.ids[slots] = slot_ids
    vol.used[slots] = True
    vol.slot_of = {tuple(c): int(s) for s, c in zip(slots.tolist(), slot_ids.tolist())}
    vol.chunks_created = len(slots)
    return vol


def keypoints_from_numpy(kp, device="cuda"):
    """A port Keypoints from a JAX Keypoints' arrays (any tuple in field
    order; leading batch axes allowed). The uint32 descriptor words are
    viewed as int32 with the same bits."""
    from texturefusion_torch.slam.features import Keypoints
    arrs = [np.asarray(a) for a in kp]
    arrs[4] = np.ascontiguousarray(arrs[4]).view(np.int32)
    return Keypoints(*(torch.tensor(a, device=device) for a in arrs))


def edges_from_numpy(edges, device="cuda"):
    """A port EdgeSums from a JAX EdgeSums' arrays (indices as int64)."""
    from texturefusion_torch.slam.fastba import EdgeSums
    arrs = [np.asarray(a) for a in edges]
    arrs[0], arrs[1] = arrs[0].astype(np.int64), arrs[1].astype(np.int64)
    return EdgeSums(*(torch.tensor(a, device=device) for a in arrs))


def poses_from_numpy(poses, device="cuda") -> torch.Tensor:
    """[..., 4, 4] pose array as float32."""
    return torch.tensor(np.asarray(poses, np.float32), device=device)


def descriptor_db_from_numpy(desc, valid, kf_ids, device="cuda"):
    """A port KeyframeDescriptorDB holding a JAX DB's rows (desc
    [R, S, 8] uint32, valid [R, S]) and its keyframe ids."""
    from texturefusion_torch.slam.loopclosure import KeyframeDescriptorDB
    desc = np.ascontiguousarray(np.asarray(desc)).view(np.int32)
    db = KeyframeDescriptorDB(sub_per_kf=desc.shape[1], max_keyframes=desc.shape[0],
                              device=device)
    db.desc.copy_(torch.tensor(desc))
    db.valid.copy_(torch.tensor(np.asarray(valid, bool)))
    db.kf_ids = [int(k) for k in kf_ids]
    return db


def mesh_pool_from_numpy(verts: np.ndarray, col_packed: np.ndarray,
                         nrm_packed: np.ndarray, tris: np.ndarray,
                         vcount: np.ndarray, tcount: np.ndarray,
                         device="cuda") -> mc.MeshPool:
    """A port MeshPool from a JAX pool's arrays (packed channels arrive
    as uint32 and are stored as int32 with the same bits)."""
    def i32(a):
        return torch.tensor(np.asarray(a).astype(np.int32), device=device)

    return mc.MeshPool(
        verts=torch.tensor(np.asarray(verts, np.float32), device=device),
        col_packed=i32(col_packed), nrm_packed=i32(nrm_packed), tris=i32(tris),
        vcount=i32(vcount), tcount=i32(tcount))


def mrf_problem_from_numpy(unary, label_kf, neighbors, parity, init_label, n_valid,
                           device="cuda"):
    """A port MRFProblem from a JAX MRFProblem's arrays (indices as int64)."""
    from texturefusion_torch.texture.mrf import MRFProblem

    def t(a, dtype):
        return torch.tensor(np.asarray(a).astype(dtype), device=device)

    return MRFProblem(unary=t(unary, np.float32), label_kf=t(label_kf, np.int32),
                      neighbors=t(neighbors, np.int64), parity=t(parity, np.int32),
                      init_label=t(init_label, np.int64), n_valid=t(n_valid, bool))


def kf_stack_from_numpy(rgb_packed: np.ndarray, depth: np.ndarray, poses: np.ndarray,
                        device="cuda"):
    """A port KeyframeStack holding a JAX stack's rows: packed rgb [K, H, W]
    (uint32, stored as int32 with the same bits: 24 are used), depth
    [K, H, W] f32 and host poses [K, 4, 4]; every row counts as written."""
    from texturefusion_torch.texture.kfstack import KeyframeStack
    k, h, w = np.shape(rgb_packed)
    stack = KeyframeStack(h, w, initial=k, device=device)
    stack.rgb_packed.copy_(torch.tensor(np.asarray(rgb_packed).astype(np.int32)))
    stack.depth.copy_(torch.tensor(np.asarray(depth, np.float32)))
    stack.poses = np.array(poses, np.float32)
    stack.present = set(range(k))
    return stack


def texture_rows_from_numpy(labels: np.ndarray, stats: np.ndarray, device="cuda"):
    """The texture manager's per-slot device rows from a JAX manager's:
    (labels_dev [S+1] int32, stats_dev [S+1, STATS_W] f32)."""
    return (torch.tensor(np.asarray(labels, np.int32), device=device),
            torch.tensor(np.asarray(stats, np.float32), device=device))


def restore_jax_checkpoint(pipe, arrays, meta) -> None:
    """Resume a port pipeline from a JAX checkpoint
    (texturefusion_tpu/utils/checkpoint.save_pipeline): `arrays` its .npz
    arrays, `meta` its .meta pickle with every array in it converted
    with np.asarray (the port never unpickles a jax array). uint32
    descriptor words become int32 with the same bits. What the JAX file
    lacks stays as a fresh pipeline has it: no integrated chunk ids (the
    next reintegration of such a keyframe takes the full path), the
    seeded generators, no previous keypoints (the last keyframe's stand
    in, as in a resumed JAX run), the allocator's free list in its
    initial order; the frame counter resumes at the frame count."""
    from texturefusion_torch.utils import checkpoint
    arrays = {k: (np.ascontiguousarray(v).view(np.int32)
                  if k.endswith("_desc") and np.asarray(v).dtype == np.uint32 else np.asarray(v))
              for k, v in dict(arrays).items()}
    meta = dict(meta, dispatch_count=len(meta["frames"]))
    checkpoint.restore_pipeline_state(pipe, arrays, meta)
