"""One session through the program: a scan from a new pipeline to its
textured model, and what the comparison reads of it.

A session constructs the configuration's pipeline class, feeds it every
frame closed-loop (`process_frame(frame, timestamp, host_packed)`: the
next frame goes in as soon as the call returns, as a recorded sequence is
replayed), then `flush_tracking()`, joins the fusion thread
(`_drain_fusion()`), calls `finish()` and synchronizes. Its clock runs
from the construction to that synchronize. What the comparison needs is
then read out of the pipeline (`extract`), outside the session's clock,
and the pipeline is closed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tfbench.reference.check import sample_atlas


def pipeline_config(spec: Dict):
    """The program's PipelineConfig from a configuration's "pipeline"
    entry: {section: {field: value}} over PipelineConfig's sections."""
    from texturefusion_torch import config as C
    sections = {"camera": C.CameraConfig, "tracking": C.TrackingConfig, "ba": C.BAConfig,
                "tsdf": C.TSDFConfig, "mesh": C.MeshConfig, "texture": C.TextureConfig,
                "parallel": C.ParallelConfig}
    unknown = set(spec) - set(sections)
    if unknown:
        raise ValueError(f"unknown PipelineConfig sections {sorted(unknown)}")
    return C.PipelineConfig(**{k: cls(**spec.get(k, {})) for k, cls in sections.items()})


def pipeline_class(name: str):
    from texturefusion_torch.fusion import pipeline
    return getattr(pipeline, name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Timing:
    seconds: float                  # construction to the synchronize after finish()
    frame_s: List[float]            # each process_frame call
    finish_s: float                 # finish() and the synchronize after it


@dataclasses.dataclass
class Outputs:
    """What the comparison reads of a session (tfbench/reference/check.py)."""

    poses: np.ndarray               # [N, 4, 4] every frame's camera-to-world pose
    verts: np.ndarray               # [V, 3] the final mesh's vertices
    vox_pos: np.ndarray             # [S, 3] sampled voxel centres of observed voxels
    vox_sdf: np.ndarray             # [S] their stored signed distance (m)
    tex_verts: np.ndarray           # [T, 3] vertices of textured chunks
    tex_rgb: np.ndarray             # [T, 3] the atlas colour there, in [0, 1]
    export_verts: np.ndarray        # [E, 3] every vertex of the textured export
    export_rgb: np.ndarray          # [E, 3] its colour there, in [0, 1]
    meshed_verts: int = 0           # vertices of every meshed chunk
    keyframes: int = 0
    active_chunks: int = 0


def run(cls, config, frames, device, hook: Optional[Callable[[object, int], None]] = None):
    """One session over `frames` (generator.Frames). `hook(pipe, i)`, when
    given, is called before frame i and once more with i = N before
    flush_tracking (the traced run's stretch). Returns (pipe, Timing)."""
    n = len(frames.timestamps)
    frame_s = []
    t0 = time.perf_counter()
    pipe = cls(config, device=device)
    for i in range(n):
        if hook is not None:
            hook(pipe, i)
        a = time.perf_counter()
        pipe.process_frame(frames.packed[i], timestamp=float(frames.timestamps[i]),
                           host_packed=frames.host[i].numpy())
        frame_s.append(time.perf_counter() - a)
    if hook is not None:
        hook(pipe, n)
    pipe.flush_tracking()
    pipe._drain_fusion()
    f0 = time.perf_counter()
    pipe.finish()
    sync(device)
    t1 = time.perf_counter()
    return pipe, Timing(t1 - t0, frame_s, t1 - f0)


def export_colours(tm, meshes):
    """The vertices and colours [E, 3] in [0, 1] of the textured export
    (TextureManager.export_textured's, without writing it): every vertex
    of a chunk with atlas coordinates, its atlas colour after the
    compensation is baked in (bake_compensation_into_atlas, which the
    export calls), or the fused voxel colour where its projection is
    invalid."""
    vs, cols, uvs, valid = [], [], [], []
    for slot in sorted(tm.chunk_tex):
        tex = tm.chunk_tex[slot]
        if tex.atlas_uv is None or slot not in meshes:
            continue
        v, _, c, _ = meshes[slot]
        k = min(len(v), len(tex.atlas_uv))
        vs.append(v[:k])
        cols.append(np.asarray(c[:k], np.float64))
        uvs.append(tex.atlas_uv[:k])
        valid.append(np.ones(k, bool) if tex.uv_valid is None
                     else np.asarray(tex.uv_valid[:k], bool))
    if not vs:
        z3 = np.zeros((0, 3), np.float32)
        return z3, z3
    tm.bake_compensation_into_atlas()
    baked = sample_atlas(tm.atlas.image, tm.atlas.size, np.concatenate(uvs))
    ok = np.concatenate(valid)[:, None]
    return np.concatenate(vs), np.where(ok, baked, np.concatenate(cols))


def extract(pipe, rng: np.random.Generator, n_voxels: int = 200_000) -> Outputs:
    """Read the session's outputs: poses, mesh, a sample of `n_voxels`
    observed voxels drawn with `rng`, the texture's atlas colour at every
    vertex of a patched, valid chunk, then the textured export's colours
    (the bake changes the atlas)."""
    poses = pipe.trajectory()
    verts = pipe.mesher.full_mesh()[0]
    # the TSDF: observed voxels of the resident chunks
    vol = pipe.volume
    slots = vol.active_slots()
    batch, origins = vol.dense_batch()
    res = vol.cfg.voxel_resolution
    vox_pos = np.zeros((0, 3), np.float32)
    vox_sdf = np.zeros((0,), np.float32)
    if len(slots):
        # candidates drawn uniformly over the resident voxels; the observed
        # ones are kept, up to n_voxels
        cand = rng.integers(0, len(slots) * 512, 4 * n_voxels)
        dev = batch.sdf.device
        rows = torch.as_tensor(slots[cand // 512], device=dev)
        cols = torch.as_tensor(cand % 512, device=dev)
        w = batch.weight[rows, cols].cpu().numpy()
        keep = np.nonzero(w > 0)[0][:n_voxels]
        slot, v = slots[cand[keep] // 512], cand[keep] % 512
        cent = (np.arange(8) + 0.5) * res
        org = origins[torch.as_tensor(slot, device=dev)].cpu().numpy().astype(np.float64)
        vox_pos = org + np.stack([cent[v & 7], cent[(v >> 3) & 7], cent[v >> 6]], -1)
        vox_sdf = batch.sdf[rows, cols].cpu().numpy()[keep]
    # the texture: patched chunks that are not wrong, valid projections only
    tex_v, tex_uv = [], []
    tm, meshes = getattr(pipe, "texture", None), pipe.mesher.meshes
    if tm is not None:
        for slot in sorted(tm.chunk_tex):
            tex = tm.chunk_tex[slot]
            if tex.atlas_uv is None or tex.wrong or slot not in meshes:
                continue
            v = meshes[slot][0]
            k = min(len(v), len(tex.atlas_uv))
            ok = np.ones(k, bool) if tex.uv_valid is None else np.asarray(tex.uv_valid[:k], bool)
            tex_v.append(v[:k][ok])
            tex_uv.append(tex.atlas_uv[:k][ok])
    z3 = np.zeros((0, 3), np.float32)
    tex_rgb = z3
    if tex_uv:
        # the atlas as the texture stage left it (the export bakes the
        # colour compensation into it later)
        tex_rgb = sample_atlas(tm.atlas.image, tm.atlas.size, np.concatenate(tex_uv))
    exp_v, exp_rgb = export_colours(tm, meshes) if tm is not None else (z3, z3)
    return Outputs(poses=np.asarray(poses), verts=np.asarray(verts),
                   vox_pos=vox_pos, vox_sdf=np.asarray(vox_sdf, np.float64),
                   tex_verts=np.concatenate(tex_v) if tex_v else z3, tex_rgb=tex_rgb,
                   export_verts=exp_v, export_rgb=exp_rgb,
                   meshed_verts=int(sum(len(m[0]) for m in meshes.values())),
                   keyframes=len(pipe.slam.keyframes), active_chunks=int(vol.n_active()))
