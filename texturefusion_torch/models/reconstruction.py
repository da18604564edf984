"""The per-frame reconstruction step.

Port of `frame_step` from texturefusion_tpu/models/reconstruction.py
(ref: main.cpp:102-211 + MobileFusion.cpp:274-406): preprocess + normals
+ quality + TSDF integration of one frame into a batch of chunk rows. On
CUDA tensors the bilateral filter runs kernel K1 and the voxel update
kernel K2; on CPU tensors both take their plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from texturefusion_torch.config import TSDFConfig
from texturefusion_torch.core import camera as cam
from texturefusion_torch.ops import preprocess
from texturefusion_torch.ops import tsdf as tsdf_ops


def frame_step(depth_raw: torch.Tensor, rgb: torch.Tensor,
               batch: tsdf_ops.ChunkBatch, origins: torch.Tensor,
               active: torch.Tensor, cam_to_world: torch.Tensor,
               intr: cam.Intrinsics, cfg: TSDFConfig
               ) -> Tuple[tsdf_ops.ChunkBatch, torch.Tensor, torch.Tensor]:
    """One frame into `batch` [U, 512] rows, updated IN PLACE (the JAX
    step donates its batch). Returns (batch, per-chunk quality, normals)."""
    depth = preprocess.frame_preprocess(depth_raw, intr)
    normals = preprocess.extract_normal_map(depth, intr)
    depth = preprocess.refine_depth_with_normals(depth, normals, intr)
    quality = preprocess.observation_quality_map(rgb, depth, normals, intr)
    idx = torch.arange(origins.shape[0], device=origins.device)
    chunk_q, _ = tsdf_ops.integrate_frame_fused(
        batch, origins, idx, active, depth, rgb, quality, cam_to_world, 1.0,
        intr, cfg, with_color=True)
    return batch, chunk_q, normals
