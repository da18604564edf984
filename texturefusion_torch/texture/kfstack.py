"""Keyframe image stacks on the device for the texture stage.

Port of texturefusion_tpu/texture/kfstack.py. The reference's texture
passes read keyframe images from CPU memory (ref: Structure/Patch.cpp:110-175
bilinear samplers; Chisel.cpp:149-189 GeneratePatches). Here each
keyframe is written once into preallocated device buffers, indexed by
keyframe slot, whose capacity doubles when a slot outgrows it:

  * rgb packed to one int32 a pixel (r | g<<8 | b<<16; 24 bits, so the
    bits equal the JAX package's uint32): one gather per bilinear tap;
  * depth in float32 (the wrong-mapping and occlusion tests need ~cm,
    ref: Patch.cpp:88-96).

Poses stay on the host and are refreshed before each texture cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from texturefusion_torch.utils.capacity import doubled, grown
from texturefusion_torch.utils.stopwatch import STOPWATCH


def pack_rgb(rgb_u8: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 → [...] int32 r | g<<8 | b<<16."""
    c = rgb_u8.to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


class KeyframeStack:
    def __init__(self, height: int, width: int, initial: int = 8, *, device):
        self.h, self.w = height, width
        self.cap = initial
        self.device = torch.device(device)
        self.rgb_packed = torch.zeros((initial, height, width), dtype=torch.int32,
                                      device=self.device)
        self.depth = torch.zeros((initial, height, width), dtype=torch.float32,
                                 device=self.device)
        self.poses = np.tile(np.eye(4, dtype=np.float32), (initial, 1, 1))
        self.present: set = set()

    def ensure(self, kf_slot: int) -> None:
        """Double the capacity until row kf_slot exists (the STOPWATCH span
        `kfstack_grow`)."""
        if kf_slot < self.cap:
            return
        with STOPWATCH.time("kfstack_grow"):
            self.cap = doubled(self.cap, kf_slot + 1)
            self.rgb_packed = grown(self.rgb_packed, self.cap)
            self.depth = grown(self.depth, self.cap)
            self.poses = grown(self.poses, self.cap, np.eye(4, dtype=np.float32))

    def add(self, kf_slot: int, rgb_u8, depth, pose: np.ndarray) -> None:
        """Write one keyframe's images (uint8 [H, W, 3], float [H, W]) and
        pose into row kf_slot."""
        self.ensure(kf_slot)
        self.rgb_packed[kf_slot] = pack_rgb(torch.as_tensor(rgb_u8).to(self.device))
        self.depth[kf_slot] = torch.as_tensor(depth).to(self.device)
        self.poses[kf_slot] = pose
        self.present.add(kf_slot)

    def set_pose(self, kf_slot: int, pose: np.ndarray) -> None:
        """Poses move with BA; refreshed before each texture cycle."""
        if kf_slot < self.cap:
            self.poses[kf_slot] = pose
