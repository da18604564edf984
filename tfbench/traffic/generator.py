"""The one frame generator every traffic mix is read by.

A traffic mix (tfbench/traffic/<mix>.json) gives the frames of a session
(`frames_per_session`, `fps`), the camera's path (`trajectory`, one of
tfbench/reference/trajectory.py's kinds with its arguments), the sensor
events on each session (`flicker_sigma`: a per-frame gain N(1, sigma) on
the colour; `exposure`: a gain on a range of frames; `blur`: a Gaussian
blur of sigma on some frames) and the warm-up and traced stretches of a
run (`warm_frames`, `trace_frames`). The configuration gives the scene,
the camera and the depth sensor's error model (`sensor`).

The sensor model is a frozen copy of tools/make_tum_proxy.py (the fr1
proxy of docs/ATE_PROXY.md), rewritten to run on the device from a
torch.Generator there: Kinect-v1 axial noise sigma(z) = s0 + s2 (z - z0)^2
(Khoshelham and Elberink), projector-shadow dropout at depth edges over
`edge_m`, dilated `dilate_px` pixels to the right, salt `speckle`, depth
quantised at the depth factor (0.2 mm at 5000), colour in 8 bits, and
OpenCV's Gaussian blur (float taps, BORDER_REFLECT_101).

The clean frames of a session are rendered once a run (`Traffic.render`);
each session's noise is drawn afresh from (seed, session) in a few large
calls over all its frames, so a seed gives the same frames in every run.
Frames come out packed [N, H, W, 5] uint8 (depth low byte, high byte, r,
g, b), the program's input format, on the device, with a pinned host
copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tfbench.reference import trajectory
from tfbench.traffic import render


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size (a run's
    seed, a session's index)."""
    state = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(
        2, dtype=np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's float Gaussian kernel for GaussianBlur(ksize=(0, 0))."""
    n = int(np.floor(sigma * 4 * 2 + 1 + 0.5)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (taps / taps.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur [N, H, W, C] float images along the rows, then the columns,
    with reflect-101 borders."""
    taps = torch.as_tensor(gaussian_taps(sigma), device=img.device)
    r = len(taps) // 2
    n, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).reshape(n * c, 1, h, w).double()
    k = taps.double()
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
    return x.float().reshape(n, c, h, w).permute(0, 2, 3, 1)


@dataclasses.dataclass
class Frames:
    packed: torch.Tensor            # [N, H, W, 5] uint8 on the device
    host: torch.Tensor              # the same, pinned in host memory
    timestamps: np.ndarray          # [N] seconds


class Traffic:
    """One traffic mix under one configuration, on one device."""

    def __init__(self, mix: Dict, config: Dict, device):
        self.mix, self.config, self.device = mix, config, torch.device(device)
        self.n = int(mix["frames_per_session"])
        self.poses = trajectory.make(mix["trajectory"], self.n)
        self.clean: Optional[tuple] = None

    def render(self) -> None:
        """The session's clean frames, on the device (once a run)."""
        self.clean = render.render(self.config["scene"], self.config["camera"], self.poses,
                                   self.device)

    def session(self, seed: int, session: int, n: Optional[int] = None) -> Frames:
        """The first `n` (all by default) frames of session `session` of
        run seed `seed`."""
        n = self.n if n is None else n
        depth, rgb = self.clean[0][:n], self.clean[1][:n]
        sens, mix, dev = self.config["sensor"], self.mix, self.device
        g = torch.Generator(device=dev)
        g.manual_seed(stream_seed(seed, session))
        # depth: axial noise, then the shadow band and speckle of the noisy map
        z = torch.clamp(depth, min=sens["noise_z0_m"]) - sens["noise_z0_m"]
        sigma = sens["noise_s0_m"] + sens["noise_s2_m"] * z * z
        noise = torch.randn(depth.shape, generator=g, device=dev)
        d = torch.where(depth > 0, depth + noise * sigma, 0.0)
        gx = torch.abs(torch.diff(d, dim=2, prepend=d[:, :, :1]))
        gy = torch.abs(torch.diff(d, dim=1, prepend=d[:, :1]))
        edge = torch.maximum(gx, gy) > sens["shadow_edge_m"]
        band = edge.clone()
        for k in range(1, int(sens["shadow_dilate_px"]) + 1):
            band |= torch.roll(edge, k, dims=2)
        drop = band | (torch.rand(depth.shape, generator=g, device=dev) < sens["speckle"])
        d = torch.where(drop, 0.0, d)
        du16 = torch.clamp(torch.round(d * sens["depth_factor"]), 0, 65535).to(torch.int32)
        # colour: per-frame flicker, the exposure step, the blur burst
        gain = 1.0 + torch.randn((n,), generator=g, device=dev) * mix.get("flicker_sigma", 0.0)
        exp = mix.get("exposure")
        if exp:
            idx = torch.arange(n, device=dev)
            gain = torch.where((idx >= exp["frames"][0]) & (idx < exp["frames"][1]),
                               gain * exp["gain"], gain)
        c = torch.clamp(rgb * gain[:, None, None, None], 0.0, 1.0)
        blur = mix.get("blur")
        if blur:
            fr = [f for f in blur["frames"] if f < n]
            if fr:
                c[fr] = gaussian_blur(c[fr], float(blur["sigma"]))
        packed = torch.empty(depth.shape + (5,), dtype=torch.uint8, device=dev)
        packed[..., 0] = (du16 & 0xFF).to(torch.uint8)
        packed[..., 1] = (du16 >> 8).to(torch.uint8)
        packed[..., 2:5] = (c * 255.0).to(torch.uint8)
        host = torch.empty(packed.shape, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        host.copy_(packed)
        return Frames(packed, host, np.arange(n, dtype=np.float64) / float(mix["fps"]))
