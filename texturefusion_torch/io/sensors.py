"""Sensor / input abstraction: dataset, synthetic and live-camera wrappers.

Port of texturefusion_tpu/io/sensors.py (ref: Tools/Wrapper.h:11-17;
Tools/DatasetWrapper.hpp:15-263 TUM offline; Tools/OpenNI2Wrapper.hpp,
RealSenseWrapper.hpp live sensors). `open_sensor(mode, path)` mirrors
the reference CLI's InputMode (ref: BasicAPI.cpp:1169-1205 — 0 offline
dataset, 1 OpenNI2, 2 RealSense; 4 is the synthetic scene). The live
drivers raise when their SDK's Python bindings are absent.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from texturefusion_torch.config import CameraConfig


class SensorBase:
    """Yields (timestamp, depth, rgb) or (timestamp, packed frame, None)."""

    camera: CameraConfig

    def frames(self) -> Iterator[Tuple]:
        raise NotImplementedError


class DatasetSensor(SensorBase):
    """TUM-format offline dataset (InputMode 0): each frame is one packed
    [H, W, 5] uint8 array (preprocess.pack_frame), one upload a frame."""

    def __init__(self, root: str, camera: Optional[CameraConfig] = None):
        from texturefusion_torch.io import tum

        self.seq = tum.load_tum_sequence(root, camera)
        self.camera = self.seq.camera

    def frames(self):
        from texturefusion_torch.ops.preprocess import pack_frame

        for i in range(len(self.seq)):
            depth, rgb = self.seq.load_frame_raw(i)
            yield float(self.seq.timestamps[i]), pack_frame(depth, rgb), None


class SyntheticSensor(SensorBase):
    """The procedural box room on an orbit (no files needed), rendered on
    `device`: yields (timestamp, depth [H, W] f32 metres, rgb [H, W, 3]
    f32 in [0, 1]) as tensors there."""

    def __init__(self, n_frames: int = 30, camera: Optional[CameraConfig] = None,
                 device="cuda"):
        from texturefusion_torch.core import camera as cam
        from texturefusion_torch.io import synthetic

        self.camera = camera or CameraConfig(far_plane=6.0)
        self.intr = cam.Intrinsics.from_config(self.camera)
        self.scene = synthetic.BoxRoomScene()
        self.poses = synthetic.orbit_trajectory(n_frames)
        self.device = torch.device(device)

    def frames(self):
        from texturefusion_torch.io import synthetic
        for i, p in enumerate(self.poses):
            d, c = synthetic.render_frame(
                self.scene, self.intr, torch.as_tensor(p, dtype=torch.float32,
                                                       device=self.device))
            yield float(i) / 30.0, d, c


class OpenNI2Sensor(SensorBase):
    """Live OpenNI2 device (InputMode 1). Needs the openni bindings."""

    def __init__(self, camera: Optional[CameraConfig] = None):
        try:
            from openni import openni2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "OpenNI2 python bindings not available on this image; "
                "use InputMode 0 (dataset) or 4 (synthetic)") from e
        self.camera = camera or CameraConfig()


class RealSenseSensor(SensorBase):
    """Live RealSense device (InputMode 2). Needs pyrealsense2."""

    def __init__(self, camera: Optional[CameraConfig] = None):
        try:
            import pyrealsense2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 not available on this image; "
                "use InputMode 0 (dataset) or 4 (synthetic)") from e
        self.camera = camera or CameraConfig()


def open_sensor(mode: int, path: str = "", camera: Optional[CameraConfig] = None,
                device="cuda") -> SensorBase:
    """InputMode dispatch (ref: main.cpp:55-71); mode 4, the synthetic
    scene, renders on `device`."""
    if mode == 0:
        return DatasetSensor(path, camera)
    if mode == 1:
        return OpenNI2Sensor(camera)
    if mode == 2:
        return RealSenseSensor(camera)
    if mode == 4:
        return SyntheticSensor(camera=camera, device=device)
    raise ValueError(f"unknown InputMode {mode}")
