"""The harness's run without its look for a card, on the CPU at the tiny
cell's size, with the timed path broken underneath: `correct` comes out
false for each fault the cell can have (one card, so no exchange between
cards to leave out), and true for the sound path. Half of the work left
out is planted three ways: half of the frames, half of the chunks
integrated, half of the chunks textured."""

import time

import numpy as np
import pytest

from tfbench import harness
from tfbench.tests import tiny

SEED = 2 ** 31 + 977


def _correct(cell) -> tuple:
    run, gt, _ = harness.measure(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    judged = harness.compare(cell, run, gt)
    return all(j["ok"] for j in judged.values()), judged


def test_sound_path_is_correct():
    ok, judged = _correct(tiny.cell())
    assert ok, judged


def _state_unchanged(monkeypatch):
    """A fusion cycle that leaves the map as it was."""
    from texturefusion_torch.fusion import pipeline
    monkeypatch.setattr(pipeline.ReconstructionPipeline, "fusion_cycle",
                        lambda self, slot: None)


def _half_left_out(monkeypatch):
    """Every other frame of a session dropped by the pipeline."""
    from texturefusion_torch.fusion import pipeline
    real = pipeline.ReconstructionPipeline.process_frame
    seen = {}

    def process_frame(self, *a, **kw):
        seen[id(self)] = seen.get(id(self), -1) + 1
        if seen[id(self)] % 2 == 0:
            real(self, *a, **kw)

    monkeypatch.setattr(pipeline.ReconstructionPipeline, "process_frame", process_frame)


def _half_integrated(monkeypatch):
    """Every keyframe integrated into half of the chunks it sees: those
    whose chunk coordinates sum to an odd number are left out."""
    from texturefusion_torch.fusion import chunkmap
    real = chunkmap.TSDFVolume.integrate_frame

    def integrate_frame(self, depth, rgb, quality_map, cam_to_world, keyframe_id=None,
                        sign=1.0, slots=None):
        if slots is None:
            slots = self.discover_chunks(depth, self._pose(cam_to_world), allocate=sign > 0)
        slots = slots[self.ids[slots].sum(axis=1) % 2 == 0]
        return real(self, depth, rgb, quality_map, cam_to_world, keyframe_id, sign, slots)

    monkeypatch.setattr(chunkmap.TSDFVolume, "integrate_frame", integrate_frame)


def _half_textured(monkeypatch):
    """The texture's patches kept for half of the chunks: those whose slot
    is odd lose their atlas coordinates as each cycle writes them."""
    from texturefusion_torch.texture import manager
    real = manager.TextureManager._consume

    def _consume(self, *a, **kw):
        real(self, *a, **kw)
        for s, tex in self.chunk_tex.items():
            if s % 2:
                tex.atlas_uv = None

    monkeypatch.setattr(manager.TextureManager, "_consume", _consume)


def _colour_altered(monkeypatch):
    """The texture's patches written with their colours inverted."""
    from texturefusion_torch.texture import atlas
    real = atlas.resize_bilinear
    monkeypatch.setattr(atlas, "resize_bilinear", lambda *a, **kw: 255 - real(*a, **kw))


def _pose_altered(monkeypatch):
    """Every frame's pose moved 5 cm along its camera's x axis."""
    from texturefusion_torch.slam import gcslam
    real = gcslam.GCSLAM.frame_pose

    def frame_pose(self, i):
        p = np.array(real(self, i), copy=True)
        p[:3, 3] += 0.05 * (1.0 if i % 2 else -1.0) * p[:3, 0]
        return p

    monkeypatch.setattr(gcslam.GCSLAM, "frame_pose", frame_pose)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _half_integrated,
                                   _half_textured, _colour_altered, _pose_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    ok, judged = _correct(tiny.cell())
    assert not ok, judged
