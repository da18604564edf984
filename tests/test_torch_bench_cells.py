"""The benchmark's cell beside the two loops: the fr1/room-length scan
(`fr1room-long.loop4`). Its files are found by name, its ground-truth
path moves as fr1/room does, it reports the per-layer metrics of every
layer it runs, and the readers of its own per-layer metrics give None
on a program without the spans they read, and the right value on a
made-up run."""

import numpy as np
import pytest

from tfbench import harness
from tfbench.reference import trajectory
from tfbench.session import Timing

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
LONG = "fr1room-long.loop4"
LOOPS = ["fr1proxy-2cm.loop", "fr1proxy-5mm.loop"]
LIMITED = ("ate_mm", "map_rms_mm", "tsdf_median_mm", "colour_median", "uncovered_pct",
           "untextured_pct")


def test_find_cell_finds_the_long_cell():
    cell = harness.find_cell(BENCH, LONG)
    assert cell.chips == 1 and cell.mix["frames_per_session"] == 1362
    assert cell.config == harness.load_json(harness.HERE, "configs", "fr1room-long.json")
    assert set(cell.limits) == set(LIMITED)
    assert all(v > 0 for v in cell.limits.values())
    lo, hi = cell.mix["trace_frames"]
    assert 0 <= lo < hi <= 1362


def test_the_long_scan_shares_the_2cm_deployment():
    """sensor, camera, scene and pipeline key for key, nothing reduced."""
    long_ = harness.load_json(harness.HERE, "configs", "fr1room-long.json")
    short = harness.load_json(harness.HERE, "configs", "fr1proxy-2cm.json")
    for key in ("sensor", "camera", "scene", "pipeline", "pipeline_class", "guarantees"):
        assert long_[key] == short[key], key
    assert long_["reduced"] == []


def _path(name):
    mix = harness.find_cell(BENCH, name).mix
    return trajectory.make(mix["trajectory"], int(mix["frames_per_session"])), float(mix["fps"])


def _yaw_deg(poses):
    """The camera's heading about the vertical, unwrapped, in degrees."""
    z = poses[:, :3, 2]
    return np.rad2deg(np.unwrap(np.arctan2(z[:, 0], z[:, 2])))


def test_loop4_moves_as_fr1_room():
    """4.05 turns over 1,362 frames at 30 Hz: 31.7 +- 0.5 deg/s (fr1/room:
    29.9), 0.83 +- 0.02 m/s along the path."""
    poses, fps = _path(LONG)
    yaw = _yaw_deg(poses)
    seconds = (len(poses) - 1) / fps
    assert (yaw[-1] - yaw[0]) / 360.0 == pytest.approx(4.05, abs=1e-3)
    assert abs(yaw[-1] - yaw[0]) / seconds == pytest.approx(31.7, abs=0.5)
    path = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).sum()
    assert path / seconds == pytest.approx(0.83, abs=0.02)


class _Session:
    def __init__(self, frame_s):
        self.timing = Timing(seconds=sum(frame_s), frame_s=list(frame_s), finish_s=0.0)
        self.outputs = None


def _run(sessions=(), totals=None, counts=None):
    return harness.Run(seed=1, setup_s=1.0, window_s=1.0, sessions=list(sessions),
                       stopwatch_totals=totals or {}, stopwatch_counts=counts or {})


NEW = ("late_frame_ms", "ba_capture_ms")
# the per-layer metrics of the two loops: the long cell runs every layer
# they read (the frame step, promotion and BA, the fusion and texture
# cycles, K2, finish(), the tracking thread, the device)
ACCEPTED = ("finish_s", "frame_step_ms", "promotion_ms", "fusion_cycle_ms", "texture_cycle_ms",
            "k2_roofline", "device_idle_share", "ba_round_ms", "tracking_offcpu_ms",
            "ba_replay_share")


def test_the_new_metrics_are_declared_for_the_long_cell():
    """Each reads the long cell alone and moves frames_per_s, as its
    reader says."""
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m, reader = per_layer[name], harness.load_reader(name)
        assert m["workloads"] == [LONG]
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"] == "frames_per_s"


@pytest.mark.parametrize("name", ACCEPTED)
def test_the_long_cell_reports_the_loops_layer_metrics(name):
    """The long cell is appended to the metric's cells, nothing else of
    it changed, and the harness picks it for the long cell."""
    m = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert m["workloads"] == LOOPS + [LONG]
    assert name in [p["name"] for p in harness.find_cell(BENCH, LONG).per_layer]


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_gives_none_without_its_span(name):
    """A program that counts BA's captures without timing them (no
    `ba_capture` span), and no session for the host clock to read."""
    run = _run(totals={"r_retract": 0.5, "r_fused": 1.0, "ba_gn_round": 2.0},
               counts={"r_retract": 10, "r_fused": 10, "ba_capture": 6, "ba_replay": 40})
    assert harness.load_reader(name).read(run) is None


def test_the_new_readers_on_a_made_up_run():
    # two sessions of 8 frames: the last quarters hold 2 frames each
    a = _Session([0.01] * 6 + [0.030, 0.050])
    b = _Session([0.01] * 6 + [0.040, 0.070])
    run = _run([a, b], totals={"ba_capture": 1.5, "ba_gn_round": 2.0, "integration": 9.0},
               counts={"ba_capture": 6, "ba_replay": 40})
    assert harness.load_reader("late_frame_ms").read(run) == pytest.approx(45.0)
    assert harness.load_reader("ba_capture_ms").read(run) == pytest.approx(750.0)
