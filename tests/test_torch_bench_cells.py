"""The benchmark's long cells beside the two loops: the fr1/room-length
scan (`fr1room-long.loop4`) and the 87-second scan past 512 keyframes
(`fr1room-87s.loop8`). Their files are found by name, their ground-truth
paths move at fr1/room's pace, they report the per-layer metrics of
every layer they run, and the readers of their own per-layer metrics
give None on a program without the spans they read, and the right value
on a made-up run."""

import numpy as np
import pytest

from tfbench import harness
from tfbench.reference import trajectory
from tfbench.session import Timing

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
LONG = "fr1room-long.loop4"
LONG87 = "fr1room-87s.loop8"
LONGS = [LONG, LONG87]
# each long cell: its configuration's file, frames a session and turns
CELLS = {LONG: ("fr1room-long.json", 1362, 4.05), LONG87: ("fr1room-87s.json", 2613, 7.77)}
LOOPS = ["fr1proxy-2cm.loop", "fr1proxy-5mm.loop"]
LIMITED = ("ate_mm", "map_rms_mm", "tsdf_median_mm", "colour_median", "uncovered_pct",
           "untextured_pct")


@pytest.mark.parametrize("name", LONGS)
def test_find_cell_finds_the_long_cell(name):
    """The 87-second cell takes the fr1/room-length cell's limits, none
    looser."""
    file, frames, _ = CELLS[name]
    cell = harness.find_cell(BENCH, name)
    assert cell.chips == 1 and cell.mix["frames_per_session"] == frames
    assert cell.config == harness.load_json(harness.HERE, "configs", file)
    assert set(cell.limits) == set(LIMITED)
    assert all(v > 0 for v in cell.limits.values())
    assert all(cell.limits[k] <= harness.find_cell(BENCH, LONG).limits[k] for k in LIMITED)
    lo, hi = cell.mix["trace_frames"]
    assert 0 <= lo < hi <= frames


@pytest.mark.parametrize("name", LONGS)
def test_the_long_scan_shares_the_2cm_deployment(name):
    """sensor, camera, scene and pipeline key for key, nothing reduced."""
    long_ = harness.load_json(harness.HERE, "configs", CELLS[name][0])
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


@pytest.mark.parametrize("name", LONGS)
def test_loop4_moves_as_fr1_room(name):
    """loop4's 4.05 turns over 1,362 frames and loop8's 7.77 over 2,613,
    at 30 Hz: 31.7 +- 0.5 deg/s (fr1/room: 29.9), 0.83 +- 0.02 m/s along
    the path."""
    _, frames, turns = CELLS[name]
    poses, fps = _path(name)
    assert len(poses) == frames
    yaw = _yaw_deg(poses)
    seconds = (len(poses) - 1) / fps
    assert (yaw[-1] - yaw[0]) / 360.0 == pytest.approx(turns, abs=1e-3)
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


# the long cells' own metrics: (name, the cells that report it)
NEW = {"late_frame_ms": LONGS, "ba_capture_ms": LONGS, "kf_grow_ms": [LONG87],
       "kf_stage_ms": [LONG87]}
# the per-layer metrics of the two loops: the long cell runs every layer
# they read (the frame step, promotion and BA, the fusion and texture
# cycles, K2, finish(), the tracking thread, the device)
ACCEPTED = ("finish_s", "frame_step_ms", "promotion_ms", "fusion_cycle_ms", "texture_cycle_ms",
            "k2_roofline", "device_idle_share", "ba_round_ms", "tracking_offcpu_ms",
            "ba_replay_share")


def test_the_new_metrics_are_declared_for_the_long_cell():
    """Each reads its long cells alone and moves frames_per_s, as its
    reader says."""
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name, cells in NEW.items():
        m, reader = per_layer[name], harness.load_reader(name)
        assert m["workloads"] == cells
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"] == "frames_per_s"


@pytest.mark.parametrize("cell", LONGS)
@pytest.mark.parametrize("name", ACCEPTED)
def test_the_long_cell_reports_the_loops_layer_metrics(name, cell):
    """The long cells are appended to the metric's cells, nothing else of
    it changed, and the harness picks it for each long cell."""
    m = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert m["workloads"] == LOOPS + LONGS
    assert name in [p["name"] for p in harness.find_cell(BENCH, cell).per_layer]


@pytest.mark.parametrize("name", list(NEW))
def test_a_new_reader_gives_none_without_its_span(name):
    """A program that counts BA's captures without timing them (no
    `ba_capture` span) and has fixed capacities and no staging (no
    `kf_grow`, `kf_stage_out` or `kf_restage`), and no session for the
    host clock to read."""
    run = _run(totals={"r_retract": 0.5, "r_fused": 1.0, "ba_gn_round": 2.0},
               counts={"r_retract": 10, "r_fused": 10, "ba_capture": 6, "ba_replay": 40,
                       "kf_staged": 3})
    assert harness.load_reader(name).read(run) is None


def test_the_new_readers_on_a_made_up_run():
    # two sessions of 8 frames: the last quarters hold 2 frames each
    a = _Session([0.01] * 6 + [0.030, 0.050])
    b = _Session([0.01] * 6 + [0.040, 0.070])
    run = _run([a, b], totals={"ba_capture": 1.5, "ba_gn_round": 2.0, "integration": 9.0,
                               "kf_grow": 0.25, "kf_stage_out": 0.5, "kf_restage": 0.125},
               counts={"ba_capture": 6, "ba_replay": 40, "kf_grow": 9, "kf_stage_out": 40,
                       "kf_staged": 40, "kf_restage": 2})
    assert harness.load_reader("late_frame_ms").read(run) == pytest.approx(45.0)
    assert harness.load_reader("ba_capture_ms").read(run) == pytest.approx(750.0)
    assert harness.load_reader("kf_grow_ms").read(run) == pytest.approx(125.0)
    assert harness.load_reader("kf_stage_ms").read(run) == pytest.approx(312.5)
