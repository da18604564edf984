"""The control of the comparison, at the tiny cell's size on the CPU: the
pipeline told that the fr1 lens has no distortion (tfbench/controls/
no_distortion.json) while the frames are taken through it comes out not
correct. On the card, at the cells' own sizes, `tfbench/control.py
--control no_distortion` reads it (PERF.md gives the readings)."""

import time

from tfbench import control, harness
from tfbench.tests import tiny


def test_control_is_not_correct():
    cell = tiny.cell()
    patch = harness.load_json(harness.HERE, "controls", "no_distortion.json")
    cell.config = control.patched(cell.config, {"pipeline": patch["pipeline"]})
    assert cell.config["pipeline"]["camera"]["d0"] == 0.0
    assert cell.config["camera"]["d0"] == tiny.CAMERA["d0"]      # the frames keep the lens
    run, gt, _ = harness.measure(cell, 2 ** 31 + 977, 0.0, False, "cpu", time.perf_counter())
    judged = harness.compare(cell, run, gt)
    assert not all(j["ok"] for j in judged.values()), judged
