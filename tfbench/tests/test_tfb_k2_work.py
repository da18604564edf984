"""K2's roofline count depends on the launches' shapes alone."""

import types

import numpy as np
import pytest

from tfbench import harness

k2 = harness.load_reader("k2_roofline")
PEAK = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def test_work_from_shapes():
    assert k2.work(0, {}) == (0, 0)
    b1, o1 = k2.work(1000, {})
    assert b1 == 1000 * (512 * 8 + 20 + 5) and o1 == 1000 * 512 * 24
    b, o = k2.work(0, {(6, 100, False): 2})
    assert b == 2 * (100 * (512 * 8 + 20) + 6 * 64) and o == 2 * 100 * 512 * 6 * 24
    # the sign mix does not change the work; the counts add
    assert k2.work(0, {(6, 100, True): 2}) == (b, o)
    assert k2.work(1000, {(6, 100, False): 2}) == (b1 + b, o1 + o)
    # linear in the lanes
    b2, o2 = k2.work(0, {(6, 200, False): 2})
    assert o2 == 2 * o and b2 == 2 * b - 2 * 6 * 64


def test_share_from_the_trace_and_the_counters():
    ops = [("void (anonymous namespace)::tsdf_integrate_kernel(float*)", 0.0, 10.0),
           ("void (anonymous namespace)::tsdf_integrate_frames_kernel(float*)", 20.0, 30.0),
           ("other", 0.0, 100.0)]
    by_name = {n: (b - a) * 1e-6 for n, a, b in ops}
    run = types.SimpleNamespace(trace={"by_name": by_name, "ops": ops}, peak=PEAK,
                                k2={"launches": 2, "single_lanes": 1000,
                                    "frame_shapes": {(6, 1000, False): 1}})
    want = k2.bound_s(*k2.work(1000, {(6, 1000, False): 1}), PEAK) / 20e-6 * 100
    assert k2.read(run) == pytest.approx(want)
    # the voxels written back and coloured add their bytes
    run.k2 = dict(run.k2, written=10 ** 6, coloured=10 ** 5)
    more = k2.bound_s(*k2.work(1000, {(6, 1000, False): 1}, 10 ** 6, 10 ** 5), PEAK)
    assert k2.read(run) == pytest.approx(more / 20e-6 * 100) and more > want * 20e-6 / 100
    # a launch the trace does not hold, or a card with no peak: an error
    run.k2 = dict(run.k2, launches=3)
    with pytest.raises(RuntimeError, match="3 launches"):
        k2.read(run)
    run.k2, run.peak = dict(run.k2, launches=2), None
    with pytest.raises(RuntimeError, match="peaks"):
        k2.read(run)
    # an untraced run: no reading
    run.k2, run.trace = None, None
    assert k2.read(run) is None


def test_written_and_coloured_voxels_between_two_snapshots():
    w0 = np.array([[0.0, 1.0, 2.0, 3.0]])
    c0 = np.array([[0.0, 0.0, 1.0, 1.0]])
    a = {"launches": 1, "single_lanes": 5, "frame_shapes": {(3, 4, False): 1},
         "rows": {"weight": w0, "ccnt": c0}}
    # voxel 1 reset to 0 (garbage collection, not K2's write); 2 and 3 updated;
    # the colour of voxel 3 updated
    b = {"launches": 3, "single_lanes": 9, "frame_shapes": {(3, 4, False): 2},
         "rows": {"weight": np.array([[0.0, 0.0, 2.5, 4.0]]),
                  "ccnt": np.array([[0.0, 0.0, 1.0, 2.0]])}}
    d = harness.k2_delta(a, b)
    assert d == {"launches": 2, "single_lanes": 4, "frame_shapes": {(3, 4, False): 1},
                 "written": 2, "coloured": 1}
