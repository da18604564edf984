"""The fr1/room-length scan (`fr1room-long.loop4`) at the tiny cell's size
on the CPU: one 96-frame session of the tiny cell (tfbench/tests/tiny.py)
over 3.05 turns of its loop, so that the camera comes round three times,
through the port's normal path (tfbench/session.py: TexturedPipeline's
process_frame, flush_tracking, finish).

BA's buckets start at 4 keyframes and 8 edges and the keyframe stack at
2 rows, so that a session this short crosses the bucket and capacity
boundaries the long cell crosses at 32 / 128 / 64; the keyframe and edge
capacities are preset past its 33 keyframes (PRESET), or start at 8 and
32 and grow (GROWN), as the 87-second cell's grow past 512 and 4,096.
The blur burst's sigma is scaled to the tiny camera's quarter resolution
(the cell's 3.0 px is for 640 px).

The tracker of the tiny cell (160 x 120, 256 features) does not hold the
tiny cell's limits at 11.4 degrees a frame, nor over 96 frames at its
own 3.2: the limits were set on 24-frame sessions (at this speed, with
an atlas of 8192, seeds 2**31 + 977, 5 and 77 read ATE 15.5, 25.5 and
29.5 mm against 16; its atlas of 2048 overflows past ~70 patches). So
the session is judged for complete outputs, and the staging is held to
the unstaged session bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from tfbench import session
from tfbench.reference import check
from tfbench.reference.scene import Scene
from tfbench.tests import tiny
from tfbench.traffic.generator import Traffic
from texturefusion_torch.fusion.pipeline import KeyframeFusionState
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.utils.stopwatch import STOPWATCH

torch.set_num_threads(2)

FRAMES, TURNS = 96, 3.05
SEED = 2 ** 31 + 977
DEFAULT = None              # the configuration's keyframe_device_budget_mb
COUNTERS = ("loop_edges", "kf_reintegrated", "kfstack_grow", "kf_staged", "kf_stage_out",
            "kf_restage", "ba_capture", "kf_grow")
# the session's initial keyframe and edge capacities: past its keyframes
# and edges, or below them (the session grows them)
PRESET = dict(max_keyframes=128, max_edges=1024)
GROWN = dict(max_keyframes=8, max_edges=32)


def _cell(capacities=PRESET):
    c = tiny.cell(FRAMES)
    c.mix["trajectory"] = dict(c.mix["trajectory"], revolutions=TURNS, base_frames=FRAMES)
    c.mix["blur"] = dict(c.mix["blur"], sigma=c.mix["blur"]["sigma"] * tiny.CAMERA["width"] / 640)
    p = c.config["pipeline"]
    p["ba"].update(kf_bucket_floor=4, edge_bucket_floor=8, **capacities)
    p["texture"].update(kf_stack_initial=2)
    return c


def _frames(c, device="cpu"):
    traffic = Traffic(c.mix, c.config, device)
    traffic.render()
    return traffic, traffic.session(SEED, 0)


def _scan(c, frames, budget, device):
    """(Outputs, STOPWATCH counts and the session's `edges`) of one session
    at a keyframe device budget of `budget` MB (None: the
    configuration's)."""
    spec = dict(c.config["pipeline"])
    if budget is not None:
        spec["tsdf"] = dict(spec["tsdf"], keyframe_device_budget_mb=budget)
    STOPWATCH.reset()
    pipe, _ = session.run(session.pipeline_class(c.config["pipeline_class"]),
                          session.pipeline_config(spec), frames, device)
    outputs = session.extract(pipe, np.random.default_rng(SEED))
    counts = {k: STOPWATCH.counts.get(k, 0) for k in COUNTERS}
    counts["edges"] = pipe.slam.n_edges
    pipe.close()
    return outputs, counts


def _numbers(c, gt, outputs):
    scene = Scene(c.config["scene"])
    samples = check.surface(scene, c.config, gt, SEED)
    return check.session_numbers(outputs, gt, scene,
                                 c.config["pipeline"]["tsdf"]["voxel_resolution"], samples)


@pytest.fixture(scope="module")
def scans():
    """{(capacities, budget): (Outputs, counts)} of the same frames at the
    preset and the grown capacities (PRESET and GROWN: None, "grown"), at
    a keyframe device budget of 1 MB and at the default. The preset
    session at the default budget is out[DEFAULT]."""
    c = _cell()
    traffic, frames = _frames(c)
    out = {}
    for caps, cell in ((None, c), ("grown", _cell(GROWN))):
        for budget in (1.0, DEFAULT):
            key = budget if caps is None else (caps, budget)
            out[key] = _scan(cell, frames, budget, "cpu")
    return c, traffic.poses, out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_the_long_session_closes_loops_and_grows(scans):
    """Registrations to keyframes other than the tracked one, drift
    reintegrations and the keyframe stack's doubling all happen; BA
    replays no captured program on the CPU."""
    _, _, out = scans
    outputs, counts = out[DEFAULT]
    assert outputs.keyframes > 16
    assert counts["loop_edges"] > 0 and counts["kf_reintegrated"] > 0
    assert counts["kfstack_grow"] >= 4
    assert counts["ba_capture"] == 0


def test_the_long_session_gives_every_output(scans):
    """Every number of the comparison is finite: a pose for every frame,
    a mesh, observed voxels and textured vertices."""
    c, gt, out = scans
    nums = _numbers(c, gt, out[DEFAULT][0])
    assert all(math.isfinite(v) for v in nums.values()), nums


@pytest.mark.parametrize("caps,budget", [
    pytest.param(None, 1.0, id="budget_1MB"),
    pytest.param(None, DEFAULT, id="budget_default"),
    pytest.param("grown", 1.0, id="grown-budget_1MB"),
    pytest.param("grown", DEFAULT, id="grown-budget_default")])
def test_staging_moves_memory_only(scans, caps, budget):
    """At 1 MB the keyframes' stageable state is staged as the cycles pass
    (`kf_staged`, `kf_stage_out`); at the default budget none is. On the
    CPU host memory is the keyframe's own device, so nothing comes back
    (`kf_restage`): test_staging_on_the_card holds the copy back. Either
    way the poses, the mesh, the sampled voxels and the texture are those
    of the other run at the same capacities, bit for bit; the grown
    session (GROWN) doubles its keyframe and edge capacities on the way
    (`kf_grow`)."""
    _, _, out = scans
    key = (lambda b: b) if caps is None else (lambda b: (caps, b))
    outputs, counts = out[key(budget)]
    other = out[key(DEFAULT if budget is not None else 1.0)][0]
    assert (counts["kf_grow"] > 0) == (caps == "grown")
    assert counts["kf_restage"] == 0
    if budget is None:
        assert counts["kf_staged"] == 0
    else:
        assert counts["kf_staged"] > 0 and counts["kf_stage_out"] == counts["kf_staged"]
    for name in ("poses", "verts", "vox_pos", "vox_sdf", "tex_verts", "tex_rgb"):
        a, b = getattr(outputs, name), getattr(other, name)
        assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.cuda
def test_staging_on_the_card(cuda_device):
    """On the card staging moves memory: a keyframe's quality and local
    depths go to host memory and come back on the device bit for bit for
    one pass, and stay staged. At 1 MB a session on a pipeline built on
    "cuda" stages keyframes, brings them back for the passes that read
    them (`kf_restage`), and gives every output."""
    rng = np.random.default_rng(SEED)
    t = lambda *shape: torch.as_tensor(rng.random(shape, np.float32), device=cuda_device)  # noqa: E731
    st = KeyframeFusionState(0, 0, t(12, 16), t(12, 16, 3), t(12, 16), [t(12, 16), t(12, 16)],
                             [np.eye(4)] * 2, depth_weight=t(12, 16))
    quality, local = st.quality.clone(), [d.clone() for d in st.local_depths]
    STOPWATCH.reset()
    st.release_device_memory()
    assert st.quality.device.type == "cpu" and st.depth_weight is None
    back_q, back_local = st.staged()
    assert back_q.device == quality.device and torch.equal(back_q, quality)
    assert all(torch.equal(a, b) for a, b in zip(back_local, local))
    assert st.quality.device.type == "cpu" and STOPWATCH.counts["kf_restage"] == 1

    cuda_kernels.build()
    c = _cell()
    traffic, frames = _frames(c, cuda_device)
    outputs, counts = _scan(c, frames, 1.0, cuda_device)
    assert counts["kf_staged"] > 0 and counts["kf_stage_out"] == counts["kf_staged"]
    assert counts["kf_restage"] > 0
    nums = _numbers(c, traffic.poses, outputs)
    assert all(math.isfinite(v) for v in nums.values()), nums
