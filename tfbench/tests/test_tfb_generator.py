"""The frame generator: a seed gives the same frames, sessions and seeds
differ, and the clean frames are the program's renderer's."""

import numpy as np
import torch

from tfbench.reference import scene as ref_scene
from tfbench.reference import trajectory
from tfbench.tests import tiny
from tfbench.traffic.generator import Traffic, gaussian_taps, stream_seed


def _traffic(frames=4):
    c = tiny.cell(frames)
    t = Traffic(c.mix, c.config, "cpu")
    t.render()
    return t


def test_same_seed_same_frames():
    t = _traffic()
    big = 2 ** 31 + 2 ** 30 + 17
    a = t.session(big, 0)
    b = _traffic().session(big, 0)
    assert torch.equal(a.packed, b.packed)
    assert torch.equal(a.host, a.packed)
    assert not torch.equal(a.packed, t.session(big + 1, 0).packed)
    assert not torch.equal(a.packed, t.session(big, 1).packed)


def test_stream_seed_takes_any_whole_number():
    seeds = {stream_seed(s, k) for s in (0, 1, 2 ** 31 + 5, 2 ** 40) for k in (-1, 0, 1)}
    assert len(seeds) == 12 and all(0 <= s < 2 ** 63 for s in seeds)


def test_frames_hold_the_scene_and_the_sensor_model():
    t = _traffic()
    f = t.session(3, 0).packed.numpy()
    depth = (f[..., 0].astype(np.int32) | (f[..., 1].astype(np.int32) << 8)) / 5000.0
    clean = t.clean[0].numpy()
    ok = (depth > 0) & (clean > 0)
    assert ok.mean() > 0.9                        # dropout and speckle take a few percent
    err = np.abs(depth - clean)[ok]
    assert np.median(err) < 0.01 and err.max() < 0.1
    # the exposure and flicker scale colour, they do not move it
    assert f[..., 2:5].mean() > 20


def test_clean_frames_match_the_analytic_scene():
    t = _traffic(2)
    sc = ref_scene.Scene(t.config["scene"])
    assert np.allclose(t.poses, trajectory.loop(120, 1.5, 1.05)[:2])
    # a pixel at the principal point looks along the camera's z axis
    cam = t.config["camera"]
    v, u = int(round(cam["cy"])), int(round(cam["cx"]))
    d = float(t.clean[0][0, v, u])
    p = t.poses[0]
    hit = p[:3, 3] + p[:3, 2] * d
    assert abs(sc.sdf(hit[None])[0]) < 0.02


def test_gaussian_taps_are_opencvs():
    taps = gaussian_taps(3.0)
    assert len(taps) == 25 and abs(float(taps.sum()) - 1.0) < 1e-6
    assert taps[12] == taps.max()
