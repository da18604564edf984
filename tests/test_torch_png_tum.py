"""io/png.py and io/tum.py of the port against OpenCV and the JAX package.

The reader against files OpenCV writes (libpng): 16-bit greyscale depth
and 8-bit RGB, each written with every PNG row filter forced through
cv2.IMWRITE_PNG_FILTER (None, Sub, Up, Average, Paeth, and all filters,
which mixes them row by row), equal bit for bit; the writer's 16-bit and
filtered output read back by OpenCV and by the reader. The TUM reader on a
directory written as tests/test_tum_format.py writes it, against the JAX
package's load_tum_sequence: the same file lists and timestamps, the same
camera fields, ground-truth poses within 1e-6, frames bit for bit; and
the warning when calib.txt replaces the camera the caller passed (fault 4).
"""

import dataclasses
import os
import struct
import warnings
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_tum_format import _write_dataset
from texturefusion_tpu.io import tum as jtum
from texturefusion_torch.config import CameraConfig
from texturefusion_torch.io import png, tum

torch.set_num_threads(2)

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "all": cv2.IMWRITE_PNG_ALL_FILTERS}
# the row filter types each flag lets libpng use
ALLOWED = {"none": {0}, "sub": {1}, "up": {2}, "avg": {3}, "paeth": {4}, "all": {0, 1, 2, 3, 4}}


def _image(h=61, w=83, seed=0):
    """A colour image with flat areas, gradients and noise, so every filter
    has both small and wrapping differences to encode."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3) % 256, (yy * 5 + xx) % 256, (xx * yy) % 256], -1)
    noisy = rng.random((h, w)) < 0.3
    img[noisy] = rng.integers(0, 256, (int(noisy.sum()), 3))
    return img.astype(np.uint8)


def _depth(h=61, w=83, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 4000 + 37 * xx + 11 * yy + rng.integers(-300, 300, (h, w))
    d[rng.random((h, w)) < 0.1] = 0                         # holes
    d[:, w // 2:] += 40000                                 # a step past 2^15
    return d.astype(np.uint16)


def _row_filters(path):
    """The filter type byte of every row of a PNG (8-bit RGB or 16-bit grey)."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, ctype = hdr[:4]
    bpp = {(8, 2): 3, (16, 0): 2, (8, 6): 4}[(depth, ctype)]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + bpp * w)
    return set(rows[:, 0].tolist())


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_reads_opencv_rgb_with_each_filter(tmp_path, name):
    img = _image()
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_PNG_FILTER, FILTERS[name]])
    used = _row_filters(path)
    assert used <= ALLOWED[name], used
    if name != "none":
        assert used - {0}, f"OpenCV wrote no {name} rows"
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_reads_opencv_16bit_depth_with_each_filter(tmp_path, name):
    d = _depth()
    path = str(tmp_path / f"d_{name}.png")
    assert cv2.imwrite(path, d, [cv2.IMWRITE_PNG_FILTER, FILTERS[name]])
    assert _row_filters(path) <= ALLOWED[name]
    got = png.read_png(path)
    assert got.dtype == np.uint16 and got.shape == d.shape
    np.testing.assert_array_equal(got, d)


def test_reads_rgba_dropping_alpha_and_refuses_other_formats(tmp_path):
    img = _image(20, 30)
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 77, np.uint8)], -1)
    path = str(tmp_path / "rgba.png")
    assert cv2.imwrite(path, rgba[..., [2, 1, 0, 3]],
                       [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    np.testing.assert_array_equal(png.read_png(path), img)
    grey8 = str(tmp_path / "grey8.png")
    assert cv2.imwrite(grey8, img[..., 0])
    with pytest.raises(ValueError, match="IHDR"):
        png.read_png(grey8)


@pytest.mark.parametrize("filter_type", range(5))
def test_writer_round_trip(tmp_path, filter_type):
    img, d = _image(), _depth()
    rgb_path, d_path = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    png.write_png(rgb_path, img, filter_type=filter_type)
    png.write_png(d_path, d, filter_type=filter_type)
    assert _row_filters(rgb_path) == _row_filters(d_path) == {filter_type}
    np.testing.assert_array_equal(png.read_png(rgb_path), img)
    np.testing.assert_array_equal(png.read_png(d_path), d)
    np.testing.assert_array_equal(cv2.imread(rgb_path, cv2.IMREAD_COLOR)[..., ::-1], img)
    np.testing.assert_array_equal(cv2.imread(d_path, cv2.IMREAD_UNCHANGED), d)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "bad.png"), d.astype(np.int32))


def _camera_fields(c):
    return dataclasses.asdict(c)


def test_load_tum_sequence_matches_jax(tmp_path):
    root = str(tmp_path / "seq")
    _write_dataset(root, n=4, distortion=True)
    j = jtum.load_tum_sequence(root)
    t = tum.load_tum_sequence(root)
    assert len(t) == len(j) == 4
    assert t.rgb_files == j.rgb_files and t.depth_files == j.depth_files
    np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert _camera_fields(t.camera) == _camera_fields(j.camera)
    np.testing.assert_array_equal(t.gt_timestamps, j.gt_timestamps)
    np.testing.assert_allclose(t.gt_poses, j.gt_poses, rtol=0, atol=1e-6)
    for i in range(len(t)):
        for a, b in zip(t.load_frame_raw(i), j.load_frame_raw(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(t.load_frame(i), j.load_frame(i)):
            np.testing.assert_array_equal(a, b)


def test_trajectory_round_trip_and_association(tmp_path):
    root = str(tmp_path / "seq")
    _write_dataset(root, n=3)
    seq = tum.load_tum_sequence(root)
    ts, poses = tum.trajectory_from_tum(os.path.join(root, "groundtruth.txt"))
    np.testing.assert_array_equal(ts, seq.gt_timestamps)
    np.testing.assert_array_equal(poses, seq.gt_poses)
    a = np.asarray([999.98, 1000.001, 1000.034, 1000.5])
    assert tum.associate_timestamps(a, ts, max_dt=0.01) == \
        jtum.associate_timestamps(a, ts, max_dt=0.01) == [(1, 0), (2, 1)]


def test_calib_overrides_the_camera_with_a_warning(tmp_path):
    """Fault 4: calib.txt wins over the caller's camera, far_plane
    included, as in the JAX package; the port says which fields it
    replaced."""
    root = str(tmp_path / "seq")
    camera, _, _ = _write_dataset(root, n=1)
    mine = CameraConfig(width=camera.width, height=camera.height, fx=camera.fx + 1.0,
                        fy=camera.fy, cx=camera.cx, cy=camera.cy, far_plane=4.0)
    with pytest.warns(UserWarning, match=r"calib\.txt overrides") as rec:
        seq = tum.load_tum_sequence(root, mine)
    msg = " ".join(str(w.message) for w in rec if w.category is UserWarning)
    assert "fx" in msg and "far_plane" in msg and "cx" not in msg
    assert seq.camera.fx == camera.fx and seq.camera.far_plane == CameraConfig().far_plane
    j = jtum.load_tum_sequence(root, mine)
    assert _camera_fields(seq.camera) == _camera_fields(j.camera)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tum.load_tum_sequence(root)                        # no camera passed: no warning
        tum.load_tum_sequence(root, seq.camera)            # the same camera: no warning
