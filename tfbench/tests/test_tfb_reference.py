"""The reference's arithmetic on hand-worked cases."""

import types

import numpy as np

from tfbench.reference import check, coverage, trajectory
from tfbench.reference.scene import Scene

ROOM = {"room_min": [-2.0, -1.0, -2.0], "room_max": [2.0, 1.0, 2.0], "spheres": [[0.0, 0.0, 1.0, 0.5]],
        "checker_scale": 4.0}


def _rigid(angle, t):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    m[:3, 3] = t
    return m


def test_ate_is_zero_under_a_rigid_motion_and_rms_of_an_offset():
    gt = trajectory.loop(30, 1.0, 1.0)
    moved = np.einsum("ij,njk->nik", _rigid(0.7, [0.3, -0.2, 1.0]), gt)
    assert trajectory.ate_rmse(moved, gt) < 1e-9
    # one frame of 30 off by 0.3 m: unaligned the RMSE is 0.3/sqrt(30); a
    # shift alone takes it to 0.3/sqrt(30) sqrt(29/30), the rotation little more
    est = gt.astype(np.float64).copy()
    est[7, :3, 3] += [0.0, 0.3, 0.0]
    ate = trajectory.ate_rmse(est, gt)
    assert 0.9 * 0.3 / np.sqrt(30) <= ate <= 0.3 / np.sqrt(30) * np.sqrt(29 / 30) + 1e-9


def test_scene_sdf_hand_cases():
    s = Scene(ROOM)
    pts = np.array([[0.0, 0.0, 0.0], [1.9, 0.0, -1.0], [0.0, 0.9, -1.0], [0.0, 0.0, 1.0],
                    [0.0, 0.0, 1.6], [2.5, 0.0, 0.0]])
    want = [0.5, 0.1, 0.1, -0.5, 0.1, -0.5]
    assert np.allclose(s.sdf(pts), want)


def test_session_numbers_hand_case():
    s = Scene(ROOM)
    gt = trajectory.loop(20, 1.0, 1.0)
    # the program's frame: every pose moved by one rigid motion
    m = _rigid(-0.4, [0.1, 0.2, 0.3])
    est = np.einsum("ij,njk->nik", m, gt)
    # vertices 1 cm in front of the x = 2 wall and 3 cm outside it (off the albedo's cell
    # edges), in the program's frame
    wall = np.array([[1.99, 0.03, 0.07], [1.99, 0.53, 0.57], [2.03, -0.47, 0.23],
                     [2.03, 0.13, -0.97]])
    verts = wall @ m[:3, :3].T + m[:3, 3]
    vox_pos = verts.copy()
    vox_sdf = np.array([0.01, 0.01, -0.03, -0.03]) + 0.004    # 4 mm off the scene's sdf
    colours = s.color(wall.astype(np.float32)).astype(np.float64)
    colours[0] += 10 / 255.0                                    # one vertex 10 levels off
    # the export: every colour at 80% of the albedo, one gain fits it back
    out = types.SimpleNamespace(poses=est, verts=verts, vox_pos=vox_pos, vox_sdf=vox_sdf,
                                tex_verts=verts[:2], tex_rgb=colours[:2], export_verts=verts,
                                export_rgb=0.8 * s.color(wall.astype(np.float32)))
    # surface samples: two at the first two vertices, two 10 cm from any
    samples = np.concatenate([wall[:2] + [0.01, 0, 0], [[2.0, -0.9, 1.8], [2.0, 0.9, 1.8]]])
    n = check.session_numbers(out, gt, s, voxel=0.02, samples=samples)
    assert n["ate_mm"] < 1e-6
    assert abs(n["map_rms_mm"] - np.sqrt((2 * 10 ** 2 + 2 * 30 ** 2) / 4)) < 1e-6
    assert abs(n["tsdf_median_mm"] - 4.0) < 1e-6
    assert abs(n["colour_median"] - 5.0) < 1e-4             # median of 10 and 0
    assert n["export_colour_median"] < 1e-3
    assert n["uncovered_pct"] == 50.0
    # the textured vertices cover the same two samples; without them, none
    assert n["untextured_pct"] == 50.0
    out.tex_verts = verts[2:]
    assert check.session_numbers(out, gt, s, 0.02, samples)["untextured_pct"] == 100.0


def test_missing_outputs_read_inf_and_fail():
    s = Scene(ROOM)
    gt = trajectory.loop(10, 1.0, 1.0)
    z = np.zeros((0, 3))
    out = types.SimpleNamespace(poses=gt[:5], verts=z, vox_pos=z, vox_sdf=np.zeros(0),
                                tex_verts=z, tex_rgb=z, export_verts=z, export_rgb=z)
    n = check.session_numbers(out, gt, s, 0.02, np.ones((4, 3)))
    assert all(v == float("inf") for v in n.values())
    j = check.judge(check.run_numbers([n]), {"ate_mm": 1e9})
    assert not j["ate_mm"]["ok"]


def test_run_numbers_take_the_worst_session():
    a = {k: 1.0 for k in check.NUMBERS}
    b = dict(a, ate_mm=3.0)
    assert check.run_numbers([a, b])["ate_mm"] == 3.0
    j = check.judge(check.run_numbers([a, b]), {"ate_mm": 2.0, "map_rms_mm": 2.0})
    assert not j["ate_mm"]["ok"] and j["map_rms_mm"]["ok"]


def test_sample_atlas_bilinear():
    img = np.zeros((4, 4, 3), np.uint8)
    img[1, 1] = 255
    # uv with v up: pixel (x=1.5, y=1) is halfway between columns 1 and 2 of row 1
    got = check.sample_atlas(img, 4, np.array([[1.5 / 4, 1 - 1 / 4]]))
    assert np.allclose(got, 0.5)


def test_ray_hits_the_nearest_wall_or_sphere():
    s = Scene(ROOM)
    dirs = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0]])
    # the sphere of radius 0.5 at z = 1 is met at z = 0.5; the walls at 2, 1, 2
    assert np.allclose(coverage.ray_hits(s, np.zeros(3), dirs), [2.0, 1.0, 0.5, 2.0])


def test_surface_samples_lie_on_the_surface_within_range():
    s = Scene(ROOM)
    cam = dict(width=64, height=48, fx=40.0, fy=40.0, cx=31.5, cy=23.5, d0=0.1, d1=-0.1)
    poses = trajectory.loop(4, 0.5, 1.0)
    pts = coverage.surface_samples(s, cam, poses, 100, np.random.default_rng(1), far=6.0)
    assert len(pts) == 400 and np.abs(s.sdf(pts)).max() < 1e-9
    near = coverage.surface_samples(s, cam, poses, 100, np.random.default_rng(1), far=1.6)
    assert 0 < len(near) < 400


def test_covered_tolerates_offsets_along_the_normal_only():
    # samples on the plane z = 0 (normal +z); vertices 2.5 cm above the first,
    # 2 cm beside the second, 4 cm above the third, none near the fourth
    samples = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]])
    normals = np.tile([0.0, 0.0, 1.0], (4, 1))
    verts = np.array([[0.0, 0.0, 0.025], [1.02, 0.0, 0.0], [2.0, 0.0, 0.04]])
    got = coverage.covered(samples, normals, verts, along=0.01, across=0.03)
    assert got.tolist() == [True, False, False, False]
    assert coverage.covered(samples, normals, verts, 0.03, 0.05).tolist() == [True, True, True, False]
    assert not coverage.covered(samples, normals, np.zeros((0, 3)), 0.01, 0.03).any()


def test_normals_of_the_walls_and_spheres():
    s = Scene(ROOM)
    pts = np.array([[2.0, 0.3, 0.2], [0.1, -1.0, 0.4], [0.0, 0.0, 0.5]])
    assert np.allclose(coverage.normals(s, pts), [[-1, 0, 0], [0, 1, 0], [0, 0, -1]], atol=1e-6)
