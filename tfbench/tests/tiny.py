"""A tiny cell for the CPU tests: the fr1proxy-2cm.loop cell at a quarter
of the fr1 camera's resolution (160 x 120), 5 cm voxels and the JAX
package's tiny-test capacities, 24-frame sessions on the 120-frame loop's
path, on the CPU."""

import copy

from tfbench import harness

CAMERA = dict(width=160, height=120, fx=129.325, fy=129.125, cx=79.65, cy=63.825,
              d0=0.12, d1=-0.18, d2=-0.004, d3=0.003, d4=0.0)
# the tiny cell's limits: above what its sound sessions read on the CPU
# (ATE 4.4-8.8 mm, map 6.9-9.5, TSDF 5.3-7.3, colour 2.3-7.9 levels,
# the export's 2.5-7.5, uncovered 0.26-0.42%, untextured 6.1-6.4% on
# seeds 5, 77, 2**31 + 977 and 2148484625); the control reads ATE 26-30
# mm there, half of the chunks integrated 21-22% uncovered, half of them
# textured 48-52% untextured
LIMITS = {"ate_mm": 16.0, "map_rms_mm": 25.0, "tsdf_median_mm": 20.0, "colour_median": 20.0,
          "export_colour_median": 20.0, "uncovered_pct": 5.0, "untextured_pct": 20.0}


def cell(frames: int = 24) -> harness.Cell:
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    c = harness.find_cell(bench, "fr1proxy-2cm.loop")
    cfg = copy.deepcopy(c.config)
    cfg["camera"] = dict(CAMERA)
    p = cfg["pipeline"]
    p["camera"].update(CAMERA)
    p["tracking"].update(max_features=256, max_features_pad=256, max_matches_pad=256,
                         ransac_iterations=128, min_matches=12)
    p["ba"] = dict(max_keyframes=32, max_edges=128)
    p["tsdf"].update(voxel_resolution=0.05, capacity=2048, max_update_chunks=512)
    p["mesh"] = dict(max_mesh_chunks=512)
    p["texture"] = dict(atlas_size=2048)
    c.config = cfg
    c.mix = dict(copy.deepcopy(c.mix), frames_per_session=frames, warm_frames=4)
    c.limits = dict(LIMITS)
    return c
