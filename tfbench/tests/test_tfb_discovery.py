"""The harness finds each piece by its name: a configuration, a traffic
mix, a metric and a cell's limits added as new files are taken without
editing any file that is there."""

import json
import os
import shutil

from tfbench import harness


def test_new_files_are_found_by_name(tmp_path):
    here = tmp_path / "tfbench"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "fr1proxy-2cm.json").read_text())
    cfg["pipeline"]["tsdf"]["voxel_resolution"] = 0.01
    (here / "configs" / "fr1proxy-1cm.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "loop.json").read_text())
    mix["trajectory"]["revolutions"] = 1 / 6
    (here / "traffic" / "pan.json").write_text(json.dumps(mix))
    (here / "limits" / "fr1proxy-1cm.pan.json").write_text(json.dumps({"ate_mm": 9.0}))
    (here / "metrics" / "frames_total.py").write_text(
        'UNIT = "frames"\n\n\ndef read(run):\n'
        '    return sum(len(s.timing.frame_s) for s in run.sessions)\n')
    bench = json.loads(open(os.path.join(harness.ROOT, "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "fr1proxy-1cm.pan", "config": "fr1proxy-1cm",
                               "traffic": "pan", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_total", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "fusion.pipeline finish",
                               "moves": "frames_per_s", "workloads": ["fr1proxy-1cm.pan"]})
    cell = harness.find_cell(bench, "fr1proxy-1cm.pan", here=str(here))
    assert cell.config["pipeline"]["tsdf"]["voxel_resolution"] == 0.01
    assert cell.mix["trajectory"]["revolutions"] == 1 / 6
    assert cell.limits == {"ate_mm": 9.0}
    assert [m["name"] for m in cell.per_layer] == ["frames_total"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "frame_ms_p95", "setup_s"}
    reader = harness.load_reader("frames_total", here=str(here))
    run = harness.Run(seed=1, setup_s=1.0, window_s=1.0, stopwatch_totals={}, stopwatch_counts={},
                      sessions=[harness.SessionRecord(type("T", (), {"frame_s": [0.1] * 7})(), None)])
    assert reader.UNIT == "frames" and reader.read(run) == 7
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_metric_of_the_benchmark_has_its_reader_and_unit():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.load_reader(m["name"]).UNIT == m["unit"], m["name"]
    for m in bench["per_layer"]:
        assert harness.load_reader(m["name"]).MOVES == m["moves"], m["name"]
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.limits and cell.config["pipeline_class"]
