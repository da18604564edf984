"""chip_smoke.py's operation counts for the bounds of K2 and its F-frame
mode, on small hand-written SASS listings in cuobjdump's format: the
regions sass_regions finds, the work counted once a voxel and frame, once
a voxel and once a chunk, and that the F-frame mode's counts per voxel do
not depend on how many voxels a thread holds. Then the pure helpers of
[cli-dataset] and [cli-synthetic] on the CPU: the packed-frame unpacking,
the TUM directory writer and its bit-for-bit read-back, and the check of
the command line's outputs; [fr1-proxy]'s reading of the command line's
counts and [demo]'s tool loading. Last, [pipeline-sharded]'s texture readers on
a tiny textured run over eight CPU shards: the texture audit reads the
sharded volume and pool as the unsharded ones, and sharded_cycle_check
finds the cycle through the sharded reader exact. [sol]'s operation counts
of a row's work, its report with the launches a frame of [pipeline], and
the check of the measurement phases' times."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

K2_NAME = "_ZN50_GLOBAL__N__17_tsdf_integrate_cu21tsdf_integrate_kernelEPfS0_"
FRAMES_NAME = "_ZN50_GLOBAL__N__17_tsdf_integrate_cu28tsdf_integrate_frames_kernelEPfS0_"
# per voxel and frame: the projection's 9 products and 9 sums, two
# divisions (MUFU.RCP), two roundings and a conversion; per voxel after the
# frames: 5 fp32 and the update's division; per thread: 2 sums
FRAME_FP32, FRAME_XU, ONCE_FP32, THREAD_FP32 = 18, 5, 5, 2


def _function(name, body):
    """cuobjdump -sass text of one function: body is a list of
    instructions, with "@label" standing for a label's address and
    "label:" lines marking the next instruction."""
    addr, labels, code = 0, {}, []
    for item in body:
        if item.endswith(":"):
            labels[item[:-1]] = addr
        else:
            code.append((addr, item))
            addr += 16
    lines = [f"\t\tFunction : {name}"]
    for a, ins in code:
        for label, target in labels.items():
            ins = ins.replace(f"@{label}", hex(target))
        lines.append(f"        /*{a:04x}*/                   {ins} ;")
    return "\n".join(lines)


def _frames_kernel(voxels):
    """An F-frame kernel of `voxels` voxels a thread: a per-thread
    prologue, a staging block behind a forward branch, the frame loop
    (with a call to a division's slow path), the per-voxel update and the
    slow path after the exit."""
    body = ["S2R R0, SR_TID.X"] + ["FADD R1, R2, R3"] * THREAD_FP32
    body += ["ISETP.GE.AND P0, PT, R0, R4, PT", "@P0 BRA @staged"]
    body += ["FMUL R5, R6, R7"] * 30 + ["FSEL R8, R9, RZ, P1"] * 64 + ["STS.128 [R10], R12"]
    body += ["staged:", "BAR.SYNC.DEFER_BLOCKING 0x0", "loop:"]
    for _ in range(voxels):
        body += ["FMUL R11, R12, R13"] * 9 + ["FADD R11, R12, R13"] * 9
        body += ["MUFU.RCP R14, R15", "CALL.REL.NOINC @slow", "MUFU.RCP R14, R16"]
        body += ["FRND R17, R18", "FRND R19, R20", "F2I.NTZ R21, R22",
                 "LDG.E.CONSTANT R23, desc[UR4][R24.64]"]
    body += ["IADD3 R25, R25, 0x1, RZ", "ISETP.LT.AND P1, PT, R25, R26, PT",
             "@P1 BRA @loop"]
    for _ in range(voxels):
        body += ["FADD R27, R28, R29"] * 4 + ["FMUL R30, R31, R32", "MUFU.RCP R33, R34"]
    body += ["STG.E.64 desc[UR4][R35.64], R36", "EXIT", "slow:"]
    body += ["FFMA R37, R38, R39, R40"] * 12 + ["RET.REL.NODEC R2 0x0"]
    return _function(FRAMES_NAME, body)


def _k2_kernel(main_fp32, colour_fp32):
    """A K2 kernel: main_fp32 fp32 instructions a thread, colour_fp32 more
    in a block behind a forward branch."""
    body = ["S2R R0, SR_TID.X"] + ["FMUL R1, R2, R3"] * main_fp32
    body += ["MUFU.RCP R4, R5", "FRND R6, R7", "@!P0 BRA @after"]
    body += ["FADD R8, R9, R10"] * colour_fp32 + ["STG.E.128 desc[UR4][R11.64], R12"]
    body += ["after:", "EXIT"]
    return _function(K2_NAME, body)


@pytest.fixture
def rates(monkeypatch):
    """Unit rates: one operation a second for each lane a clock."""
    monkeypatch.setattr(chip_smoke, "sm_rate", lambda per_clock: float(per_clock))
    monkeypatch.setattr(chip_smoke, "SASS", {})


@pytest.mark.parametrize("voxels", [1, 2, 4])
def test_frames_counts_per_voxel(rates, voxels):
    text = _k2_kernel(100, 20) + "\n" + _frames_kernel(voxels)
    counts = chip_smoke.sass_kernel_counts(text)
    c = counts["tsdf_integrate_frames"]
    assert c["loop"]["rcp"] == 2 * voxels and c["loop"]["fp32"] == FRAME_FP32 * voxels
    assert c["cond"]["fp32"] == 30 + 64                          # the staging block
    assert c["main"]["fp32"] == (THREAD_FP32 + 30 + 64 + (FRAME_FP32 + ONCE_FP32) * voxels)
    per = chip_smoke.frames_per_voxel(c)
    assert per["frame"]["fp32"] == FRAME_FP32 and per["frame"]["xu"] == FRAME_XU
    assert per["once"]["fp32"] == pytest.approx(ONCE_FP32 + THREAD_FP32 / voxels)
    assert per["once"]["xu"] == 1
    chip_smoke.SASS.update(counts)
    ops = chip_smoke.frames_ops(6, 10)
    want = 512 * 10 * (6 * FRAME_FP32 + ONCE_FP32 + THREAD_FP32 / voxels)
    assert ops["fp32"] == (pytest.approx(want), chip_smoke.FP32_PER_SM_CLOCK)
    assert ops["xu"][0] == 512 * 10 * (6 * FRAME_XU + 1)


def test_k2_counts_chunk_work_once(rates):
    text = _k2_kernel(100, 20) + "\n" + _frames_kernel(2)
    chip_smoke.SASS.update(chip_smoke.sass_kernel_counts(text))
    c = chip_smoke.SASS["tsdf_integrate"]
    assert c["cond"]["fp32"] == 20 and c["main"]["fp32"] == 120 and c["loop"]["all"] == 0
    once = chip_smoke.K2_CHUNK_FP32
    ops = chip_smoke._k2_ops(3, 50)
    assert ops["fp32"] == (3 * (128 * (100 - once) + once) + 50 * 20,
                           chip_smoke.FP32_PER_SM_CLOCK)
    assert ops["xu"] == (3 * 128 * 2, chip_smoke.XU_PER_SM_CLOCK)


def _tiny_packed(n):
    from texturefusion_torch.config import tiny_test_config
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops.preprocess import pack_frame
    cfg = tiny_test_config()
    poses = synthetic.orbit_trajectory(n)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(),
                                             cam.Intrinsics.from_config(cfg.camera), poses,
                                             device="cpu")
    rng = np.random.default_rng(0)
    packed = [pack_frame((d * 5000 + rng.integers(0, 3, d.shape) * (d > 0)).astype(np.uint16),
                         (c * 255).astype(np.uint8)) for d, c in zip(depths, rgbs)]
    return cfg, poses, packed


def test_unpack_frame_inverts_pack_frame():
    from texturefusion_torch.ops.preprocess import pack_frame
    rng = np.random.default_rng(2)
    d = rng.integers(0, 65536, (7, 9)).astype(np.uint16)
    c = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    d2, c2 = chip_smoke.unpack_frame(pack_frame(d, c))
    np.testing.assert_array_equal(d2, d)
    np.testing.assert_array_equal(c2, c)


@pytest.mark.parametrize("filter_type", [0, 4])
def test_tum_writer_round_trip(tmp_path, filter_type):
    """[cli-dataset]'s TUM directory: frames read back bit for bit, the
    calib (distortion fields included) and the ground truth as written."""
    import dataclasses

    from texturefusion_torch.io import tum
    cfg, poses, packed = _tiny_packed(3)
    camera = dataclasses.replace(cfg.camera, d0=-0.03, d1=0.005)
    stamps = chip_smoke.write_tum_dataset(str(tmp_path), camera, packed, poses,
                                          filter_type=filter_type)
    seq, decode_s = chip_smoke.read_back_tum(str(tmp_path), packed)
    assert decode_s > 0
    np.testing.assert_allclose(seq.timestamps, stamps, atol=1e-6)
    assert dataclasses.asdict(seq.camera) == dataclasses.asdict(
        dataclasses.replace(camera, far_plane=type(camera)().far_plane))
    np.testing.assert_allclose(seq.gt_poses, np.stack(poses), atol=1e-6)
    packed[1] = packed[1].copy()
    packed[1][0, 0, 2] ^= 1
    with pytest.raises(AssertionError, match="frame 1"):
        chip_smoke.read_back_tum(str(tmp_path), packed)


def test_check_cli_outputs_finds_what_is_missing(tmp_path):
    from texturefusion_torch.io import ply, png
    (tmp_path / "keyframes").mkdir()
    ply.save_trajectory_tum(str(tmp_path / "trajectory.txt"), [0.0, 1.0], np.stack([np.eye(4)] * 2))
    ply.save_ply(str(tmp_path / "fused.ply"), np.zeros((5, 3), np.float32))
    for name in ("stat.txt", "chunk.txt"):
        (tmp_path / name).write_text("x\n")
    (tmp_path / "keyframes" / "000000.cam").write_text(" ".join(["0.5"] * 16) + "\n")
    png.write_png(str(tmp_path / "keyframes" / "000000.png"), np.zeros((2, 2, 3), np.uint8))
    assert chip_smoke.check_cli_outputs(str(tmp_path), 2, textured=False) == \
        {"verts": 5, "keyframes": 1}
    with pytest.raises(AssertionError, match="missing"):
        chip_smoke.check_cli_outputs(str(tmp_path), 2)          # no model.obj / .mtl / .png
    with pytest.raises(AssertionError, match="trajectory"):
        chip_smoke.check_cli_outputs(str(tmp_path), 3, textured=False)
    (tmp_path / "keyframes" / "000000.png").unlink()
    with pytest.raises(AssertionError, match="keyframes"):
        chip_smoke.check_cli_outputs(str(tmp_path), 2, textured=False)


def test_cli_run_stats_reads_stat_and_chunk(tmp_path):
    """[fr1-proxy]'s counts from the command line's stat.txt (a stopwatch
    report, then the stats and memory lines, as save_stats writes them)
    and chunk.txt; no "cpp_ba" line is 0 BA rounds."""
    from texturefusion_torch.utils.stopwatch import Stopwatch
    sw = Stopwatch()
    for name in ("cpp_ba", "cpp_ba", "cpp_ba", "tracking"):
        with sw.time(name):
            pass
    body = ("frames: 120\nkeyframes: 29\nreintegrations: 32\nreintegrations_reuse: 4\n"
            "device_tsdf_mb: 201.00\n")
    (tmp_path / "stat.txt").write_text(sw.report() + "\n" + body)
    (tmp_path / "chunk.txt").write_text("chunks_created 6927 active 5012 meshed 1396\n")
    want = {"keyframes": 29, "reintegrations": 32, "ba_rounds": 3, "chunks_created": 6927,
            "chunks_meshed": 1396}
    assert chip_smoke.cli_run_stats(str(tmp_path)) == want
    assert set(want) | {"verts", "ate_mm"} == set(chip_smoke.JAX_PROXY_RUN)
    (tmp_path / "stat.txt").write_text(body)
    assert chip_smoke.cli_run_stats(str(tmp_path)) == dict(want, ba_rounds=0)


def test_load_tool_and_the_demo_gates():
    mk = chip_smoke.load_tool("make_tum_proxy")
    demo = chip_smoke.load_tool("demo_synthetic")
    assert mk.FR1_CAMERA["d0"] == 0.12 and callable(mk.generate) and callable(demo.run)
    assert set(chip_smoke.DEMO_MODES) == set(chip_smoke.DEMO_JAX_EXIT) == {"gt", "slam"}


def test_texture_readers_of_a_sharded_pipeline():
    import dataclasses

    import torch

    from texturefusion_torch.parallel.mesh import make_mesh
    torch.set_num_threads(2)
    cfg = chip_smoke._pipeline_config(small=True)
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, n_devices=8))
    _, packed = chip_smoke._orbit_frames(cfg, 11)
    shd = chip_smoke.run_pipeline(cfg, packed, "cpu", textured=True,
                                  mesh=make_mesh(8, "cpu"))[0]
    ref = chip_smoke.run_pipeline(cfg, packed, "cpu", textured=True)[0]
    assert shd.volume.sharded and not ref.volume.sharded
    audit = chip_smoke._texture_audit(shd)
    assert audit == chip_smoke._texture_audit(ref) and audit["seen_whole"] > 0
    check = chip_smoke.sharded_cycle_check(shd)
    assert check["exact"] and check["shards"] == 8 and check["projected"] > 20, check
    assert "ms" not in check                     # timed on the card only


def test_deferral_counts_and_the_prefetch_audit():
    """[pipeline-bench]'s counters on the CPU at the tiny size: the default
    config defers the cycle results and prefetches every keyframe's
    discovery; each integration over a prefetch is audited, after the
    run, against a discovery from the depth and pose it integrated at;
    CPU fetches land at once, so no consume finds a handle not ready. LandedFetch takes a tensor or a tuple."""
    import torch

    from texturefusion_torch.utils.stopwatch import STOPWATCH
    torch.set_num_threads(2)
    cfg = chip_smoke._pipeline_config(small=True, pipelined=True)
    assert cfg.parallel.async_cycle_results
    assert not chip_smoke._pipeline_config(small=True).parallel.async_cycle_results
    _, packed = chip_smoke._orbit_frames(cfg, 20)
    STOPWATCH.reset()
    pipe = chip_smoke.run_pipeline(cfg, packed, "cpu", textured=True, audit=True)[0]
    c = chip_smoke.deferral_counts(pipe)
    assert c["prefetch_used"] == c["audited_integrations"] == len(pipe.slam.keyframes) >= 4
    assert c["prefetch_missed"] == c["prefetch_deferred"] == c["integrations_deferred"] == 0
    assert c["count_batches_late"] >= 3 and c["obs_batches_late"] >= 3
    assert c["count_consumes_not_ready"] == c["obs_flushes_not_ready"] == 0
    assert c["texture_consumes_not_ready"] == c["texture_dispatches_skipped"] == 0
    assert c["prefetched_chunks"] > 100 and 0.0 <= c["lacked_band_weight_share"] <= 1.0
    assert len(c["prefetch_lacked_chunks"]) == c["audited_integrations"]
    one = chip_smoke.LandedFetch(torch.ones(3))
    two = chip_smoke.LandedFetch((torch.ones(2), torch.zeros(1, dtype=torch.int64)))
    assert one.done() and one.result().tolist() == [1.0, 1.0, 1.0]
    assert [a.tolist() for a in two.result()] == [[1.0, 1.0], [0]]


def test_sol_ops_add_each_launch(rates):
    chip_smoke.SASS.update(chip_smoke.sass_kernel_counts(
        _k2_kernel(100, 20) + "\n" + _frames_kernel(2)))
    one = chip_smoke._k2_ops(400, 30)
    two = chip_smoke.sol_ops({"k2": [(400, 30), (400, 30)]})
    assert two == {u: (2 * c, r) for u, (c, r) in one.items()}
    assert chip_smoke.sol_ops({"frames": (6, 400)}) == chip_smoke.frames_ops(6, 400)
    k1 = chip_smoke.sol_ops({"k1_taps": 1000})
    assert k1 == {"fp32": (chip_smoke.K1_FLOPS_PER_TAP * 1000, chip_smoke.FP32_FLOPS_PER_S),
                  "exp unit": (1000, chip_smoke.EXP_PER_SM_CLOCK)}
    assert chip_smoke.sol_ops({}) == {}
    with pytest.raises(ValueError, match="two rates"):
        chip_smoke.sol_ops({"k2": [(1, 1)], "k1_taps": 10})


def test_sol_report_writes_the_launches_a_frame(tmp_path):
    import json
    sol = chip_smoke.load_tool("sol_report")
    rows = [{"kernel": name, "calls_per_cycle": None} for name in sol.ROWS]
    path = str(tmp_path / "out" / "sol.json")
    chip_smoke.sol_report(rows, {"bilateral": 120, "tsdf_integrate": 74,
                                 "tsdf_integrate_frames": 60}, {"x": 1}, path)
    with open(path) as f:
        report = json.load(f)
    got = {r["kernel"]: r["calls_per_cycle"] for r in report["kernels"]}
    assert got[sol.ROWS[0]] == 74 / 120 and got[sol.ROWS[2]] == 0.5 and got[sol.ROWS[6]] == 1.0
    assert sum(v is not None for v in got.values()) == 3 and report["scaling"] == {"x": 1}


@pytest.mark.parametrize("bad", [{"ms": 0.0}, {"device_ms": float("nan")}, {"device_ops": 0},
                                 {"span_ms": -1.0}])
def test_positive_times_rejects_a_bad_time(bad):
    good = {"ms": 1.0, "span_ms": 0.5, "device_ms": 0.2, "device_ops": 3.0}
    chip_smoke._positive_times("x", {"a": good, "host only": {"ms": 1.0, "span_ms": None,
                                                              "device_ms": None,
                                                              "device_ops": None}})
    with pytest.raises(AssertionError, match="a time not finite and positive"):
        chip_smoke._positive_times("x", {"a": {**good, **bad}})
