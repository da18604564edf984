"""chip_smoke.py's operation counts for the bounds of K2 and its F-frame
mode, on small hand-written SASS listings in cuobjdump's format: the
regions sass_regions finds, the work counted once a voxel and frame, once
a voxel and once a chunk, and that the F-frame mode's counts per voxel do
not depend on how many voxels a thread holds."""

import importlib.util
import os

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
