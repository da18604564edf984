"""k2_roofline: K2's share of its roofline over the traced stretch, in %.

K2 is the program's TSDF voxel update (texturefusion_torch/csrc/
tsdf_integrate.cu): one frame with colour or depth only
(tsdf_integrate_kernel), or F depth-only frames in one pass (its F-frame
mode, tsdf_integrate_frames_kernel). The least time its launches need is
the larger of the bytes their data needs at the card's HBM rate and
their operations at the card's float32 rate (tfbench/peaks.json), both
counted here from the launches' shapes (the program's counters LANES
and FRAME_SHAPES between the stretch's ends): per listed voxel its sdf
and weight read once, per lane its slot index and chunk origin read
once (and, for the one-frame mode, its quality and updated flag
written), per frame its pose read once; per voxel and frame the
world-to-camera transform (9 multiplies, 9 adds) and the projection (2
divisions, 2 multiplies, 2 adds). What K2 writes back depends on the
data: the harness counts the voxels whose weight changed to a non-zero
value over the stretch (their sdf and weight written once) and those
whose colour count changed (their colour and count read and written
once), from the volume's rows at the stretch's two ends. A voxel
updated twice, or updated back to where it was, counts once or not at
all, and the depth and colour taps are not counted, so the share is a
lower bound. The device time is the summed duration of K2's ops in the
trace. A card with no entry in the table of peaks, or a trace whose
count of K2 ops is not the program's count of launches, is an error."""

UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "tsdf_integrate"
VOXELS = 512
ROW_BYTES = 8                 # sdf and weight, float32 each
LANE_BYTES = 8 + 12           # int64 slot index, float32 origin
LANE_OUT_BYTES = 4 + 1        # one-frame mode: float32 quality, bool updated
POSE_BYTES = 64
COLOUR_BYTES = 2 * (12 + 4)   # colour accumulators and count, read and written
OPS_PER_VOXEL_FRAME = 24


def work(single_lanes: int, frame_shapes, written: int = 0, coloured: int = 0) -> tuple:
    """(bytes, float32 operations) of K2's launches: `single_lanes` lanes
    of one-frame launches in all, the F-frame launches as {(frames,
    lanes, mixed signs): count}, `written` voxels whose sdf and weight
    were written back and `coloured` voxels whose colour was."""
    n_bytes = written * ROW_BYTES + coloured * COLOUR_BYTES
    n_bytes += single_lanes * (VOXELS * ROW_BYTES + LANE_BYTES + LANE_OUT_BYTES)
    ops = single_lanes * VOXELS * OPS_PER_VOXEL_FRAME
    for (frames, lanes, _), count in frame_shapes.items():
        n_bytes += count * (lanes * (VOXELS * ROW_BYTES + LANE_BYTES) + frames * POSE_BYTES)
        ops += count * lanes * VOXELS * frames * OPS_PER_VOXEL_FRAME
    return n_bytes, ops


def bound_s(n_bytes: float, ops: float, peak: dict) -> float:
    return max(n_bytes / peak["hbm_bytes_per_s"], ops / peak["fp32_flops_per_s"])


def read(run):
    tr, k2 = run.trace, run.k2
    if not tr or not k2:
        return None
    if not run.peak:
        raise RuntimeError("k2_roofline: the card has no entry in tfbench/peaks.json")
    device_s = sum(s for name, s in tr["by_name"].items() if KERNEL in name)
    n_ops = sum(1 for name, _, _ in tr["ops"] if KERNEL in name)
    if n_ops != k2["launches"]:
        raise RuntimeError(f"k2_roofline: the trace holds {n_ops} K2 ops, the program "
                           f"counted {k2['launches']} launches")
    if not n_ops:
        return None
    n_bytes, ops = work(k2["single_lanes"], k2["frame_shapes"], k2.get("written", 0),
                        k2.get("coloured", 0))
    return 100.0 * bound_s(n_bytes, ops, run.peak) / device_s
