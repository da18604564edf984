#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Runs these phases (each prints one line of numbers; any failure exits
non-zero):
  1. device   - requires CUDA; prints the card's name and power limit
  2. build    - compiles both hand-written kernels with nvcc (sm_90a),
                one process per source, all at once; [sass] counts the
                built K2 and F-frame kernels' instructions (cuobjdump),
                the operations of their bounds
  3. K1       - bilateral kernel vs its plain PyTorch version on a
                480x640 depth image with holes and a depth step (radius
                4, timed), and at radius 1 and 8 and on 479x641 and
                120x160 images
  4. K2       - TSDF voxel-update kernel vs its plain version at
                S = 16384 slots, 1008 listed chunks: +1 from an empty
                volume, -1 on a pre-integrated volume, depth only, chunks
                0.16-0.64 m from the camera, and 2048 chunks (the default
                config's whole update budget); one integrate_frame_fused
                call must be one device op (torch.profiler)
     Each kernel is timed alone (kernel_ms warm: events around 100
     back-to-back launches of the bare kernel call, queued behind a
     device-side sleep; kernel_cold_ms: single launches after a 128 MiB
     write evicts the L2, median of 20), as its wrapper is called on the
     path (call_ms: one event pair around the call, median of 20; it
     includes the host's dispatch) and as its plain version (plain_ms),
     beside its bound (bound_ms, and what binds) and the share of the
     bound that kernel_ms reaches.
  5. slice    - the ground-truth-pose main path at the bench's size
                (after a 10-frame warm-up through a throwaway volume):
                120 VGA frames of the 360-degree loop in the bench room,
                2 cm voxels, rendered on the GPU with sensor noise, packed,
                preprocessed (K1), integrated into TSDFVolume (K2),
                meshed every 10 frames and exported as PLY; map error
                against the analytic scene, launch counts, K2's mean lanes
                a launch, and K2 timed alone at that width beside its
                full-row bound
  6. small    - the same path on a 160x120 input, GPU kernels against
                the CPU's plain versions
  7. profile  - 20 slice frames under torch.profiler: device ops a frame,
                device busy share and the ops that take most of the time
  8. tracked  - the tracked SLAM path on bench.py's hardened loop (after a
                10-frame warm-up through a throwaway GCSLAM): 120 VGA
                frames with noise, an exposure step and a blur burst;
                preprocess (K1), features, registration against the last
                keyframe and the previous frame, keyframe-depth fusion
                (frame_step_tracked2), GCSLAM decisions, promotion probes,
                BA with bench.py's schur_min_keyframes = 16, final BA.
                Gates: ATE <= 25 mm, at least one loop-closure edge, BA
                over at least 16 keyframes, K1 launched once per frame
  9. tracked-small - the tracked path on the tiny config (160x120, 30
                orbit frames: promotions, loop-closure probes, BA and the
                final BA) on the GPU and on the CPU with the same RANSAC
                draws: at least 4 keyframes and one loop-closure edge on
                each, keyframes within 1, same origins, trajectories
                within 1 mm
 10. profile-tracked - 10 tracked frames under torch.profiler (no gate)
 11. pipeline - ReconstructionPipeline (fusion/pipeline.py) on the same
                120 hardened frames (after a 10-frame warm-up): tracking,
                keyframe integration at the tracked poses (K2), the local
                frames' depth-only passes (K2's F-frame mode), drift
                reintegration, meshing, GC, then finish() (final BA,
                reintegration at the final poses) and the exports (welded
                PLY, trajectory.txt). Gates: ATE <= 25 mm, map RMS <= 32 mm
                and median < 20 mm after bench.py's Umeyama alignment, at
                least one loop-closure edge and one reintegration, BA
                over at least 16 keyframes, K1 once per frame, K2 and the
                F-frame mode launched; prints the F-frame mode's launch
                shapes (frames, lanes), and [k2-frames-path] holds it
                against its plain version and times it alone at each of
                them, beside one launch with every lane off
 12. pipeline-async - the same with the fusion thread (async_fusion=True,
                bench.py's setting): the same gates, frames/s beside [pipeline]
 13. pipeline-stream - the same, synchronous, with max_resident_chunks at
                half of [pipeline]'s final map and a 3 m streaming radius:
                the same gates, residency within the budget plus one
                update's chunks, chunks offloaded, vertex count within 5%
                of [pipeline]'s
 14. pipeline-textured - TexturedPipeline, synchronous, on the same 120
                frames with the default TextureConfig (13824² atlas, 96-px
                patches, 16 labels, 12 ICM sweeps, 384 projections a cycle),
                then export_textured: [pipeline]'s gates, ATE within 0.01 mm
                and vertices within 0.1% of [pipeline]'s (texturing writes
                no TSDF row), the atlas not full, at least half the
                meshed chunks patched and not wrong, the OBJ/MTL/PNG
                consistent; prints the texture stages, why the wrong chunks
                are wrong, and the colour error against the scene's colour
                (voxel, raw atlas and exported colours)
 15. pipeline-deferred - [pipeline-textured] with async_cycle_results=True
                (the mesh counts, texture outputs, GC probe and
                observation qualities of a cycle consumed at the start of
                the next; finish() catches up): [pipeline-textured]'s
                gates ([pipeline]'s, ATE and vertices beside [pipeline]'s,
                the texture's); map RMS, vertices,
                patched share, colour error and frames/s beside
                [pipeline-textured]'s, and the deferral counts
 16. pipeline-bench - TexturedPipeline with bench.py's config exactly
                (bench.py:162-184: the fusion thread, the default tracker,
                pipelined at depth 2 with deferred promotion and the
                stale-frame refinement, the cycle results consumed a cycle
                late; no cut) on the same 120 frames, then flush_tracking,
                finish and the textured export: [pipeline]'s gates, at
                least one stale-finalized frame and one adopted
                refinement, [pipeline-textured]'s texture gates; frames/s
                beside [pipeline]'s and [pipeline-textured]'s,
                t_stats_sync, the frames that rode past the depth, the
                most in flight, promotions consumed late; the deferral
                counts: prefetches used / deferred / missed, deferred
                integrations, count and observation batches consumed late
                and the consumes that found a handle not ready, texture
                dispatches skipped, GC probes deferred, and the chunks each
                prefetch lacked against a discovery at integration, with
                the share of the keyframe's band weight they hold (that
                audit made after the run, outside its clocks)
 17. pipeline-small - TexturedPipeline on the tiny config (10 orbit frames),
                GPU against CPU with the same draws, geometry and texture;
                then the pipelined tracker (depth 2, deferred promotion,
                20 orbit frames) the same way, its fetches landed at once,
                each cycle reading its own results, and again with the
                cycle results deferred (the same deferral counts)
 18. profile-pipeline - 10 pipeline frames under torch.profiler (no gate)
 19. cli-synthetic - `python -m texturefusion_torch "" "" 0.02 4 --max-frames
                30` in process (VGA, textured): exit 0, a trajectory line a
                frame, stat.txt and chunk.txt, fused.ply with vertices, a
                .cam and a .png a keyframe, model.obj / .mtl / .png;
                frames/s and launches
 20. cli-dataset - [slice]'s 120 frames written as a TUM directory through
                io/png (Paeth rows; associate, calib with distortion,
                groundtruth), read back bit for bit (PNG decode ms a
                frame), each frame uploaded pageable and pinned (ms), then
                the command line on it, textured: its outputs as in 18, and
                its trajectory.txt against groundtruth.txt, ATE <= 25 mm
 21. checkpoint - [pipeline]'s config and frames to frame 60, save_pipeline,
                load_pipeline into a fresh pipeline: TSDF rows, slot map,
                poses, keypoint DB and edges bit for bit; frames 60-119 and
                finish() there: new keyframes and edges, one map origin,
                ATE <= 25 mm, map RMS <= 32 mm; save / load seconds, bytes
 22. ba-sharded - distributed_gn and schur_gn (sep_budget 24) over 4 shards
                (4 cards where the machine has them, else 4 shards of the
                one card) against the dense fastba.gauss_newton_rounds on a
                64-keyframe chain: poses within rtol 2e-3, atol 2e-4 of the
                dense ones; ms a round for each, edges per shard, separators
 23. multichip - dryrun_multichip over the same 4 shards (one full map
                cycle with K2 on every shard, then the live pipeline,
                tsdf_sharded, on three tiny frames): its asserts; the map
                cycle on the card against the same cycle on 8 CPU shards
 24. pipeline-sharded - TexturedPipeline on [pipeline]'s config and 120
                frames with the TSDF rows, the mesh pool and BA's edges
                sharded over the 4 shards (slot s on shard s % 4), then
                export_textured: [pipeline]'s gates, ATE and map RMS within
                0.5 mm of [pipeline]'s, resident chunks per shard within 10%
                of their mean; [pipeline-textured]'s texture gates (half the
                meshed chunks patched and not wrong, the atlas not full, the
                OBJ/MTL/PNG consistent); one texture cycle through the
                sharded pool reader bit for bit against the same cycle on
                the pool assembled on one card, and the reader's gather
                timed alone; frames/s, the texture stages, the colour error
                and the share of chunks with the same label beside
                [pipeline-textured]'s; K2 and F-frame launches per shard,
                the largest position difference, keyframe and loop-edge
                counts beside [pipeline]'s; K2 and the F-frame mode against
                their plain versions on one shard's rows
 25. fr1-proxy - tools/make_tum_proxy.py's generate: 120 VGA frames of the
                fr1 proxy (docs/ATE_PROXY.md: the distorted freiburg1
                camera, Kinect axial noise quantised to 0.2 mm, shadow
                dropout and speckle, exposure flicker and step, a blur
                burst, ground truth in a mocap frame) rendered on the
                card and written as a TUM directory, then the command line
                on it with the JAX script's --run arguments (`ROOT "" 0.02
                0 --out ROOT/out`), textured: exit 0, 120 poses associated
                with groundtruth.txt, ATE <= 25 mm, the outputs as in 19,
                K1, K2 and the F-frame mode launched; prints keyframes,
                reintegrations, BA rounds, chunks created and meshed,
                vertices and ATE beside the JAX package's recorded TPU run
                (context, not a target), frames/s, the generation seconds
                and the bytes written
 26. demo     - tools/demo_synthetic.py in process at --size vga, 8 frames,
                ground-truth mode and --slam --texture: each with the exit
                code of examples/demo_synthetic.py at the same arguments
                on the CPU (DEMO_JAX_EXIT), K1 and K2 launched; prints
                vertices, map median, ATE, keyframes, lost frames and
                frames/s
Phases 25 and 26 run after [checkpoint].
After phase 5, [raycast] renders 8 VGA views of [slice]'s volume
(ops/raycast.raycast_volume; plain torch ops, no kernel) against the
scene rendered there: hit share > 0.5, median depth error below a voxel,
95% unit normals; refine_depth_to_isosurface on one noisy frame must
move it towards the surface.
Phase 4 also checks reintegrate_frame_fused (two K2 launches) and K2's
F-frame mode ([k2-frames]: F = 6 at +1, fresh and pre-integrated; F = 3
at +1; F = 6 and 12 as a drift reintegration, half the frames at -1, the
other half at +1 at poses moved 6 mm / 0.5 deg) against their plain
versions, and times the F-frame mode alone.
After [k2-frames] four phases run the port's measurement tools, each
printing its rows (ms: median host clock of calls each ending in a
synchronize; span_ms: CUDA events around one call; device_ms and
device_ops: one call under torch.profiler; utils/devtime), every time
finite and above 0:
  [sol]           tools/sol_report.py: the 8 hot programs of the JAX
                  script at its inputs, each beside its JAX bytes, the
                  bytes its data needs, its bound (sol_ops) and its shares
                  of the bound over device_ms and ms, none above 1.0; K1, K2
                  and the F-frame mode launched (counted in the kernels
                  line). After [pipeline] the rows get K1's, K2's and the
                  F-frame mode's launches a frame there and go with
                  [bench-multichip]'s rates to chiprun_out/sol_report_h100.json
  [bench-multichip] tools/bench_multichip.py on one card and on 4 shards
                  of it (overhead, not scaling): the sharded TSDF step (rows
                  bit for bit), distributed BA, the full map cycle (the same
                  n_found, vertex counts and labels), dense against Schur ms
                  a GN iteration at K = 64-512 (Schur within BA_RTOL /
                  BA_ATOL); a 4-card mesh raises on fewer cards
  [stages]        tools/profile_stages.py: each stage of the frame path
  [frame-profile] tools/profile_frame.py: dispatch, copies, discovery,
                  the allocator, integration
The line before the last is a JSON object with each kernel's launches
over the phases that drive it (5, 8, 11-16, 19-21, 23-26 and [sol]), its error against the plain
version and its times, bound and share; the last line is
{"ok": true, "device": {...}}.

Phases 8-15, 17's first run, 21 and 24 run the synchronous tracker
(defer_promote=False, pipelined_tracking=False), which the earlier PRs'
numbers were taken with, and, but 15, read each fusion cycle's results
in the cycle (async_cycle_results=False); 16, 17's second and third
runs, the command line (19, 20, 25), [demo]'s --slam run (26) and
[multichip]'s three tiny frames (23) run the default, pipelined tracker,
and 16, 17's third run, 19, 20, 23, 25 and 26 the deferred cycle results. Every pipeline prefetches each
keyframe's chunk discovery at its promotion, as the JAX package does.

Imports nothing of jax or of the JAX package. Builds into texturefusion_torch/_build/.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

K1_TOL = 1e-5
# test_pallas_voxel.py tolerances: (rtol, atol) per row array
K2_ROW_TOL = {"sdf": (1e-5, 1e-5), "weight": (1e-6, 1e-6),
              "color": (1e-4, 1e-3), "color_count": (1e-6, 1e-6)}
K2_Q_TOL = (1e-4, 1e-2)
MAP_MEDIAN_MM = 20.0      # below the 2 cm voxel (examples/demo_synthetic.py rule)
MAP_RMS_MM = 32.0         # the frozen map gate of tests/test_bench_regression.py
ATE_MM = 25.0             # the frozen ATE gate of tests/test_bench_regression.py
TEX_ATE_MM = 0.01         # [pipeline-textured]: ATE and vertices beside [pipeline]'s
TEX_VERTS_FRAC = 0.001
# [pipeline-textured]: meshed chunks patched and not wrong
TEX_PATCHED_FRAC = 0.5
BA_MIN_KEYFRAMES = 16     # bench.py's schur_min_keyframes: [tracked] and [pipeline*] BA past it
SMALL_KF_DIFF = 1         # [tracked-small]: keyframe counts GPU vs CPU
SMALL_MIN_KF = 4          # [tracked-small]: keyframes each device must promote
SMALL_TRAJ_MM = 1.0       # [tracked-small]: largest frame-position difference GPU vs CPU
                          # (0.439 mm measured on an H100 80GB HBM3 at 700 W; 0.006 mm
                          # on every frame before the last)
BLUR_FRAMES = (46, 47, 48)    # bench.py's hardened loop
EXPOSURE_GAIN = 1.55
EXPOSURE_FRAMES = (60, 95)
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12      # K1 (built with fused multiply-adds): an FFMA is 2 operations
EXP_PER_SM_CLOCK = 16         # MUFU.EX2 results a clock per SM (the FP32 pipe: 128)
# K2 and its F-frame mode are built with -fmad=false: their bound counts the
# SASS instructions of the built kernels (cuobjdump), fp32 ones at the FP32
# pipe's issue rate and conversions and MUFU at theirs (CUDA C Programming
# Guide, throughput of native arithmetic instructions, compute capability 9.0)
FP32_PER_SM_CLOCK = 128
XU_PER_SM_CLOCK = 16
SASS_FP32 = {"FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET", "FCHK", "FSWZADD"}
SASS_XU = {"MUFU", "F2I", "I2F", "F2F", "FRND"}
# fp32 operations of K2 that depend only on the frame and the chunk, which
# each of its threads computes again (tsdf_integrate_kernel's pose inverse
# 15, the origin's camera depth 6, the truncation and its band limit 7,
# w * sign 1): the bound counts them once a chunk
K2_CHUNK_FP32 = 29
# K1 fp32 operations per tap: subtract, square, spatial product,
# multiply-add (2), weight add; and one exp
K1_FLOPS_PER_TAP = 6
FLUSH_BYTES = 128 << 20       # > the 50 MB L2: a cold launch follows this write
SLEEP_CYCLES = 50_000_000     # ~25 ms of device sleep: longer than the host's queuing
N_SHARDS = 4                  # [multichip], [ba-sharded], [pipeline-sharded]
BA_RTOL, BA_ATOL = 2e-3, 2e-4     # test_parallel.py's Schur tolerances: sharded vs dense
BA_SEP_BUDGET = 24
SHARDED_MM = 0.5              # [pipeline-sharded]: ATE and map RMS beside [pipeline]'s
SHARD_BALANCE = 0.10          # [pipeline-sharded]: resident chunks per shard around their mean


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int = 20, warm: int = 5) -> float:
    """Median of n CUDA-event timings of fn(), one event pair per call,
    after `warm` warm-up calls. Around a wrapper this includes the host's
    dispatch of everything it launches: the `call_ms` and `plain_ms`."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_times(launch, n: int = 100, n_cold: int = 20):
    """The kernel alone, its inputs prepared by the caller: (warm ms,
    cold ms). A GPU-side sleep enqueued first lets the host queue every
    launch before the device reaches the first event, so the host's
    dispatch stays out of both. Warm: events around n back-to-back
    launches, divided by n. Cold: median of n_cold single launches, each
    after a FLUSH_BYTES write (outside the events) evicts the 50 MB L2."""
    for _ in range(5):
        launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(n):
        launch()
    b.record()
    b.synchronize()
    warm = a.elapsed_time(b) / n
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    cold = []
    for i in range(n_cold):
        flush.fill_(float(i))
        torch.cuda._sleep(SLEEP_CYCLES // 20)
        a.record()
        launch()
        b.record()
        b.synchronize()
        cold.append(a.elapsed_time(b))
    del flush
    return warm, float(np.median(cold))


def sm_rate(per_clock: int) -> float:
    """A unit's peak a second: SMs x per_clock x the card's maximum SM clock
    (nvidia-smi clocks.max.sm)."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * per_clock * mhz * 1e6


_SASS_FUNC = re.compile(r"^\s*Function : (\S+)")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)"
                         r"\s*([^;]*);")


def sass_functions(text: str) -> dict:
    """cuobjdump -sass output -> {mangled name: [(address, opcode, opcode with
    modifiers, operands)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(2) + m.group(3), m.group(4)))
    return funcs


def _sass_target(ins):
    m = re.search(r"0x([0-9a-f]+)", ins[3])
    return int(m.group(1), 16) if m else None


def sass_regions(instrs) -> dict:
    """A kernel's code in three regions, by its branches: "main" (before its
    first called subroutine, the slow path of a division), "loop" (the
    spans of its backward branches: a loop and the remainder of its
    unrolling) and "cond" (the widest forward branch's span outside the
    loops, not around one: K2's colour block, the F-frame mode's per-frame
    staging)."""
    calls = [_sass_target(i) for i in instrs if i[1] == "CALL"]
    end = min(calls) if calls else instrs[-1][0] + 1
    main = [i for i in instrs if i[0] < end]
    branches = [(i[0], t) for i in main if i[1] == "BRA" and (t := _sass_target(i)) is not None]
    loops = [(t, a) for a, t in branches if t < a]

    def in_loop(x):
        return any(lo <= x <= hi for lo, hi in loops)

    conds = [(a, t) for a, t in branches if t > a and not (
        in_loop(a) or in_loop(t) or any(a < lo and hi < t for lo, hi in loops))]
    c_lo, c_hi = max(conds, key=lambda r: r[1] - r[0]) if conds else (end, end)
    return {"main": main, "loop": [i for i in main if in_loop(i[0])],
            "cond": [i for i in main if c_lo < i[0] < c_hi]}


def sass_op_counts(instrs) -> dict:
    """Instructions in all, fp32-pipe ones, conversions and MUFU ("xu"), and
    MUFU.RCP (one a division)."""
    c = {"all": 0, "fp32": 0, "xu": 0, "rcp": 0}
    for _, base, full, _ in instrs:
        c["all"] += 1
        c["fp32"] += base in SASS_FP32
        c["xu"] += base in SASS_XU
        c["rcp"] += full == "MUFU.RCP"
    return c


SASS = {}    # per kernel: {region: op counts} of the built library (phase_build)


def _k2_ops(n_chunks: int, n_colour_threads: int) -> dict:
    """K2's operations from its SASS: each chunk's 128 threads (4 voxels
    each) run the main code outside the colour block, but its
    K2_CHUNK_FP32 frame-and-chunk operations count once a chunk; the
    threads with a voxel in the colour band also run that block."""
    c = SASS["tsdf_integrate"]
    once = {"fp32": K2_CHUNK_FP32, "xu": 0}
    return {u: (n_chunks * (128 * (c["main"][u] - c["cond"][u] - once[u]) + once[u])
                + n_colour_threads * c["cond"][u], sm_rate(rate))
            for u, rate in (("fp32", FP32_PER_SM_CLOCK), ("xu", XU_PER_SM_CLOCK))}


def frames_per_voxel(c: dict) -> dict:
    """The F-frame mode's operations per voxel from its SASS region counts
    `c`: "frame", the frame loop's code once a voxel and a frame (its body
    holds two MUFU.RCP a voxel and a frame, its projection's divisions);
    "once", the code around the loop and outside the staging (one MUFU.RCP
    a voxel, its update's division). The staging block, once a frame and
    block, is left out: a few dozen operations a frame against the loop's
    ~25,000 a chunk and frame."""
    units = ("fp32", "xu", "all")
    rest = {u: c["main"][u] - c["loop"][u] - c["cond"][u] for u in units + ("rcp",)}
    return {"frame": {u: c["loop"][u] / (c["loop"]["rcp"] / 2) for u in units},
            "once": {u: rest[u] / rest["rcp"] for u in units}}


def frames_ops(n_frames: int, n_lanes: int) -> dict:
    """The F-frame mode's operations over n_lanes chunks of 512 voxels and
    n_frames frames (frames_per_voxel)."""
    per = frames_per_voxel(SASS["tsdf_integrate_frames"])
    return {u: (512 * n_lanes * (n_frames * per["frame"][u] + per["once"][u]), sm_rate(rate))
            for u, rate in (("fp32", FP32_PER_SM_CLOCK), ("xu", XU_PER_SM_CLOCK))}


def phase_sass():
    """Count the built K2 and F-frame kernels' SASS instructions by region
    (cuobjdump -sass on the library): the operations of their bounds."""
    from torch.utils.cpp_extension import CUDA_HOME

    from texturefusion_torch.ops import cuda_kernels
    lib = cuda_kernels.build()
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    text = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", lib._name],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    SASS.update(sass_kernel_counts(text))
    per = frames_per_voxel(SASS["tsdf_integrate_frames"])
    log(f"[sass] K2 per thread (4 voxels): {json.dumps(SASS['tsdf_integrate'])}; F-frame mode "
        f"per thread {json.dumps(SASS['tsdf_integrate_frames'])}: a voxel and a frame "
        f"{per['frame']['fp32']:.2f} fp32, {per['frame']['xu']:.2f} conversions and MUFU, "
        f"{per['frame']['all']:.2f} in all; a voxel outside the frame loop "
        f"{per['once']['fp32']:.2f} fp32, {per['once']['xu']:.2f} conversions and MUFU")


def sass_kernel_counts(text: str) -> dict:
    """cuobjdump -sass output of the built library -> the op counts of each
    region of K2 ("tsdf_integrate") and of its F-frame mode."""
    funcs = sass_functions(text)
    counts = {}
    for key, pattern in (("tsdf_integrate", "21tsdf_integrate_kernel"),
                         ("tsdf_integrate_frames", "28tsdf_integrate_frames_kernel")):
        names = [n for n in funcs if pattern in n]
        if len(names) != 1:
            raise AssertionError(f"{len(names)} SASS functions match {pattern}")
        counts[key] = {r: sass_op_counts(ins) for r, ins in sass_regions(funcs[names[0]]).items()}
    return counts


def bound_ms(n_bytes: float, ops: dict):
    """The least time the card could take: the largest of bytes over the
    memory rate and, for each kind of operation in `ops` ({unit: (count,
    peak per s)}), its count over its peak. Returns (ms, "bytes" or
    "operations", the unit that binds)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, **{k: n / r for k, (n, r) in ops.items()}}
    unit = max(times, key=times.get)
    return times[unit] * 1e3, ("bytes" if unit == "bytes" else "operations"), unit


def timing_fields(launch, call, plain, n_bytes, ops) -> dict:
    """The numbers each kernel reports: kernel alone (warm, cold), the
    wrapper as the path calls it, the plain version, the bound and the
    share of it that the warm kernel reaches."""
    warm, cold = kernel_times(launch)
    bms, by, unit = bound_ms(n_bytes, ops)
    return {"ms": warm, "kernel_ms": warm, "kernel_cold_ms": cold,
            "call_ms": cuda_ms(call), "plain_ms": cuda_ms(plain),
            "bound_ms": bms, "bound_by": by, "bound_unit": unit, "share": bms / warm,
            "library_ms": None}


def fmt_times(t: dict) -> str:
    by = t["bound_by"] if t["bound_unit"] == "bytes" else f"{t['bound_by']}: {t['bound_unit']}"
    return (f"kernel_ms={t['kernel_ms']:.4f} kernel_cold_ms={t['kernel_cold_ms']:.4f} "
            f"call_ms={t['call_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({by}) share={t['share']:.3f} library_ms=none")


def device_ops(fn) -> list:
    """Names of the device ops (kernels, copies, fills) of one fn() call,
    from torch.profiler, after one untraced call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a trace that caught no device event at all is traced again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs CUDA: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"clocks.sm,clocks.max.sm,temperature.gpu={nvidia_smi('clocks.sm,clocks.max.sm,temperature.gpu')}")
    return smi


def nvidia_smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def phase_build():
    from texturefusion_torch.ops import cuda_kernels
    t0 = time.perf_counter()
    cuda_kernels.build(verbose=True)
    flags = "; ".join(f"{src} {' '.join(extra) or '(no extra flags)'}"
                      for src, extra in cuda_kernels.SOURCES.items())
    log(f"[build] nvcc {' '.join(cuda_kernels.NVCC_FLAGS)}; {flags}: "
        f"{time.perf_counter() - t0:.2f} s")


def _k1_depth(h: int, w: int, seed: int) -> torch.Tensor:
    """Depth in 0.5-3 m with a 1 m step at mid-width and ~5% holes."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    d[:, w // 2:] += 1.0
    d[rng.random(d.shape) < 0.05] = 0.0
    return torch.as_tensor(d, device="cuda")


def phase_k1():
    """K1 against its plain version at radius 4 on VGA (timed), and at
    radius 1 and 8 and on ragged sizes (checked only)."""
    from texturefusion_torch.ops import cuda_kernels, preprocess
    for r, (h, w) in ((1, (480, 640)), (8, (480, 640)), (4, (479, 641)), (4, (120, 160))):
        x = _k1_depth(h, w, r)
        got = cuda_kernels.bilateral_cuda(x, radius=r)
        ref = preprocess.bilateral_filter_plain(x, radius=r)
        err = float((got - ref).abs().max())
        if not (err <= K1_TOL and bool(((got == 0) == (ref == 0)).all())):
            raise AssertionError(f"K1 disagrees with its plain version at r={r}, {h}x{w}")
        log(f"[k1] r={r} {h}x{w}: max_abs_err={err:.3e}")
    dev = _k1_depth(480, 640, 0)
    got = cuda_kernels.bilateral_cuda(dev)
    ref = preprocess.bilateral_filter_plain(dev)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    same_invalid = bool(((got == 0) == (ref == 0)).all())
    # the taps this frame needs: valid taps inside the image around valid centres
    valid = (dev > 0).to(torch.float32)[None, None]
    taps = int((torch.nn.functional.conv2d(valid, torch.ones(1, 1, 9, 9, device="cuda"),
                                           padding=4) * valid).sum())
    t = timing_fields(lambda: cuda_kernels.bilateral_cuda(dev),
                      lambda: preprocess.bilateral_filter(dev),
                      lambda: preprocess.bilateral_filter_plain(dev),
                      2 * dev.numel() * 4, {"fp32": (K1_FLOPS_PER_TAP * taps, FP32_FLOPS_PER_S),
                                            "exp unit": (taps, sm_rate(EXP_PER_SM_CLOCK))})
    log(f"[k1] bilateral 480x640 r=4: max_abs_err={err:.3e} (tol {K1_TOL}) "
        f"invalid_match={same_invalid} {fmt_times(t)}")
    if not (err <= K1_TOL and same_invalid):
        raise AssertionError("K1 disagrees with its plain version")
    return {"max_abs_err": err, **t}


def _k2_inputs(pre_integrated: bool, seed: int, scene: str = "wall"):
    """A noisy wall at z = 2 m before a VGA camera; 2 cm voxels; listed
    chunks at random slots of S = 16384. "wall": 1008 chunks around the
    wall. "wide": 2048 chunks of x in [-1.28, 1.28), y in [-0.96, 0.96),
    z in [1.28, 3.04) m, the default config's whole update budget. "near":
    a wall at 0.4 m and the 105 chunks of x in [-0.48, 0.64), y in
    [-0.32, 0.48), z in [0.16, 0.64) m, most partly outside the view (the
    TPU kernel clamped chunks this near). idx lists the chunks' slots,
    padded with the trash slot to the budget U (1024; 2048 for "wide"),
    and active marks the real lanes: the plain version takes both, the
    kernel idx[:n] alone, as TSDFVolume lists them."""
    from texturefusion_torch.config import CameraConfig, TSDFConfig
    from texturefusion_torch.core import camera as cam
    cfg = TSDFConfig(voxel_resolution=0.02, capacity=16384,
                     max_update_chunks=2048 if scene == "wide" else 1024)
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    s1, v, u = cfg.capacity + 1, 512, cfg.max_update_chunks
    near = scene == "near"
    rng = np.random.default_rng(seed)
    d = np.full((intr.height, intr.width), 0.4 if near else 2.0, np.float32)
    d += rng.normal(0, 0.004 if near else 0.02, d.shape).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    rgb = rng.random((intr.height, intr.width, 3)).astype(np.float32)
    quality = rng.random((intr.height, intr.width)).astype(np.float32)
    if pre_integrated:
        w = rng.integers(0, 4, (s1, v)).astype(np.float32)
        rows = [rng.normal(0, 0.05, (s1, v)).astype(np.float32), w,
                (rng.random((s1, v, 3)) * 90).astype(np.float32), w.copy()]
    else:
        rows = [np.full((s1, v), 999.0, np.float32), np.zeros((s1, v), np.float32),
                np.zeros((s1, v, 3), np.float32), np.zeros((s1, v), np.float32)]
    if near:
        ids = [(x, y, z) for x in range(-3, 4) for y in range(-2, 3) for z in range(1, 4)]
    elif scene == "wide":
        ids = [(x, y, z) for x in range(-8, 8) for y in range(-6, 6) for z in range(8, 19)]
        ids = [ids[i] for i in sorted(rng.permutation(len(ids))[:u])]
    else:
        ids = [(x, y, z) for x in range(-8, 8) for y in range(-5, 4) for z in range(10, 17)]
    ids = np.asarray(ids, np.int32)
    n = len(ids)
    slots = rng.permutation(cfg.capacity)[:n]
    idx = np.concatenate([slots, np.full(u - n, cfg.capacity)]).astype(np.int64)
    origins = np.zeros((s1, 3), np.float32)
    origins[slots] = ids * (cfg.chunk_size * cfg.voxel_resolution)
    active = np.arange(u) < n
    c = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return (cfg, intr, [c(a) for a in rows], c(origins), c(idx), c(active), c(d),
            c(rgb), c(quality), torch.eye(4, device="cuda"), n)


def _k2_bytes(n: int, with_color: bool, h: int, w: int) -> int:
    """Full-row count: the listed rows read and written once (sdf, weight;
    with colour also 3 colour floats and the count), the image planes read
    once (depth; with colour rgb and quality), and per lane its slot, flag
    and origin."""
    row_floats = 512 * (6 if with_color else 2)
    return 2 * n * row_floats * 4 + h * w * 4 * (5 if with_color else 1) + n * (8 + 1 + 12)


def _k2_needed(before, after, origins, idx, n, pose, intr, cfg):
    """What this frame's data needs: the bytes (the rows of the voxels that
    change, read and written: sdf and weight 16 B, colour and count 32 B;
    the distinct depth pixels the in-image voxels sample, 4 B; the
    distinct rgb and quality pixels the changed colour voxels sample, 16
    B; per lane its slot, flag and origin) and the operations of _k2_ops
    (every lane's 128 threads; those with a changed colour voxel)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.core import geometry, se3
    rows = idx[:n]
    changed = [a[rows] != b[rows] for a, b in zip(before, after)]
    upd = changed[0] | changed[1]
    cupd = changed[2].any(-1) | changed[3]
    cent = torch.as_tensor(geometry.voxel_centroids(cfg.chunk_size, cfg.voxel_resolution),
                           device=pose.device)
    world = (origins[rows][:, None, :] + cent[None]).reshape(-1, 3)
    uv, z = cam.project(intr, se3.transform_points(se3.inverse(pose), world))
    ur, vr = torch.round(uv[:, 0]), torch.round(uv[:, 1])
    in_img = (ur > 0) & (ur < intr.width - 1) & (vr > 0) & (vr < intr.height - 1) & (z > 0)
    pix = (vr * intr.width + ur).long()
    n_pix = int(pix[in_img].unique().numel())
    n_cpix = int(pix[cupd.reshape(-1) & in_img].unique().numel())
    n_bytes = (int(upd.sum()) * 16 + int(cupd.sum()) * 32 + n_pix * 4 + n_cpix * 16
               + n * (8 + 1 + 12))
    return n_bytes, _k2_ops(n, int(cupd.reshape(n, 128, 4).any(-1).sum()))


def phase_k2():
    from texturefusion_torch.ops import cuda_kernels, tsdf
    worst = 0.0
    times = {}
    for name, sign, pre, with_color, scene in (("plus_fresh", 1.0, False, True, "wall"),
                                               ("minus_pre", -1.0, True, True, "wall"),
                                               ("depth_only", 1.0, True, False, "wall"),
                                               ("near", 1.0, True, True, "near"),
                                               ("wide_plus", 1.0, True, True, "wide"),
                                               ("wide_minus", -1.0, True, True, "wide")):
        cfg, intr, rows, origins, idx, active, d, rgb, q, pose, n = _k2_inputs(pre, 1, scene)
        kb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        pb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        frame = (d, rgb, q, pose, sign, intr, cfg)
        kq, ku = tsdf.integrate_frame_fused(kb, origins, idx[:n], None, *frame,
                                            with_color=with_color)
        pq, pu = tsdf.integrate_frame_fused_plain(pb, origins, idx, active, *frame,
                                                  with_color=with_color)
        torch.cuda.synchronize()
        errs = _k2_row_errors(name, kb, pb, cfg.capacity)
        q_err = float((kq - pq[:n]).abs().max())
        if with_color and not bool(((kq - pq[:n]).abs()
                                    <= K2_Q_TOL[1] + K2_Q_TOL[0] * pq[:n].abs()).all()):
            raise AssertionError(f"K2 {name}: quality disagrees (max {q_err:.3e})")
        if not (ku.shape == (n,) and bool((ku == pu[:n]).all())):
            raise AssertionError(f"K2 {name}: updated flags disagree")
        n_upd = int(ku.sum())
        worst = max(worst, *errs.values())
        log(f"[k2] {name} S={cfg.capacity} lanes={n} updated={n_upd} "
            f"partial_or_behind={int((kq < -1e10).sum())}: "
            + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
            + f" quality_err={q_err:.3e}")
        if name == "plus_fresh":
            args = (origins, idx[:n], None, *frame)
            ops = device_ops(lambda: tsdf.integrate_frame_fused(kb, *args))
            log(f"[k2] one integrate_frame_fused call: {len(ops)} device op(s) {ops}")
            if len(ops) != 1:
                raise AssertionError(f"integrate_frame_fused ran {len(ops)} device ops, not 1")
            needed, ops = _k2_needed(rows, pb, origins, idx, n, pose, intr, cfg)
            times = timing_fields(lambda: cuda_kernels.tsdf_integrate_cuda(
                                      *kb, idx[:n], None, origins, *frame),
                                  lambda: tsdf.integrate_frame_fused(kb, *args),
                                  lambda: tsdf.integrate_frame_fused_plain(
                                      pb, origins, idx, active, *frame),
                                  needed, ops)
            full = _k2_full_bound_ms(n, intr.height, intr.width)
            log(f"[k2] timing plus_fresh, {n} lanes: {fmt_times(times)}; the data needs "
                f"{needed} B; at full rows and planes the bound is {full:.4f} ms "
                f"(share {full / times['kernel_ms']:.3f})")
            times["full_row_bound_ms"] = full
        del kb, pb, rows
    worst = max(worst, _k2_reintegrate_check())
    return {"max_abs_err": worst, **times}


def _k2_reintegrate_check() -> float:
    """reintegrate_frame_fused (two K2 launches: -1 at the old pose, +1 at
    a pose moved 6 mm / 0.5 deg) against its plain version on the "wall"
    scene, pre-integrated. Returns the largest row error."""
    from texturefusion_torch.ops import tsdf
    cfg, intr, rows, origins, idx, active, d, rgb, q, _, n = _k2_inputs(True, 2)
    depths, p_old = _k2_frames(1, 5)
    p_new = _k2_frames(1, 5, moved=True)[1]
    kb = tsdf.ChunkBatch(*(a.clone() for a in rows))
    pb = tsdf.ChunkBatch(*(a.clone() for a in rows))
    kq, ku = tsdf.reintegrate_frame_fused(kb, origins, idx[:n], None, d, rgb, q, p_old[0],
                                          p_new[0], intr, cfg)
    pq, pu = tsdf.reintegrate_frame_fused_plain(pb, origins, idx, active, d, rgb, q, p_old[0],
                                                p_new[0], intr, cfg)
    errs = _k2_row_errors("reintegrate", kb, pb, cfg.capacity)
    if not (bool((ku == pu[:n]).all()) and bool(((kq - pq[:n]).abs()
                                                 <= K2_Q_TOL[1] + K2_Q_TOL[0] * pq[:n].abs()).all())):
        raise AssertionError("reintegrate_frame_fused: quality or updated flags disagree")
    log(f"[k2] reintegrate_frame_fused {n} lanes, -1 at the old pose, +1 at the new: "
        + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
        + f" updated={int(ku.sum())} quality_err={float((kq - pq[:n]).abs().max()):.3e}")
    return max(errs.values())


def _k2_row_errors(name, got, want, cap) -> dict:
    """Max error of each row array on [:cap] against K2_ROW_TOL; raises."""
    errs = {}
    for (field, (rtol, atol)), a, b in zip(K2_ROW_TOL.items(), got, want):
        diff = (a[:cap] - b[:cap]).abs()
        errs[field] = float(diff.max())
        if not bool((diff <= atol + rtol * b[:cap].abs()).all()):
            raise AssertionError(f"K2 {name}: {field} disagrees (max {errs[field]:.3e})")
    return errs


def _k2_frames(n_frames: int, seed: int, moved: bool = False):
    """n_frames depth planes of the 2 m wall (noise N(0, 0.02), 5% holes)
    and poses within ~1 cm / ~0.5 deg of the identity; `moved` draws the
    same poses moved 6 mm / 0.5 deg further (a drift correction)."""
    from texturefusion_torch.core import se3
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.config import CameraConfig
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    rng = np.random.default_rng(seed)
    d = (2.0 + rng.normal(0, 0.02, (n_frames, intr.height, intr.width))).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    xi = np.concatenate([rng.normal(0, 0.005, (n_frames, 3)),
                         rng.normal(0, 0.004, (n_frames, 3))], axis=1).astype(np.float32)
    poses = se3.se3_exp(torch.as_tensor(xi))
    if moved:
        poses = poses @ se3.se3_exp(torch.tensor([0.006, 0.0, 0.0, 0.0, 0.0087, 0.0]))
    return torch.as_tensor(d, device="cuda"), poses.contiguous().cuda()


def _frames_needed_bytes(before, after, origins, idx, n, depths, poses, intr, cfg) -> int:
    """What one F-frame pass's data needs: the sdf and weight of the voxels
    that change, read and written (16 B), each frame's distinct depth
    pixels sampled by in-image voxels (4 B), the poses, and per lane its
    slot, flag and origin."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.core import geometry, se3
    rows = idx[:n]
    changed = (before[0][rows] != after.sdf[rows]) | (before[1][rows] != after.weight[rows])
    cent = torch.as_tensor(geometry.voxel_centroids(cfg.chunk_size, cfg.voxel_resolution),
                           device="cuda")
    world = (origins[rows][:, None, :] + cent[None]).reshape(-1, 3)
    n_pix = 0
    for f in range(depths.shape[0]):
        uv, z = cam.project(intr, se3.transform_points(se3.inverse(poses[f]), world))
        ur, vr = torch.round(uv[:, 0]), torch.round(uv[:, 1])
        ok = (ur > 0) & (ur < intr.width - 1) & (vr > 0) & (vr < intr.height - 1) & (z > 0)
        n_pix += int((vr * intr.width + ur)[ok].unique().numel())
    return int(changed.sum()) * 16 + n_pix * 4 + poses.numel() * 4 + n * (8 + 1 + 12)


def _frames_full_bytes(n: int, n_frames: int, h: int, w: int) -> int:
    """The F-frame mode at full rows and planes: sdf and weight rows read
    and written (8 KB a chunk), the F depth planes and poses read once,
    per lane its slot, flag and origin."""
    return 2 * n * 512 * 2 * 4 + n_frames * (h * w * 4 + 64) + n * (8 + 1 + 12)


def phase_k2_frames():
    """K2's F-frame mode against integrate_depths_batched_plain on the
    "wall" scene (1008 chunks): F = 6 at +1, fresh and pre-integrated; F =
    3 at +1 and F = 6 as -1 x 3, +1 x 3 (the shapes of the main path's
    local-frame passes and reintegrations) and F = 12, -1 x 6 at one set
    of poses and +1 x 6 at poses moved 6 mm / 0.5 deg, pre-integrated.
    sdf and weight within K2_ROW_TOL, colour rows untouched; one
    integrate_depths_batched call is one device op; timed alone in every
    pre-integrated case beside its bounds."""
    from texturefusion_torch.ops import cuda_kernels, tsdf
    worst, times = 0.0, {}
    for name, n_frames, pre, mixed in (("f6_fresh", 6, False, False), ("f6_pre", 6, True, False),
                                       ("f3_pre", 3, True, False),
                                       ("f6_reintegrate", 6, True, True),
                                       ("f12_reintegrate", 12, True, True)):
        cfg, intr, rows, origins, idx, active, *_, n = _k2_inputs(pre, 3)
        if mixed:
            d, p_old = _k2_frames(n_frames // 2, 4)
            p_new = _k2_frames(n_frames // 2, 4, moved=True)[1]
            depths, poses = torch.cat([d, d]), torch.cat([p_old, p_new])
            signs = [-1.0] * (n_frames // 2) + [1.0] * (n_frames // 2)
        else:
            depths, poses = _k2_frames(n_frames, 4)
            signs = 1.0
        kb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        pb = tsdf.ChunkBatch(*(a.clone() for a in rows))
        args = (origins, idx[:n], None, depths, poses, signs, intr, cfg)
        tsdf.integrate_depths_batched(kb, *args)
        tsdf.integrate_depths_batched_plain(pb, origins, idx, active, depths, poses, signs,
                                            intr, cfg)
        torch.cuda.synchronize()
        errs = _k2_row_errors(name, kb, pb, cfg.capacity)
        if not (torch.equal(kb.color, rows[2]) and torch.equal(kb.color_count, rows[3])):
            raise AssertionError(f"K2 F-frame {name}: colour rows changed")
        worst = max(worst, errs["sdf"], errs["weight"])
        n_vox = int(((kb.sdf != rows[0]) | (kb.weight != rows[1]))[idx[:n]].sum())
        log(f"[k2-frames] {name} F={n_frames} lanes={n}: sdf_err={errs['sdf']:.3e} "
            f"weight_err={errs['weight']:.3e} colour_untouched=True changed_voxels={n_vox}")
        if name == "f6_fresh":
            ops = device_ops(lambda: tsdf.integrate_depths_batched(kb, *args))
            log(f"[k2-frames] one integrate_depths_batched call: {len(ops)} device op(s) {ops}")
            if len(ops) != 1:
                raise AssertionError(f"integrate_depths_batched ran {len(ops)} device ops, not 1")
        if name != "f6_fresh":
            needed = _frames_needed_bytes(rows, pb, origins, idx, n, depths, poses, intr, cfg)
            sg = tsdf.frame_signs(signs, n_frames)
            t = timing_fields(
                lambda: cuda_kernels.tsdf_integrate_frames_cuda(
                    kb.sdf, kb.weight, idx[:n], None, origins, depths, poses, sg, intr, cfg),
                lambda: tsdf.integrate_depths_batched(kb, *args),
                lambda: tsdf.integrate_depths_batched_plain(pb, origins, idx, active, depths,
                                                            poses, signs, intr, cfg),
                needed, frames_ops(n_frames, n))
            full = bound_ms(_frames_full_bytes(n, n_frames, intr.height, intr.width),
                            frames_ops(n_frames, n))[0]
            log(f"[k2-frames] timing {name}, F={n_frames}, {n} lanes: {fmt_times(t)}; the data "
                f"needs {needed} B; at full rows and planes the bound is {full:.4f} ms "
                f"(share {full / t['kernel_ms']:.3f})")
            t["full_row_bound_ms"] = full
            if name == "f6_pre":
                times.update(t)
            else:
                times[f"f{n_frames}{'r' if mixed else ''}"] = {
                    k: t[k] for k in ("kernel_ms", "kernel_cold_ms", "call_ms", "plain_ms",
                                      "bound_ms", "full_row_bound_ms")}
        del kb, pb, rows
    return {"max_abs_err": worst, **times}


def _k2_full_bound_ms(n: int, h: int, w: int) -> float:
    """K2's bound at full rows and planes for n chunks of an h x w frame
    (every thread in the colour band)."""
    return bound_ms(_k2_bytes(n, True, h, w), _k2_ops(n, 128 * n))[0]


def k2_width_times(width: int, tsdf_integrate=None, seed: int = 1):
    """K2 alone (kernel_times: warm, cold ms) on `width` chunks drawn at
    random from the "wide" scene, +1 on pre-integrated rows. The main
    path's width is K2's mean lanes on [slice]. `tsdf_integrate(rows,
    slots, origins, d, rgb, q, pose, sign, intr, cfg)` launches the
    kernel once; by default cuda_kernels.tsdf_integrate_cuda on the
    slots alone."""
    from texturefusion_torch.ops import cuda_kernels
    cfg, intr, rows, origins, idx, _, d, rgb, q, pose, n = _k2_inputs(True, seed, "wide")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slots = idx[:n][torch.randperm(n, generator=gen, device="cuda")[:width]].contiguous()
    if tsdf_integrate is None:
        def tsdf_integrate(rows, slots, *frame):
            return cuda_kernels.tsdf_integrate_cuda(*rows, slots, None, *frame)
    return kernel_times(lambda: tsdf_integrate(rows, slots, origins, d, rgb, q, pose, 1.0,
                                               intr, cfg))


_WIDE_ROWS = {}     # the "wide" scene's inputs, made once per seed


def frames_case(n_frames: int, width: int, mixed: bool, seed: int = 1):
    """One of the main path's F-frame shapes: `width` chunks drawn at random
    from the "wide" scene (pre-integrated; its rows made once per seed and
    shared by every case) and n_frames depth planes of its wall; with
    `mixed`, a drift reintegration (the first half of the frames at -1,
    the same planes at +1 at poses moved 6 mm / 0.5 deg), else a
    local-frame pass at +1. Returns (cfg, intr, rows, origins, slots,
    depths, poses, signs)."""
    if seed not in _WIDE_ROWS:
        _WIDE_ROWS[seed] = _k2_inputs(True, seed, "wide")
    cfg, intr, rows, origins, idx, *_, n = _WIDE_ROWS[seed]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slots = idx[:n][torch.randperm(n, generator=gen, device="cuda")[:width]].contiguous()
    if mixed:
        d, p_old = _k2_frames(n_frames // 2, seed)
        depths = torch.cat([d, d])
        poses = torch.cat([p_old, _k2_frames(n_frames // 2, seed, moved=True)[1]])
        signs = (-1.0,) * (n_frames // 2) + (1.0,) * (n_frames // 2)
    else:
        depths, poses = _k2_frames(n_frames, seed)
        signs = (1.0,) * n_frames
    return cfg, intr, rows, origins, slots, depths, poses, signs


def frames_width_times(n_frames: int, width: int, mixed: bool, seed: int = 1,
                       integrate_frames=None):
    """K2's F-frame mode on frames_case(n_frames, width, mixed, seed): the
    kernel alone (kernel_times: warm, cold ms) and one call (cuda_ms: the
    host's dispatch included). `integrate_frames(sdf, weight, slots,
    origins, depths, poses, signs, intr, cfg)` launches the kernel once; by
    default cuda_kernels.tsdf_integrate_frames_cuda on the slots alone."""
    from texturefusion_torch.ops import cuda_kernels
    cfg, intr, rows, origins, slots, depths, poses, signs = frames_case(n_frames, width, mixed,
                                                                        seed)
    if integrate_frames is None:
        def integrate_frames(sdf, weight, slots, *args):
            cuda_kernels.tsdf_integrate_frames_cuda(sdf, weight, slots, None, *args)
    def launch():
        integrate_frames(rows[0], rows[1], slots, origins, depths, poses, signs, intr, cfg)

    return (*kernel_times(launch), cuda_ms(launch))


def _frames_case_check(n_frames: int, width: int, mixed: bool, seed: int = 1):
    """One frames_case through the kernel and its plain version, each on a
    copy of the rows: the sdf and weight rows of its slots within
    K2_ROW_TOL (raises). Returns (the largest row error, the bound: the
    bytes its data needs against frames_ops)."""
    from texturefusion_torch.ops import cuda_kernels, tsdf
    cfg, intr, rows, origins, slots, depths, poses, signs = frames_case(n_frames, width, mixed,
                                                                        seed)
    sdf, weight = rows[0].clone(), rows[1].clone()
    cuda_kernels.tsdf_integrate_frames_cuda(sdf, weight, slots, None, origins, depths, poses,
                                            signs, intr, cfg)
    before = [rows[0][slots], rows[1][slots]]
    after = tsdf.ChunkBatch(before[0].clone(), before[1].clone(), None, None)
    lanes = torch.arange(width, device="cuda")
    tsdf.integrate_depths_batched_plain(after, origins[slots], lanes, None, depths, poses,
                                        signs, intr, cfg)
    errs = _k2_row_errors(f"F-frame {n_frames}x{width}", (sdf[slots], weight[slots]),
                          (after.sdf, after.weight), width)
    needed = _frames_needed_bytes(before, after, origins[slots], lanes, width, depths, poses,
                                  intr, cfg)
    return max(errs.values()), bound_ms(needed, frames_ops(n_frames, width))[0]


def phase_k2_frames_path(shapes):
    """The F-frame mode at every (F, lanes) one [pipeline] run launched it
    at: against its plain version (_frames_case_check), and alone: the
    time a pipeline spends in it (launches x warm time), the mean time a
    launch, the same sum of the bounds, and the launch floor (the
    narrowest shape with every lane's flag off)."""
    from texturefusion_torch.ops import cuda_kernels
    total_warm = total_cold = total_call = total_bound = worst = 0.0
    per = {}
    for (f, w, mixed), c in sorted(shapes.items()):
        warm, cold, call = frames_width_times(f, w, mixed)
        per[f"{f}x{w}{'r' if mixed else ''}"] = round(warm, 5)
        total_warm += c * warm
        total_cold += c * cold
        total_call += c * call
        err, bound = _frames_case_check(f, w, mixed)
        worst = max(worst, err)
        total_bound += c * bound
    f, w, mixed = min(shapes)
    off = torch.zeros(w, dtype=torch.bool, device="cuda")

    def idle(sdf, weight, slots, *args):
        cuda_kernels.tsdf_integrate_frames_cuda(sdf, weight, slots, off, *args)

    floor_warm, floor_cold, _ = frames_width_times(f, w, mixed, integrate_frames=idle)
    n = sum(shapes.values())
    log(f"[k2-frames-path] {n} launches of [pipeline] at their shapes: sdf and weight against "
        f"the plain version max_err={worst:.3e}; in all "
        f"{total_warm:.4f} ms warm, {total_cold:.4f} ms cold, {total_call:.4f} ms as calls, bound "
        f"{total_bound:.4f} ms (share {total_bound / total_warm:.3f}); a launch "
        f"{total_warm / n:.4f} ms warm, {total_cold / n:.4f} ms cold; every lane off "
        f"({f}x{w}) {floor_warm:.5f} ms warm, {floor_cold:.5f} ms cold; warm ms by FxLanes (r: "
        f"reintegration) {json.dumps(per)}")
    return {"path_launches": n, "path_max_abs_err": worst, "path_total_ms": total_warm,
            "path_total_cold_ms": total_cold, "path_total_call_ms": total_call,
            "path_total_bound_ms": total_bound, "path_share": total_bound / total_warm,
            "path_mean_ms": total_warm / n, "path_mean_cold_ms": total_cold / n,
            "path_floor_ms": floor_warm, "path_floor_cold_ms": floor_cold}


def _slice_config(small: bool):
    from texturefusion_torch.config import CameraConfig, PipelineConfig, TSDFConfig
    if small:
        camera = CameraConfig(width=160, height=120, fx=131.25, fy=131.25, cx=79.5,
                              cy=59.5, far_plane=6.0, d0=-0.03, d1=0.005)
        return PipelineConfig(camera=camera, tsdf=TSDFConfig(
            voxel_resolution=0.05, capacity=2048, max_update_chunks=512))
    # bench.py's camera (mild Brown-Conrady distortion) and TSDF sizes
    return PipelineConfig(camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005),
                          tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                                          max_update_chunks=1024))


def _frames(config, n_frames, device, harden=False):
    """bench.py's room and loop, rendered with depth noise
    N(0, 0.016)·max(d, 0.5) from default_rng(3), packed to uint8. With
    `harden`, also bench.py's exposure step (×1.55 on frames 60-94) and
    blur burst (frames 46-48; scipy's gaussian_filter, σ = 3, in place of
    cv2.GaussianBlur)."""
    from scipy.ndimage import gaussian_filter

    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops.preprocess import pack_frame
    intr = cam.Intrinsics.from_config(config.camera)
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))
    poses = synthetic.loop_trajectory(n_frames, radius=1.5)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses, device=device)
    rng = np.random.default_rng(3)
    packed = []
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        noise = rng.normal(0.0, 0.016, d.shape).astype(np.float32) * np.maximum(d, 0.5)
        dn = np.where(d > 0, d + noise, 0.0)
        if harden and EXPOSURE_FRAMES[0] <= i < EXPOSURE_FRAMES[1]:
            c = np.clip(c * EXPOSURE_GAIN, 0.0, 1.0)
        if harden and i in BLUR_FRAMES:
            c = gaussian_filter(c, sigma=(3.0, 3.0, 0.0), mode="mirror")
        packed.append(pack_frame((dn * config.camera.depth_scale).astype(np.uint16),
                                 (c * 255).astype(np.uint8)))
    return scene, poses, packed


def run_slice(config, scene, poses, packed, device, mesh_every=10):
    """The main path: preprocess → TSDFVolume.integrate_frame →
    IncrementalMesher.update_meshes → full_mesh. Returns (volume,
    mesh, stage seconds)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.fusion.chunkmap import TSDFVolume
    from texturefusion_torch.fusion.mesher import IncrementalMesher
    from texturefusion_torch.ops import preprocess
    intr = cam.Intrinsics.from_config(config.camera)
    vol = TSDFVolume(config, device=device)
    mesher = IncrementalMesher(vol)
    stages = {"upload": 0.0, "preprocess": 0.0, "integrate": 0.0, "mesh": 0.0}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        stages[name] += time.perf_counter() - t0
        return out

    for i, (p, frame) in enumerate(zip(poses, packed)):
        fr = timed("upload", lambda: torch.as_tensor(frame).to(device))
        dep, _, qual, _, _, rgb = timed("preprocess", lambda: preprocess.preprocess_bundle(
            fr, None, intr, depth_scale=config.camera.depth_scale))
        timed("integrate", lambda: vol.integrate_frame(dep, rgb, qual, p, keyframe_id=i))
        if (i + 1) % mesh_every == 0 or i == len(poses) - 1:
            timed("mesh", mesher.update_meshes)
    mesh = timed("mesh", mesher.full_mesh)
    return vol, mesh, stages


def phase_slice(n_frames=120):
    from texturefusion_torch.io import ply
    from texturefusion_torch.ops import cuda_kernels
    config = _slice_config(small=False)
    t0 = time.perf_counter()
    scene, poses, packed = _frames(config, n_frames, "cuda")
    log(f"[slice] rendered {n_frames} frames {config.camera.width}x{config.camera.height} "
        f"on the GPU in {time.perf_counter() - t0:.2f} s")

    # the first pass through the path loads torch's CUDA kernels lazily and
    # sets up its libraries (seconds); it is set-up, not per-frame cost
    t0 = time.perf_counter()
    run_slice(config, scene, poses[:10], packed[:10], "cuda")
    torch.cuda.synchronize()
    log(f"[slice] warm-up: 10 frames through a throwaway volume in "
        f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vol, (verts, faces, colors, normals), stages = run_slice(config, scene, poses, packed,
                                                             "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    lanes = cuda_kernels.LANES["tsdf_integrate"] / max(launches["tsdf_integrate"], 1)
    peak = torch.cuda.max_memory_allocated()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fused.ply")
        ply.save_ply(path, verts, faces, colors, normals)
        v2, f2, _, _ = ply.load_ply(path)
        ply_bytes = os.path.getsize(path)
    err = scene.sdf(torch.as_tensor(verts, device="cuda")).abs().cpu().numpy().astype(
        np.float64)
    rms_mm = float(np.sqrt(np.mean(err ** 2)) * 1e3)
    med_mm = float(np.median(err) * 1e3)
    log(f"[slice] {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} frames/s "
        f"(clocks.sm,power.draw after: {nvidia_smi('clocks.sm,power.draw')}) "
        f"(upload {stages['upload']:.3f} s, preprocess {stages['preprocess']:.3f} s, "
        f"integrate {stages['integrate']:.3f} s, mesh {stages['mesh']:.3f} s)")
    log(f"[slice] chunks={vol.n_active()} verts={len(verts)} faces={len(faces)} "
        f"ply_bytes={ply_bytes} map_rms_mm={rms_mm:.3f} map_median_mm={med_mm:.3f} "
        f"launches={json.dumps(launches)} k2_mean_lanes={lanes:.1f} peak_mem_bytes={peak} "
        f"allocator={vol.alloc.kind}")
    if min(launches["bilateral"], launches["tsdf_integrate"]) <= 0:   # the slice's kernels
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if not (len(verts) > 0 and len(v2) == len(verts) and len(f2) == len(faces)):
        raise AssertionError("empty mesh or PLY round trip failed")
    if not (np.isfinite(verts).all() and med_mm < MAP_MEDIAN_MM and rms_mm <= MAP_RMS_MM):
        raise AssertionError(f"map gates failed: median {med_mm} mm, rms {rms_mm} mm")
    width = round(lanes)
    warm, cold = k2_width_times(width)
    full = _k2_full_bound_ms(width, config.camera.height, config.camera.width)
    log(f"[slice] K2 alone at the path's mean width, {width} lanes: kernel_ms={warm:.4f} "
        f"kernel_cold_ms={cold:.4f} full_row_bound_ms={full:.4f} share={full / warm:.3f}")
    path = {"path_lanes": lanes, "path_kernel_ms": warm, "path_kernel_cold_ms": cold,
            "path_full_row_bound_ms": full}
    return launches, path, (config, scene, poses, packed), vol


def _device_time(prof, wall: float, n_top: int, n_frames: int) -> str:
    """Device ops (kernels, memcpys, memsets) of a profile over n_frames:
    count (and per frame), busy time, busy share of `wall`, and the n_top
    names by device time."""
    device_ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device_ops) * 1e-6
    by_name = {}
    for e in device_ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return (f"device_ops={len(device_ops)} per_frame={len(device_ops) / n_frames:.1f} "
            f"device_busy={busy:.4f} s "
            f"busy_share={busy / wall:.3f} "
            f"top_ms={json.dumps([[k[:70], round(v, 3)] for k, v in top])}")


def phase_profile(frames, first=60, n=20):
    """torch.profiler over n frames of the slice (a fresh volume): device
    time against wall time, and the device ops that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    config, scene, poses, packed = frames
    sel = slice(first, first + n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(config, scene, poses[sel], packed[sel], "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"[profile] {n} frames wall={wall:.4f} s " + _device_time(prof, wall, 8, n))


def phase_small():
    """The slice on a small input, GPU kernels against the CPU's plain
    versions. exp differs by an ulp between the two libraries, so a voxel
    may rarely round to another pixel: at most 0.1% of the observed voxels
    of the common chunks may differ by more than 1e-4 in sdf, and chunk
    sets and vertex counts may differ by 1%."""
    config = _slice_config(small=True)
    scene, poses, packed = _frames(config, 4, "cpu")
    gvol, gmesh, _ = run_slice(config, scene, poses, packed, "cuda", mesh_every=2)
    cvol, cmesh, _ = run_slice(config, scene, poses, packed, "cpu", mesh_every=2)
    g_of = {tuple(r): s for s, r in zip(gvol.active_slots(), gvol.ids[gvol.used].tolist())}
    c_of = {tuple(r): s for s, r in zip(cvol.active_slots(), cvol.ids[cvol.used].tolist())}
    common = sorted(set(g_of) & set(c_of))
    n_diff = len(set(g_of) ^ set(c_of))
    gs = gvol.batch.sdf[[g_of[c] for c in common]].cpu()
    cs = cvol.batch.sdf[[c_of[c] for c in common]]
    seen = (gvol.batch.weight[[g_of[c] for c in common]].cpu() > 0) | (
        cvol.batch.weight[[c_of[c] for c in common]] > 0)
    diff = (gs - cs).abs()[seen]
    frac = float((diff > 1e-4).float().mean())
    nv_g, nv_c = len(gmesh[0]), len(cmesh[0])
    log(f"[small] 160x120 x4 frames: chunks gpu={len(g_of)} cpu={len(c_of)} "
        f"differing={n_diff} observed_voxels={int(seen.sum())} sdf_max_err={float(diff.max()):.3e} "
        f"sdf_frac_over_1e-4={frac:.2e} verts gpu={nv_g} cpu={nv_c}")
    if not (n_diff <= len(c_of) // 100 and frac <= 1e-3 and nv_c > 0
            and abs(nv_g - nv_c) <= nv_c // 100):
        raise AssertionError("GPU slice disagrees with the CPU slice on a small input")


def _tracked_config(small: bool, pipelined: bool = False):
    """bench.py's camera, blur gate and BA setting (bench.py:171; BA from
    schur_min_keyframes on is the JAX package's Schur BA, on one device
    the dense solve), or the tiny config with `small`. The tracker is the
    synchronous one (no deferred promotion, each frame decided in the
    call that takes it) and each fusion cycle reads its own results
    (async_cycle_results=False), unless `pipelined`: then it is the
    default ParallelConfig, as bench.py runs it: the tracker pipelined at
    depth 2 with deferred promotion and the stale-frame refinement, the
    cycle results consumed a cycle late."""
    import dataclasses

    from texturefusion_torch.config import (BAConfig, CameraConfig, ParallelConfig,
                                            PipelineConfig, TrackingConfig, tiny_test_config)
    if small:
        config = tiny_test_config()
    else:
        config = PipelineConfig(camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005),
                                tracking=TrackingConfig(blur_threshold=3.0),
                                ba=BAConfig(schur_min_keyframes=BA_MIN_KEYFRAMES))
    if pipelined:
        return config
    return config.replace(tracking=dataclasses.replace(config.tracking, defer_promote=False),
                          parallel=ParallelConfig(pipelined_tracking=False,
                                                  async_cycle_results=False))


def _frame_draws(draw_fn, tcfg):
    """ReconstructionPipeline's per-frame draws from draw_fn (vs keyframe,
    vs previous frame), or None for the seeded generators."""
    if draw_fn is None:
        return None
    from texturefusion_torch.slam.matching import lite_config
    return lambda i: tuple(draw_fn(c, None) for c in (tcfg, lite_config(tcfg)))


def _pipeline(config, device, draw_fn=None, fuse=True, textured=False, mesh=None,
              audit=False):
    """A ReconstructionPipeline (TexturedPipeline with `textured`) whose
    RANSAC draws all come from draw_fn (when given); with fuse=False its
    fusion cycles do nothing, which leaves the pipeline's tracking half.
    With `audit`, each integration over a prefetched chunk set keeps its
    prefetch, depth and pose in pipe.prefetch_audit, for _audit_prefetch
    to hold against a discovery after the run (deferral_counts)."""
    from texturefusion_torch.fusion.pipeline import ReconstructionPipeline, TexturedPipeline

    class TrackingOnly(ReconstructionPipeline):
        def fusion_cycle(self, finished_slot):
            pass

    cls = TexturedPipeline if textured else ReconstructionPipeline if fuse else TrackingOnly

    class Audited(cls):
        def _integrate_keyframe(self, st, sign, prefetched=None):
            super()._integrate_keyframe(st, sign, prefetched=prefetched)
            if prefetched is not None and sign > 0:
                self.prefetch_audit.append((st.kf_slot, prefetched, st.depth,
                                            st.integrated_pose))

    pipe = (Audited if audit else cls)(config, device=device, draw_fn=draw_fn,
                                       frame_draws=_frame_draws(draw_fn, config.tracking),
                                       mesh=mesh)
    pipe.prefetch_audit = []
    return pipe


def _band_weight(vol, ids, depth, pose) -> float:
    """Σ|weight| that one depth frame at `pose` puts into the chunks `ids`
    from empty rows: K2's plain version on the CPU, so no launch counts."""
    from texturefusion_torch.ops import tsdf
    if not len(ids):
        return 0.0
    n = len(ids)
    batch = tsdf.make_empty_batch(n + 1, vol.n_voxels, "cpu")
    origins = torch.zeros((n + 1, 3))
    origins[:n] = torch.as_tensor(np.asarray(ids, np.float32) * vol.extent)
    tsdf.integrate_frame_fused_plain(batch, origins, torch.arange(n), None, depth.cpu(), None,
                                     None, torch.as_tensor(pose, dtype=torch.float32), 1.0,
                                     vol.intr, vol.cfg, with_color=False)
    return float(batch.weight[:n].abs().sum())


def _audit_prefetch(pipe, kf, prefetched, depth, pose) -> dict:
    """A keyframe that integrated over its prefetched chunks (found at its
    promotion, from the depth then and the peeked pose), with the
    (refined) depth and the pose it integrated at: the chunks a discovery
    from these would add and drop, and the band weight its depth puts
    into the chunks the prefetch lacks, beside that into the prefetched
    ones. Run after the loop, so its reads are not in the loop's time."""
    vol = pipe.volume
    ids, n = prefetched[0].result()
    pre = {tuple(r) for r in ids[:int(n)].tolist()}
    depth = depth.to(pipe.device)
    ids, n = vol.dispatch_discovery(depth, pose)[0].result()
    now = {tuple(r) for r in ids[:int(n)].tolist()}
    lacked = sorted(now - pre)
    return {"kf": kf, "prefetched": len(pre), "lacked": len(lacked),
            "dropped": len(pre - now), "w_lacked": _band_weight(vol, lacked, depth, pose),
            "w_prefetched": _band_weight(vol, sorted(pre), depth, pose)}


def deferral_counts(pipe) -> dict:
    """The fusion side's deferrals over a run (STOPWATCH counts since its
    reset) and the sums of the prefetch audit, made here."""
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    c = STOPWATCH.counts.copy()
    audit = [_audit_prefetch(pipe, *rec) for rec in pipe.prefetch_audit]
    return {
        "prefetch_used": c["disco_pref_used"], "prefetch_deferred": c["disco_pref_defer"],
        "prefetch_missed": c["disco_pref_miss"],
        "integrations_deferred": c["integration_deferred"],
        "count_batches_late": c["counts_late"], "count_consumes_not_ready": c["counts_not_ready"],
        "obs_batches_late": c["obs_late"], "obs_flushes_not_ready": c["obs_not_ready"],
        "texture_dispatches_skipped": c["tex_skipped"],
        "texture_consumes_not_ready": c["tex_not_ready"], "gc_probes_deferred": c["gc_deferred"],
        "audited_integrations": len(audit),
        "prefetch_lacked_chunks": [a["lacked"] for a in audit],
        "prefetch_dropped_chunks": sum(a["dropped"] for a in audit),
        "prefetched_chunks": sum(a["prefetched"] for a in audit),
        "lacked_band_weight_share": (sum(a["w_lacked"] for a in audit)
                                     / max(sum(a["w_prefetched"] + a["w_lacked"]
                                               for a in audit), 1e-9))}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_tracked(config, packed, device, draw_fn=None):
    """The tracked main path: ReconstructionPipeline.process_frame with its
    fusion cycles turned off (the first frame through preprocess_bundle,
    every later one through frame_step_tracked2 and GCSLAM.update_frame,
    the current keyframe's refined depth carried along), then final_ba.
    `draw_fn(cfg, n)`, when given, makes every RANSAC draw, GCSLAM's and
    the per-frame step's (see GCSLAM). Returns (slam, stage seconds from
    the STOPWATCH): "step" is the frame step up to its one host read,
    "decisions" update_frame on frames that stayed local frames,
    "promote_ba" update_frame on promotions, plus final_ba."""
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    pipe = _pipeline(config, device, draw_fn, fuse=False)
    STOPWATCH.reset()
    for i, frame in enumerate(packed):
        pipe.process_frame(frame, timestamp=float(i))
    pipe.flush_tracking()
    with STOPWATCH.time("final_ba"):
        pipe.slam.final_ba()
        _sync(device)
    t = STOPWATCH.totals
    return pipe.slam, {"upload": t["upload"], "step": t["preprocess"], "decisions": t["tracking"],
                       "promote_ba": t["promotion"] + t["final_ba"]}


def _tracking_metrics(slam, poses):
    from texturefusion_torch.eval import loop_closure
    from texturefusion_torch.io import tum
    gt = np.stack(poses)
    traj = slam.trajectory()
    det = loop_closure.detected_pairs_from_slam(slam)
    truth = loop_closure.ground_truth_pairs(gt[[k.frame_index for k in slam.keyframes]])
    return {"ate_mm": tum.ate_rmse(traj, gt) * 1e3, "keyframes": len(slam.keyframes),
            "edges": slam.n_edges, "loop_edges": len(det), "origins": slam.origin_count,
            "ba_keyframes": slam.ba_keyframes,
            "tracked": sum(f.tracking_success for f in slam.frames),
            "blurred": [f.index for f in slam.frames if f.blurred],
            "lc": loop_closure.precision_recall(det, truth)}, traj


def phase_tracked(n_frames=120):
    """The tracked path on the bench's hardened loop at VGA."""
    from texturefusion_torch.ops import cuda_kernels
    config = _tracked_config(small=False)
    t0 = time.perf_counter()
    _, poses, packed = _frames(config, n_frames, "cuda", harden=True)
    log(f"[tracked] rendered {n_frames} frames {config.camera.width}x{config.camera.height} "
        f"(exposure step, blur burst) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_tracked(config, packed[:10], "cuda")
    torch.cuda.synchronize()
    log(f"[tracked] warm-up: 10 frames through a throwaway GCSLAM in "
        f"{time.perf_counter() - t0:.3f} s")

    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    slam, stages = run_tracked(config, packed, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    m, traj = _tracking_metrics(slam, poses)
    log(f"[tracked] {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} frames/s "
        f"(clocks.sm,power.draw after: {nvidia_smi('clocks.sm,power.draw')}) "
        + " ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    log(f"[tracked] ate_mm={m['ate_mm']:.3f} keyframes={m['keyframes']} edges={m['edges']} "
        f"ba_keyframes={m['ba_keyframes']} (schur_min_keyframes={config.ba.schur_min_keyframes}) "
        f"loop_edges={m['loop_edges']} origins={m['origins']} tracked={m['tracked']} "
        f"blurred={m['blurred']} loop_closure={json.dumps(m['lc'])} "
        f"launches={json.dumps(launches)}")
    if not np.isfinite(traj).all() or traj.shape != (n_frames, 4, 4):
        raise AssertionError("the tracked trajectory is not finite or has the wrong shape")
    if not m["ate_mm"] <= ATE_MM:
        raise AssertionError(f"ATE {m['ate_mm']:.3f} mm above {ATE_MM} mm")
    if m["loop_edges"] < 1:
        raise AssertionError("no loop-closure edge")
    if m["ba_keyframes"] < BA_MIN_KEYFRAMES:
        raise AssertionError(f"BA ran over at most {m['ba_keyframes']} keyframes, not past "
                             f"{BA_MIN_KEYFRAMES}")
    if launches["bilateral"] != n_frames:
        raise AssertionError(f"K1 launched {launches['bilateral']} times for {n_frames} frames")
    return launches, (config, poses, packed)


def cpu_draw_fn(tcfg):
    """A draw_fn for run_tracked: every RANSAC draw from one CPU generator
    seeded as GCSLAM's, so that runs on two devices get the same draws."""
    from texturefusion_torch.slam.matching import ransac_draws
    gen = torch.Generator().manual_seed(42)
    return lambda cfg, n: ransac_draws(cfg, tcfg.max_features_pad, gen,
                                       () if n is None else (n,))


def _orbit_frames(config, n_frames):
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops.preprocess import pack_frame
    intr = cam.Intrinsics.from_config(config.camera)
    poses = synthetic.orbit_trajectory(n_frames)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr, poses, device="cpu")
    return poses, [pack_frame((d * config.camera.depth_scale).astype(np.uint16),
                              (c * 255).astype(np.uint8)) for d, c in zip(depths, rgbs)]


def _feature_compare(config, packed) -> dict:
    """One frame's grey image and features on the GPU and on the CPU from
    the same packed bytes. The grey image, and the keypoints' levels,
    validity and descriptors, must agree bit for bit (core/exact.py);
    returns the largest keypoint position (px) and 3-D point (m)
    differences, which follow the depth (K1's exp against the CPU's)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.ops import preprocess
    from texturefusion_torch.slam.features import extract_features
    intr = cam.Intrinsics.from_config(config.camera)
    out = {}
    for dev in ("cuda", "cpu"):
        b = preprocess.preprocess_bundle(torch.as_tensor(packed).to(dev), None, intr,
                                         depth_scale=config.camera.depth_scale)
        kp = extract_features(b[3], b[0], config.tracking, intr)
        out[dev] = (b[3].cpu(), kp._replace(**{f: getattr(kp, f).cpu() for f in kp._fields}))
    (gg, kg), (gc, kc) = out["cuda"], out["cpu"]
    if not (torch.equal(gg, gc) and all(torch.equal(getattr(kg, f), getattr(kc, f))
                                        for f in ("level", "valid", "desc"))):
        raise AssertionError("GPU and CPU features differ on the same frame")
    return {"uv_px": float((kg.uv - kc.uv).abs().max()),
            "points_m": float((kg.points3d - kc.points3d).abs().max()),
            "has_depth_differ": int((kg.has_depth != kc.has_depth).sum())}


def phase_tracked_small(frames, n_frames=30):
    """The tracked path on the tiny config, GPU against CPU, fed the same
    RANSAC draws (drawn on the CPU from one generator, then moved). 30
    orbit frames promote 6 keyframes, so promotion, the loop-closure
    probe, BA and the final BA run on both devices. First every tiny
    frame's features, and those of three of [tracked]'s VGA frames
    (`frames`: the first, one of the blur burst, one of the exposure
    step), GPU against CPU (_feature_compare)."""
    config = _tracked_config(small=True)
    poses, packed = _orbit_frames(config, n_frames)
    vga_config, _, vga_packed = frames
    feats = [_feature_compare(config, p) for p in packed]
    feats_vga = [_feature_compare(vga_config, vga_packed[i]) for i in (0, 47, 70)]
    log(f"[tracked-small] features GPU vs CPU: grey images, levels, validity and descriptors "
        f"bit for bit on {len(feats)} tiny and {len(feats_vga)} VGA frames; largest "
        f"differences tiny {json.dumps({k: max(f[k] for f in feats) for k in feats[0]})} "
        f"VGA {json.dumps({k: max(f[k] for f in feats_vga) for k in feats_vga[0]})}")
    runs = {dev: _tracking_metrics(run_tracked(config, packed, dev,
                                               cpu_draw_fn(config.tracking))[0], poses)
            for dev in ("cuda", "cpu")}
    (g, gt), (c, ct) = runs["cuda"], runs["cpu"]
    diff_mm = np.abs(gt[:, :3, 3] - ct[:, :3, 3]).max(-1) * 1e3
    log(f"[tracked-small] 160x120 x{n_frames} orbit frames: keyframes gpu={g['keyframes']} "
        f"cpu={c['keyframes']} edges gpu={g['edges']} cpu={c['edges']} loop_edges "
        f"gpu={g['loop_edges']} cpu={c['loop_edges']} origins gpu={g['origins']} "
        f"cpu={c['origins']} ate_mm gpu={g['ate_mm']:.4f} cpu={c['ate_mm']:.4f} "
        f"position_diff_mm max={diff_mm.max():.4f} median={np.median(diff_mm):.4f}")
    if not (min(g["keyframes"], c["keyframes"]) >= SMALL_MIN_KF
            and min(g["loop_edges"], c["loop_edges"]) >= 1
            and abs(g["keyframes"] - c["keyframes"]) <= SMALL_KF_DIFF
            and g["origins"] == c["origins"] and diff_mm.max() <= SMALL_TRAJ_MM):
        raise AssertionError("GPU tracked path disagrees with the CPU's on a small input")


def phase_profile_tracked(frames, first=60, n=10):
    """torch.profiler over n tracked frames (a fresh GCSLAM): device busy
    share and the device ops that take most of the time. No gate."""
    from torch.profiler import ProfilerActivity, profile
    config, _, packed = frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_tracked(config, packed[first:first + n], "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"[profile-tracked] {n} frames wall={wall:.4f} s " + _device_time(prof, wall, 12, n))


def _pipeline_config(small=False, async_fusion=False, pipelined=False, **tsdf):
    """[tracked]'s camera, blur gate and BAConfig (bench.py's
    schur_min_keyframes = 16), [slice]'s TSDF sizes and the fusion thread
    on or off; `small`: the tiny config. The tracker as _tracked_config's:
    synchronous unless `pipelined`, then bench.py's ParallelConfig
    (pipeline_depth 2)."""
    import dataclasses
    base = _tracked_config(small, pipelined)
    if not small:
        base = base.replace(tsdf=_slice_config(small=False).tsdf)
    return base.replace(tsdf=dataclasses.replace(base.tsdf, **tsdf),
                        parallel=dataclasses.replace(base.parallel, async_fusion=async_fusion))


def run_pipeline(config, packed, device, draw_fn=None, on_frame=None, textured=False,
                 mesh=None, audit=False):
    """The pipeline's main path: ReconstructionPipeline (TexturedPipeline
    with `textured`; its rows, mesh pool and BA sharded over `mesh` when
    given) .process_frame on each packed frame (with its host copy), the
    fusion thread joined, then finish(). Returns (pipe, loop seconds,
    finish seconds); both clocks end in a synchronize."""
    pipe = _pipeline(config, device, draw_fn, textured=textured, mesh=mesh, audit=audit)
    t0 = time.perf_counter()
    for i, frame in enumerate(packed):
        pipe.process_frame(frame, timestamp=float(i), host_packed=frame)
        if on_frame is not None:
            on_frame(pipe)
    pipe.flush_tracking()
    pipe._drain_fusion()
    _sync(device)
    loop = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.finish()
    _sync(device)
    return pipe, loop, time.perf_counter() - t0


def _map_error_mm(pipe, scene, gt):
    """bench.py's map error: the mesh's vertices, moved into the
    ground-truth frame by the trajectory's Umeyama alignment, against the
    analytic scene (RMS and median |sdf|, mm)."""
    from texturefusion_torch.io import tum
    verts = pipe.mesher.full_mesh()[0]
    rot, t = tum.align_umeyama(pipe.trajectory(), gt)
    err = scene.sdf(torch.as_tensor((verts @ rot.T + t).astype(np.float32),
                                    device=pipe.device)).abs().cpu().numpy().astype(np.float64)
    return float(np.sqrt(np.mean(err ** 2)) * 1e3), float(np.median(err) * 1e3), len(verts)


def frame_shapes_summary(shapes) -> dict:
    """The F-frame mode's launches ({(F, lanes, mixed signs): count}, as
    cuda_kernels.FRAME_SHAPES counts them): the launches, their frames and
    lanes, the mean width of local-frame passes (one sign) and of drift
    reintegrations (-1 and +1), and the (F, lanes) histogram."""
    def mean_lanes(mixed):
        n = sum(c for (_, _, m), c in shapes.items() if m == mixed)
        return sum(w * c for (_, w, m), c in shapes.items() if m == mixed) / max(n, 1), n

    local, n_local = mean_lanes(False)
    reint, n_reint = mean_lanes(True)
    hist = {}
    for (f, w, _), c in sorted(shapes.items()):
        hist[f"{f}x{w}"] = hist.get(f"{f}x{w}", 0) + c
    frames = {}
    for (f, _, _), c in shapes.items():
        frames[f] = frames.get(f, 0) + c
    return {"launches": sum(shapes.values()), "frames": dict(sorted(frames.items())),
            "local_passes": n_local, "local_mean_lanes": round(local, 1),
            "reintegrations": n_reint, "reintegration_mean_lanes": round(reint, 1),
            "lanes_min_max": [min((w for _, w, _ in shapes), default=0),
                              max((w for _, w, _ in shapes), default=0)],
            "FxLanes": hist}


def _pipeline_report(name, pipe, loop, fin, scene, poses, launches, n_frames, shapes):
    """Print one pipeline run's numbers, check its exports, apply the map
    and tracking gates. Returns its metrics."""
    from texturefusion_torch.io import ply
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    m, traj = _tracking_metrics(pipe.slam, poses)
    rms, med, n_raw = _map_error_mm(pipe, scene, np.stack(poses))
    with tempfile.TemporaryDirectory() as tmp:
        n_weld = pipe.export_mesh(os.path.join(tmp, "mesh.ply"))
        v2 = ply.load_ply(os.path.join(tmp, "mesh.ply"))[0]
        pipe.save_trajectory(os.path.join(tmp, "trajectory.txt"))
        lines = open(os.path.join(tmp, "trajectory.txt")).read().strip().splitlines()
    st = pipe.stats
    m.update(traj=traj, map_rms_mm=rms, map_median_mm=med, verts=n_raw, verts_welded=n_weld,
             kf_flags=[f.is_keyframe for f in pipe.slam.frames],
             reintegrations=st["reintegrations"], fps=n_frames / loop, finish_s=fin,
             active=pipe.volume.n_active(), frozen=len(pipe.mesher.frozen))
    stages = {k: round(v, 4) for k, v in sorted(STOPWATCH.totals.items())}
    log(f"[{name}] {n_frames} frames in {loop:.3f} s = {n_frames / loop:.3f} frames/s, "
        f"finish {fin:.3f} s (clocks.sm,power.draw after: "
        f"{nvidia_smi('clocks.sm,power.draw')}); stage seconds {json.dumps(stages)} "
        f"counts {json.dumps(dict(STOPWATCH.counts))}")
    log(f"[{name}] ate_mm={m['ate_mm']:.3f} keyframes={m['keyframes']} edges={m['edges']} "
        f"ba_keyframes={m['ba_keyframes']} loop_edges={m['loop_edges']} origins={m['origins']} "
        f"tracked={m['tracked']} "
        f"reintegrations={st['reintegrations']} (reuse {st['reintegrations_reuse']}, full "
        f"{st['reintegrations_full']}) map_rms_mm={rms:.3f} map_median_mm={med:.3f} "
        f"active_chunks={m['active']} frozen_chunks={m['frozen']} verts={n_raw} "
        f"verts_welded={n_weld} ply_verts={len(v2)} trajectory_lines={len(lines)} "
        f"launches={json.dumps(launches)} peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    if not (np.isfinite(traj).all() and len(lines) == n_frames
            and all(len(ln.split()) == 8 for ln in lines) and len(v2) == n_weld > 0):
        raise AssertionError(f"[{name}] trajectory or PLY export failed")
    if not (m["ate_mm"] <= ATE_MM and rms <= MAP_RMS_MM and med < MAP_MEDIAN_MM):
        raise AssertionError(f"[{name}] gates failed: ATE {m['ate_mm']:.3f} mm, map RMS "
                             f"{rms:.3f} mm, median {med:.3f} mm")
    m["frame_shapes"] = shapes
    log(f"[{name}] F-frame mode shapes: {json.dumps(frame_shapes_summary(shapes))}")
    if m["loop_edges"] < 1 or st["reintegrations"] < 1:
        raise AssertionError(f"[{name}] no loop-closure edge or no reintegration")
    if m["ba_keyframes"] < BA_MIN_KEYFRAMES:
        raise AssertionError(f"[{name}] BA ran over at most {m['ba_keyframes']} keyframes")
    if not (launches["bilateral"] == n_frames and launches["tsdf_integrate"] > 0
            and launches["tsdf_integrate_frames"] > 0):
        raise AssertionError(f"[{name}] a kernel of the path did not run as it should: "
                             f"{launches}")
    return m


def phase_pipeline(frames, async_fusion=False, max_resident=0, reference=None,
                   textured=False):
    """ReconstructionPipeline on [tracked]'s hardened loop (120 VGA
    frames), after a 10-frame warm-up through a throwaway pipeline. With
    max_resident > 0 the map streams: far chunks (3 m) and those over the
    budget go to the host. With `textured`, TexturedPipeline and its
    export (the warm-up also textures, to load the texture stage's
    kernels and cuSOLVER)."""
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    _, poses, packed = frames
    name = ("pipeline-stream" if max_resident else "pipeline-async" if async_fusion
            else "pipeline-textured" if textured else "pipeline")
    kw = dict(max_resident_chunks=max_resident, streaming_radius=3.0) if max_resident else {}
    config = _pipeline_config(async_fusion=async_fusion, **kw)
    if reference is None or textured:
        t0 = time.perf_counter()
        run_pipeline(config, packed[:10], "cuda", textured=textured)[0].close()
        log(f"[{name}] warm-up: 10 frames and finish through a throwaway pipeline in "
            f"{time.perf_counter() - t0:.3f} s")
    peak = [0]

    def on_frame(pipe):
        peak[0] = max(peak[0], pipe.volume.n_active())

    STOPWATCH.reset()
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe, loop, fin = run_pipeline(config, packed, "cuda", on_frame=on_frame,
                                   textured=textured)
    launches = dict(cuda_kernels.LAUNCHES)
    shapes = dict(cuda_kernels.FRAME_SHAPES)
    scene = _bench_scene()
    m = _pipeline_report(name, pipe, loop, fin, scene, poses, launches, len(packed), shapes)
    if textured:
        _textured_report(name, pipe, scene, poses, m, reference)
    pipe.close()
    m["launches"] = launches
    if reference is not None:
        log(f"[{name}] beside [pipeline]: frames/s {m['fps']:.3f} vs {reference['fps']:.3f}, "
            f"verts {m['verts']} vs {reference['verts']}, map_rms_mm {m['map_rms_mm']:.3f} vs "
            f"{reference['map_rms_mm']:.3f}, ate_mm {m['ate_mm']:.3f} vs "
            f"{reference['ate_mm']:.3f}")
    if max_resident:
        s = pipe.streamer
        budget = max_resident + config.tsdf.max_update_chunks
        log(f"[{name}] max_resident_chunks={max_resident} offloads={s.offloaded} "
            f"restores={s.restored} cold={s.n_cold()} peak_resident={peak[0]} (at most "
            f"{budget}) frozen_meshes={len(pipe.mesher.frozen)}")
        if not (peak[0] <= budget and s.offloaded > 0):
            raise AssertionError(f"[{name}] residency {peak[0]} over {budget} or no offload")
        if abs(m["verts"] - reference["verts"]) > 0.05 * reference["verts"]:
            raise AssertionError(f"[{name}] {m['verts']} vertices, [pipeline] "
                                 f"{reference['verts']}: more than 5% apart")
    return m


def phase_pipeline_bench(frames, reference, textured_reference):
    """TexturedPipeline with bench.py's config exactly (bench.py:162-184:
    ParallelConfig(async_fusion=True, pipeline_depth=2), the default
    TrackingConfig but blur_threshold = 3.0, so deferred promotion and the
    stale-frame refinement are on, and the default async_cycle_results:
    the cycle results consumed a cycle late) on [tracked]'s 120 hardened
    frames, then flush_tracking() and finish(), and the textured export;
    no cut. Each integration over a prefetched chunk set is audited
    after the run (_audit_prefetch: its discovery and the plain K2 on the
    CPU run after the clocks stop). Gates:
    [pipeline]'s (ATE, map RMS and median, a loop edge, a reintegration,
    BA over 16 keyframes, the kernels launched), at least one
    stale-finalized frame and one adopted refinement, and
    [pipeline-textured]'s texture gates. Prints frames/s beside
    [pipeline]'s and [pipeline-textured]'s, t_stats_sync, the calls in
    which a frame rode past the depth, the most frames in flight, the
    promotions consumed late, and the deferral counts (deferral_counts)."""
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    name = "pipeline-bench"
    _, poses, packed = frames
    config = _pipeline_config(async_fusion=True, pipelined=True)
    STOPWATCH.reset()
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe, loop, fin = run_pipeline(config, packed, "cuda", textured=True, audit=True)
    launches = dict(cuda_kernels.LAUNCHES)
    shapes = dict(cuda_kernels.FRAME_SHAPES)
    scene = _bench_scene()
    m = _pipeline_report(name, pipe, loop, fin, scene, poses, launches, len(packed), shapes)
    _textured_report(name, pipe, scene, poses, m, textured_reference,
                     ref_name="pipeline-textured", geometry=False)
    pipe.close()
    slam, par = pipe.slam, config.parallel
    m["deferrals"] = deferral_counts(pipe)
    log(f"[{name}] async_cycle_results={par.async_cycle_results} deferrals "
        f"{json.dumps(m['deferrals'])}")
    m.update(launches=launches, stale=len(slam.stale_frames),
             refine_adopted=slam.refine_adopted, rode=pipe.rode,
             max_inflight=pipe.max_inflight, promote_late=slam.promote_late,
             t_stats_sync=STOPWATCH.totals["t_stats_sync"])
    log(f"[{name}] pipelined_tracking={par.pipelined_tracking} pipeline_depth="
        f"{par.pipeline_depth} pipeline_max_ride={par.pipeline_max_ride} async_fusion="
        f"{par.async_fusion} defer_promote={config.tracking.defer_promote} refine_stale="
        f"{config.tracking.refine_stale}: frames/s {m['fps']:.3f} vs [pipeline] "
        f"{reference['fps']:.3f} vs [pipeline-textured] {textured_reference['fps']:.3f}; "
        f"t_stats_sync {m['t_stats_sync']:.4f} s ([pipeline] reads its stats inside "
        f"the frame step); stale_frames={m['stale']} refine_dispatched="
        f"{slam.refine_dispatched} refine_adopted={m['refine_adopted']} rode={m['rode']} "
        f"max_inflight={m['max_inflight']} promotions_late={m['promote_late']}; ate_mm "
        f"{m['ate_mm']:.3f} vs {reference['ate_mm']:.3f} / {textured_reference['ate_mm']:.3f}, "
        f"map_rms_mm {m['map_rms_mm']:.3f} vs {reference['map_rms_mm']:.3f}, keyframes "
        f"{m['keyframes']} vs {reference['keyframes']}, launches={json.dumps(launches)}")
    if m["stale"] < 1 or m["refine_adopted"] < 1:
        raise AssertionError(f"[{name}] no stale-finalized frame or no adopted refinement")
    return m


def phase_pipeline_deferred(frames, reference, textured_reference):
    """[pipeline-textured]'s config (the synchronous tracker, no fusion
    thread) with async_cycle_results=True: this slice's deferrals alone,
    the tracker's apart. The same 120 frames, finish() and the textured
    export; [pipeline-textured]'s gates: [pipeline]'s, the ATE and
    vertices beside [pipeline]'s, and the texture's. Prints the map RMS,
    vertices, patched share, colour error and frames/s beside
    [pipeline-textured]'s, and the deferral counts."""
    import dataclasses

    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    name = "pipeline-deferred"
    _, poses, packed = frames
    base = _pipeline_config()
    config = base.replace(parallel=dataclasses.replace(base.parallel, async_cycle_results=True))
    STOPWATCH.reset()
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe, loop, fin = run_pipeline(config, packed, "cuda", textured=True)
    launches = dict(cuda_kernels.LAUNCHES)
    shapes = dict(cuda_kernels.FRAME_SHAPES)
    scene = _bench_scene()
    m = _pipeline_report(name, pipe, loop, fin, scene, poses, launches, len(packed), shapes)
    _textured_report(name, pipe, scene, poses, m, reference)
    pipe.close()
    m.update(launches=launches, deferrals=deferral_counts(pipe))
    t = textured_reference
    labels = [m["labels_by_id"].get(k) == v for k, v in t["labels_by_id"].items()]
    log(f"[{name}] beside [pipeline-textured]: frames/s {m['fps']:.3f} vs {t['fps']:.3f}, "
        f"map_rms_mm {m['map_rms_mm']:.3f} vs {t['map_rms_mm']:.3f}, verts {m['verts']} vs "
        f"{t['verts']}, ate_mm {m['ate_mm']:.4f} vs {t['ate_mm']:.4f}, reintegrations "
        f"{m['reintegrations']} vs {t['reintegrations']}, patched_not_wrong "
        f"{m['patched_share']:.4f} vs {t['patched_share']:.4f}, exported colour error median "
        f"{m['colour_errors']['exported']['median']:.3f} vs "
        f"{t['colour_errors']['exported']['median']:.3f} mean "
        f"{m['colour_errors']['exported']['mean']:.3f} vs "
        f"{t['colour_errors']['exported']['mean']:.3f}, same label by chunk id "
        f"{np.mean(labels):.4f}, texture {m['texture_s']:.3f} s vs {t['texture_s']:.3f} s; "
        f"deferrals {json.dumps(m['deferrals'])}")
    return m


def _textured_vertices(pipe, obj_path):
    """The exported vertices, chunk by chunk in export order: positions,
    voxel colours, raw atlas samples (before the bake: the corrected
    sample less ChunkTexture.color_adjust), exported colours (the OBJ's v
    records) and each vertex's keyframe label."""
    tm, meshes = pipe.texture, pipe.mesher.meshes
    cols = np.asarray([ln.split()[4:7] for ln in open(obj_path) if ln.startswith("v ")],
                      np.float64)
    pos, vox, raw, labels = [], [], [], []
    for s in sorted(tm.chunk_tex):
        tex = tm.chunk_tex[s]
        if tex.atlas_uv is None or s not in meshes:
            continue
        v, _, c, _ = meshes[s]
        k = min(len(v), len(tex.atlas_uv))
        pos.append(v[:k])
        vox.append(c[:k])
        raw.append(tm._sample_atlas(tex.atlas_uv[:k]) - tex.color_adjust)
        labels.append(np.full(k, tex.label))
    return (np.concatenate(pos), np.concatenate(vox), np.concatenate(raw), cols,
            np.concatenate(labels))


def _texture_audit(pipe) -> dict:
    """Why meshed chunks end up wrong. Counts the meshed chunks with an
    observation, with a positive one left (integration gives a chunk that
    some of its voxels leave the image -1e11, as the reference does, and
    poisoning sets -1e11 too), the wrong ones, and those some integrated
    keyframe saw whole (every voxel inside the image at the pose it was
    integrated at). Then runs the texture cycle's wrong-mapping tests
    (texture/patch.py) on every (chunk, keyframe) pair of a whole view,
    with the keyframe's stored images and current pose: how many chunks
    have a whole view that passes, and of the pairs that fail, how many
    fail mostly by occlusion, depth or colour, and the share of their
    occluded vertices whose depth taps touch a hole (depth 0)."""
    from texturefusion_torch.core import camera as cam
    from texturefusion_torch.core import se3
    from texturefusion_torch.ops import marching_cubes as mc
    from texturefusion_torch.ops import tsdf
    from texturefusion_torch.parallel.sharded_tsdf import ORIGIN_FIELD
    from texturefusion_torch.texture.patch import _bilinear_packed, _unpack, wrong_mapping_tests
    tm, vol, intr, cfg, dev = pipe.texture, pipe.volume, pipe.intr, pipe.texture.cfg, pipe.device
    meshed = np.asarray(sorted(pipe.mesher.meshes), np.int64)
    q, mask = vol.obs_arrays()
    out = {"meshed": len(meshed), "with_observation": int(mask[meshed].any(1).sum()),
           "with_positive_observation": int(((q > 0) & mask)[meshed].any(1).sum()),
           "wrong": sum(tm.chunk_tex[s].wrong for s in meshed if s in tm.chunk_tex)}
    # through the containers: a sharded volume and pool as one-device ones
    (origins,) = vol.rows.gather(meshed, fields=(ORIGIN_FIELD,), device=dev)
    verts, colpk, vcount = pipe.mesher.pool_rows.gather(
        meshed, fields=(mc.POOL_VERTS, mc.POOL_COLORS, mc.POOL_VCOUNT), device=dev)
    world = tsdf._voxel_world(origins, vol.cfg)
    vcol = _unpack(colpk) / 255.0
    valid = torch.arange(verts.shape[1], device=dev)[None] < vcount[:, None]
    seen = torch.zeros(len(meshed), dtype=torch.bool, device=dev)
    passes = torch.zeros_like(seen)
    fails = {"occluded": 0, "depth": 0, "colour": 0, "no_vertex_in_view": 0}
    occ_n = occ_hole = 0
    for kf, st in sorted(pipe.kf_states.items()):
        if st.integrated_pose is None or kf not in tm.kf_stack.present:
            continue
        pose = torch.as_tensor(st.integrated_pose, dtype=torch.float32, device=dev)
        whole = tsdf._project_voxels(world, origins, pose, intr, vol.cfg)[1].all(1)
        if not bool(whole.any()):
            continue
        w2c = se3.inverse(torch.as_tensor(tm.kf_stack.poses[kf], device=dev))
        uv, z = cam.project(intr, verts @ w2c[:3, :3].T + w2c[:3, 3])
        ok = valid & cam.in_image(intr, uv, margin=1.0) & (z > intr.near)
        row = torch.full((len(meshed),), kf, device=dev)
        tex, d, d_ok = _bilinear_packed(tm.kf_stack.rgb_packed, tm.kf_stack.depth, row, uv)
        # > 0 where a tap is a hole: the sampler averages the map's non-zero taps
        hole = _bilinear_packed(tm.kf_stack.rgb_packed, (tm.kf_stack.depth == 0).float(),
                                row, uv)[1] > 0
        tests = wrong_mapping_tests(tex, d, d_ok, z, vcol, intr, cfg) & ok    # [3, M, P]
        n_ok = ok.sum(1)
        wrong = (tests.any(0).sum(1) / torch.clamp(n_ok, min=1) > cfg.wrong_mapping_frac) \
            | (n_ok == 0)
        seen |= whole
        passes |= whole & ~wrong
        failing = whole & wrong
        fails["no_vertex_in_view"] += int((failing & (n_ok == 0)).sum())
        top = torch.argmax(tests.sum(2), 0)
        for i, name in enumerate(("occluded", "depth", "colour")):
            fails[name] += int((failing & (n_ok > 0) & (top == i)).sum())
        occ = tests[0] & failing[:, None]
        occ_n += int(occ.sum())
        occ_hole += int((occ & hole).sum())
    out.update(seen_whole=int(seen.sum()), seen_whole_and_passes=int(passes.sum()),
               failing_whole_views_mostly=fails,
               occluded_next_to_a_hole=round(occ_hole / max(occ_n, 1), 4))
    return out


def _textured_report(name, pipe, scene, poses, m, reference, ref_name="pipeline",
                     geometry=True):
    """[pipeline-textured]: the export, the texture stages, the colour
    error, and the gates beside `reference` ([pipeline]'s metrics, or
    `ref_name`'s): with `geometry`, ATE and vertices beside it (texturing
    writes no TSDF row); the texture's gates always. Adds the texture
    stages, the colour errors and each chunk id's label to m."""
    from texturefusion_torch.io import png, tum
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    tm = pipe.texture
    meshed = set(pipe.mesher.meshes)
    patched = {s for s in meshed if s in tm.atlas.patches}
    wrong = {s for s in meshed if s in tm.chunk_tex and tm.chunk_tex[s].wrong}
    good = patched - wrong
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        obj = pipe.export_textured(tmp)
        export_s = time.perf_counter() - t0
        files = {ext: os.path.join(tmp, f"model.{ext}") for ext in ("obj", "mtl", "png")}
        sizes = {ext: os.path.getsize(p) for ext, p in files.items() if os.path.exists(p)}
        lines = open(obj).read().splitlines()
        n_v = sum(ln.startswith("v ") for ln in lines)
        n_vt = sum(ln.startswith("vt ") for ln in lines)
        faces = np.asarray([[int(x.split("/")[0]) for x in ln.split()[1:]]
                            for ln in lines if ln.startswith("f ")], np.int64)
        img = png.read_png(files["png"]) if "png" in sizes else None
        pos, vox, raw, cols, labels = _textured_vertices(pipe, obj)
    # colour error at the aligned vertex positions against the scene's
    # colour (rendered unshaded), over every value of every vertex
    rot, t = tum.align_umeyama(pipe.trajectory(), np.stack(poses))
    truth = scene.color(torch.as_tensor((pos @ rot.T + t).astype(np.float32),
                                        device=pipe.device)).cpu().numpy().astype(np.float64)
    frame_of = np.asarray([k.frame_index for k in pipe.slam.keyframes])
    lab_frame = frame_of[np.clip(labels, 0, len(frame_of) - 1)]
    exposed = (lab_frame >= EXPOSURE_FRAMES[0]) & (lab_frame < EXPOSURE_FRAMES[1])
    errors = {}
    for what, c in (("voxel", vox), ("atlas_raw", raw), ("exported", cols)):
        d = np.abs(c - truth) * 255.0
        errors[what] = {"median": float(np.median(d)), "mean": float(d.mean()),
                        "exposure_median": float(np.median(d[exposed])) if exposed.any() else None,
                        "exposure_mean": float(d[exposed].mean()) if exposed.any() else None}
    stages = {k: [round(v, 4), STOPWATCH.counts[k]] for k, v in sorted(STOPWATCH.totals.items())
              if k.startswith("tex")}
    log(f"[{name}] texture stages (seconds, calls) {json.dumps(stages)}; export_textured "
        f"{export_s:.3f} s, files {json.dumps(sizes)}, v={n_v} vt={n_vt} f={len(faces)} "
        f"png={None if img is None else list(img.shape)} used_rows={tm.atlas.used_rows()}")
    log(f"[{name}] frames/s {m['fps']:.3f} vs [{ref_name}] {reference['fps']:.3f}, finish "
        f"{m['finish_s']:.3f} s vs {reference['finish_s']:.3f} s, ate_mm {m['ate_mm']:.4f} vs "
        f"{reference['ate_mm']:.4f}, verts {m['verts']} vs {reference['verts']}; meshed="
        f"{len(meshed)} patched={len(patched)} ({len(patched) / max(len(meshed), 1):.3f}) "
        f"wrong={len(wrong)} ({len(wrong) / max(len(meshed), 1):.3f}) patched_not_wrong="
        f"{len(good)} ({len(good) / max(len(meshed), 1):.3f}) patches="
        f"{len(tm.atlas.patches)} overflowed={tm.atlas.overflowed} kf_stack_rows="
        f"{tm.kf_stack.cap} peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    log(f"[{name}] texture audit: {json.dumps(_texture_audit(pipe))}")
    log(f"[{name}] colour error vs scene.color, uint8 levels, {len(pos)} vertices "
        f"({int(exposed.sum())} labelled with a keyframe of frames {EXPOSURE_FRAMES[0]}-"
        f"{EXPOSURE_FRAMES[1] - 1}): {json.dumps(errors)}")
    ids = pipe.volume.ids
    m.update(texture_s=STOPWATCH.totals["texture"], texture_final_s=STOPWATCH.totals[
        "texture_final"], export_s=export_s, colour_errors=errors, tex_stages=stages,
        patched_share=len(good) / max(len(meshed), 1),
        labels_by_id={tuple(ids[s].tolist()): t.label for s, t in tm.chunk_tex.items()})
    if geometry and (abs(m["ate_mm"] - reference["ate_mm"]) > TEX_ATE_MM or
                     abs(m["verts"] - reference["verts"]) > TEX_VERTS_FRAC * reference["verts"]):
        raise AssertionError(f"[{name}] the map or trajectory moved against [{ref_name}]")
    if tm.atlas.overflowed or len(good) < TEX_PATCHED_FRAC * len(meshed):
        raise AssertionError(f"[{name}] atlas overflowed or only {len(good)} of "
                             f"{len(meshed)} meshed chunks patched and not wrong")
    if not (set(sizes) == {"obj", "mtl", "png"} and n_v == n_vt == len(pos) > 0
            and len(faces) > 0 and faces.min() >= 1 and faces.max() <= n_v
            and np.isfinite(cols).all() and cols.min() >= 0.0 and cols.max() <= 1.0
            and img is not None and img.shape == (tm.atlas.used_rows(), tm.atlas.size, 3)):
        raise AssertionError(f"[{name}] textured export inconsistent")


def _bench_scene():
    from texturefusion_torch.io import synthetic
    return synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6), room_max=(2.6, 1.5, 2.6))


def phase_profile_pipeline(frames, first=60, n=10):
    """torch.profiler over n frames of a fresh pipeline: device busy share
    and the device ops that take most of the time. No gate."""
    from torch.profiler import ProfilerActivity, profile
    _, _, packed = frames
    config = _pipeline_config()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pipeline(config, packed[first:first + n], "cuda")[0].close()
        wall = time.perf_counter() - t0
    log(f"[profile-pipeline] {n} frames + finish wall={wall:.4f} s "
        + _device_time(prof, wall, 12, n))


class LandedFetch:
    """A fetch handle read when it is made: swapped in for
    async_fetch.fetch_async, every decision of the pipelined tracker and
    every deferred consume of the fusion side sees its fetches landed, on
    any device, as on the CPU. Takes a tensor or a tuple of tensors."""

    def __init__(self, value):
        if isinstance(value, (tuple, list)):
            self._value = tuple(t.detach().cpu().numpy() for t in value)
        else:
            self._value = value.detach().cpu().numpy()

    def done(self):
        return True

    def result(self):
        return self._value


def phase_pipeline_small(n_frames=10, n_pipelined=20):
    """TexturedPipeline on the tiny config, GPU against CPU with the same
    RANSAC draws: the synchronous tracker on 10 orbit frames (one keyframe
    and its six local frames, integrated and textured at finish), then the
    pipelined tracker at depth 2 with deferred promotion and the
    stale-frame refinement on 20 (five keyframes, BA, stale frames,
    refinements), each cycle reading its own results, then the same with
    the cycle results consumed a cycle late (async_cycle_results, the
    default: the deferred run); the last two with their fetches landed at
    once on both devices (LandedFetch). Each run is held to
    _small_compare's gates."""
    import dataclasses

    from texturefusion_torch.utils import async_fetch
    _small_compare("pipeline-small", _pipeline_config(small=True), n_frames)
    fetch_async = async_fetch.fetch_async
    async_fetch.fetch_async = LandedFetch
    try:
        deferred = _pipeline_config(small=True, pipelined=True)
        in_order = deferred.replace(parallel=dataclasses.replace(deferred.parallel,
                                                                 async_cycle_results=False))
        _small_compare("pipeline-small pipelined", in_order, n_pipelined)
        _small_compare("pipeline-small deferred", deferred, n_pipelined)
    finally:
        async_fetch.fetch_async = fetch_async


def _small_compare(name, config, n_frames):
    """One tiny-config TexturedPipeline run on the GPU and on the CPU with
    the same draws, compared: the same keyframes, stale-finalized frames
    and adopted refinements, keyframe counts within 1 and the same
    origins, positions within 1 mm, chunk sets and vertex counts within
    1%, at most 0.1% of the observed voxels of the common chunks with sdf
    more than 1e-4 apart (as [small]), the same deferral counts
    (deferral_counts), then the texture (_texture_compare)."""
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    poses, packed = _orbit_frames(config, n_frames)
    runs, deferrals = {}, {}
    for dev in ("cuda", "cpu"):
        STOPWATCH.reset()
        runs[dev] = run_pipeline(config, packed, dev, cpu_draw_fn(config.tracking),
                                 textured=True)[0]
        deferrals[dev] = deferral_counts(runs[dev])
    g, c = runs["cuda"], runs["cpu"]
    kg, kc = len(g.slam.keyframes), len(c.slam.keyframes)
    diff_mm = np.abs(g.trajectory()[:, :3, 3] - c.trajectory()[:, :3, 3]).max() * 1e3
    g_of = {tuple(r): s for s, r in zip(g.volume.active_slots(),
                                        g.volume.ids[g.volume.used].tolist())}
    c_of = {tuple(r): s for s, r in zip(c.volume.active_slots(),
                                        c.volume.ids[c.volume.used].tolist())}
    common = sorted(set(g_of) & set(c_of))
    n_diff = len(set(g_of) ^ set(c_of))
    gi, ci = [g_of[k] for k in common], [c_of[k] for k in common]
    seen = (g.volume.batch.weight[gi].cpu() > 0) | (c.volume.batch.weight[ci] > 0)
    frac = float(((g.volume.batch.sdf[gi].cpu() - c.volume.batch.sdf[ci]).abs()
                  > 1e-4)[seen].float().mean())
    nv_g, nv_c = len(g.mesher.full_mesh()[0]), len(c.mesher.full_mesh()[0])
    decisions = [(p.slam.stale_frames, p.slam.refine_adopted,
                  [k.frame_index for k in p.slam.keyframes], deferrals[dev])
                 for dev, p in (("cuda", g), ("cpu", c))]
    log(f"[{name}] 160x120 x{n_frames} orbit frames: keyframes gpu={kg} cpu={kc} "
        f"origins gpu={g.slam.origin_count} cpu={c.slam.origin_count} "
        f"position_diff_mm={diff_mm:.4f} chunks gpu={len(g_of)} cpu={len(c_of)} "
        f"differing={n_diff} observed_voxels={int(seen.sum())} sdf_frac_over_1e-4={frac:.2e} "
        f"verts gpu={nv_g} cpu={nv_c} reintegrations gpu={g.stats['reintegrations']} "
        f"cpu={c.stats['reintegrations']} stale_frames gpu={g.slam.stale_frames} "
        f"cpu={c.slam.stale_frames} refine_adopted gpu={g.slam.refine_adopted} "
        f"cpu={c.slam.refine_adopted} async_cycle_results={config.parallel.async_cycle_results} "
        f"deferrals gpu={json.dumps(deferrals['cuda'])} cpu={json.dumps(deferrals['cpu'])}")
    if not (abs(kg - kc) <= SMALL_KF_DIFF and g.slam.origin_count == c.slam.origin_count
            and diff_mm <= SMALL_TRAJ_MM and n_diff <= len(c_of) // 100 and frac <= 1e-3
            and nv_c > 0 and abs(nv_g - nv_c) <= nv_c // 100
            and decisions[0] == decisions[1]):
        raise AssertionError(f"[{name}] GPU pipeline disagrees with the CPU pipeline on a "
                             f"small input")
    _texture_compare(g, c, name)


def _texture_compare(g, c, name="pipeline-small"):
    """The GPU's texture state against the CPU's, by chunk id: labels equal
    on ≥ 99% of the chunks both have; patched chunk sets within 1%; uv16
    within 1 on ≥ 99% of the valid vertices of the common patched chunks
    whose meshes agree; their atlas tiles within 2 levels on ≥ 99% of the
    values."""
    def by_id(p):
        ids = p.volume.ids
        return {tuple(ids[s].tolist()): (s, t) for s, t in p.texture.chunk_tex.items()}

    gt, ct = by_id(g), by_id(c)
    common = sorted(set(gt) & set(ct))
    labels_same = float(np.mean([gt[k][1].label == ct[k][1].label for k in common]))
    gp = {k for k, (s, _) in gt.items() if s in g.texture.atlas.patches}
    cp = {k for k, (s, _) in ct.items() if s in c.texture.atlas.patches}
    uv_ok, tile_ok = [], []
    for k in sorted(gp & cp):
        (gs, gx), (cs, cx) = gt[k], ct[k]
        if g.mesher.vcount[gs] == c.mesher.vcount[cs]:
            valid = cx.uv_valid & gx.uv_valid
            uv_ok.append((np.abs(gx.uv16.astype(np.int64) - cx.uv16).max(-1) <= 1)[valid])
        tiles = [_atlas_tile(p.texture.atlas, p.texture.atlas.patches[s]).astype(np.int64)
                 for p, s in ((g, gs), (c, cs))]
        tile_ok.append((np.abs(tiles[0] - tiles[1]) <= 2).ravel())
    uv_frac = float(np.mean(np.concatenate(uv_ok))) if uv_ok else 0.0
    tile_frac = float(np.mean(np.concatenate(tile_ok))) if tile_ok else 0.0
    log(f"[{name}] texture: chunks gpu={len(gt)} cpu={len(ct)} common={len(common)} "
        f"labels_equal={labels_same:.4f} patched gpu={len(gp)} cpu={len(cp)} "
        f"differing={len(gp ^ cp)} uv16_within_1={uv_frac:.4f} tiles_within_2={tile_frac:.4f}")
    if not (common and labels_same >= 0.99 and len(gp ^ cp) <= len(cp) // 100
            and len(cp) > 0 and uv_frac >= 0.99 and tile_frac >= 0.99):
        raise AssertionError(f"[{name}] GPU texture state disagrees with the CPU's on a small "
                             f"input")


def _atlas_tile(atlas, rec):
    ox, oy = atlas._slot_origin(rec.slot_index)
    return atlas.image[oy:oy + atlas.patch_size, ox:ox + atlas.patch_size]


# ------------------------------------------------------------------ the CLI, checkpoint, raycast

CKPT_CUT = 60             # [checkpoint]: frames before the save
RAYCAST_VIEWS = 8         # [raycast]: loop poses rendered from the slice's volume
RAYCAST_HIT = 0.5         # test_raycast.py's thresholds
RAYCAST_UNIT = 0.95
TUM_FILTER = 4            # [cli-dataset]: every PNG row Paeth-filtered, the decoder's slow path
PROXY_FRAMES = 120        # [fr1-proxy]: docs/ATE_PROXY.md's run, 120 VGA frames at 2 cm voxels
# docs/ATE_PROXY.md: the JAX package's run of the same proxy on a TPU (round 5, with the
# synchronous configuration that was then its CLI's default); printed beside the port's
# run as context, not as a target
JAX_PROXY_RUN = {"keyframes": 29, "reintegrations": 32, "ba_rounds": 27,
                 "chunks_created": 6927, "chunks_meshed": 1396, "verts": 84255, "ate_mm": 3.4}
# [demo]: the exit code of examples/demo_synthetic.py at the same arguments (--size vga,
# 8 frames) run on the CPU under JAX_PLATFORMS=cpu: 0 in ground-truth mode (9209
# vertices, median |SDF| 0.1 mm) and 0 with --slam --texture (ATE 0.7 mm, 9160 vertices)
DEMO_MODES = {"gt": [], "slam": ["--slam", "--texture"]}
DEMO_JAX_EXIT = {"gt": 0, "slam": 0}


def unpack_frame(frame: np.ndarray):
    """A packed [H, W, 5] frame (preprocess.pack_frame) -> (depth uint16, rgb uint8)."""
    depth = frame[..., 0].astype(np.uint16) | (frame[..., 1].astype(np.uint16) << 8)
    return depth, np.ascontiguousarray(frame[..., 2:5])


def write_tum_dataset(root, camera, packed, poses, t0=1000.0, fps=30.0, filter_type=TUM_FILTER):
    """Packed frames as a TUM RGB-D directory, through io/png: rgb/ (8-bit)
    and depth/ (16-bit) PNGs with every row filtered by `filter_type`,
    associate.txt, a calib.txt with the five distortion fields and
    groundtruth.txt (`ts tx ty tz qx qy qz qw`). Returns the timestamps."""
    from texturefusion_torch.core import se3
    from texturefusion_torch.io import png
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    stamps = [t0 + i / fps for i in range(len(packed))]
    assoc, gt = [], []
    for i, (ts, frame, pose) in enumerate(zip(stamps, packed, poses)):
        depth, rgb = unpack_frame(frame)
        rp, dp = f"rgb/{i:06d}.png", f"depth/{i:06d}.png"
        png.write_png(os.path.join(root, rp), rgb, filter_type=filter_type)
        png.write_png(os.path.join(root, dp), depth, filter_type=filter_type)
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        q = se3.quaternion_from_matrix(torch.as_tensor(np.asarray(pose[:3, :3], np.float32)))
        gt.append(f"{ts:.6f} " + " ".join(repr(float(v)) for v in (*pose[:3, 3], *q.tolist())))
    c = camera
    with open(os.path.join(root, "associate.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(" ".join(repr(float(v)) for v in (c.fx, c.fy, c.cx, c.cy, c.width, c.height,
                                                    c.depth_scale, c.d0, c.d1, c.d2, c.d3,
                                                    c.d4)) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt) + "\n")
    return stamps


def read_back_tum(root, packed):
    """Read every frame of a TUM directory through io/tum and hold it to the
    packed frame it was written from, bit for bit. Returns (the sequence,
    PNG decode seconds a frame: depth and rgb)."""
    from texturefusion_torch.io import tum
    seq = tum.load_tum_sequence(root)
    if len(seq) != len(packed):
        raise AssertionError(f"{root}: {len(seq)} frames read, {len(packed)} written")
    t0 = time.perf_counter()
    for i, frame in enumerate(packed):
        depth, rgb = seq.load_frame_raw(i)
        want_d, want_rgb = unpack_frame(frame)
        if not (np.array_equal(depth, want_d) and np.array_equal(rgb, want_rgb)):
            raise AssertionError(f"{root}: frame {i} does not read back as written")
    return seq, (time.perf_counter() - t0) / len(packed)


def run_cli(argv):
    """texturefusion_torch.__main__.main(argv) in this process, its standard
    output captured and logged. Returns (exit code, frames/s)."""
    import contextlib
    import io

    from texturefusion_torch.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(("processed", "fused.ply", "textured model", "texture export",
                            "ATE RMSE")):
            log(f"    | {line[:400]}")
    m = re.search(r"processed \d+ frames in [0-9.]+s \(([0-9.]+) fps\)", text)
    return rc, float(m.group(1)) if m else float("nan")


def check_cli_outputs(out_dir, n_frames, textured=True) -> dict:
    """The command line's outputs, complete: trajectory.txt with a line a
    frame, stat.txt and chunk.txt, fused.ply with vertices (from its
    header), one .cam and one .png a keyframe and, when textured,
    model.obj / .mtl / .png. Returns {verts, keyframes}."""
    from texturefusion_torch.io import png
    lines = open(os.path.join(out_dir, "trajectory.txt")).read().strip().splitlines()
    if len(lines) != n_frames or not all(len(ln.split()) == 8 for ln in lines):
        raise AssertionError(f"{out_dir}: {len(lines)} trajectory lines for {n_frames} frames")
    with open(os.path.join(out_dir, "fused.ply"), "rb") as f:
        head = f.read(4096).split(b"end_header")[0].decode()
    verts = int(re.search(r"element vertex (\d+)", head).group(1))
    kf_dir = os.path.join(out_dir, "keyframes")
    cams = sorted(f[:-4] for f in os.listdir(kf_dir) if f.endswith(".cam"))
    pngs = sorted(f[:-4] for f in os.listdir(kf_dir) if f.endswith(".png"))
    need = ["stat.txt", "chunk.txt"] + (["model.obj", "model.mtl", "model.png"] if textured else [])
    missing = [n for n in need if not os.path.exists(os.path.join(out_dir, n))]
    if verts <= 0 or not cams or cams != pngs or missing:
        raise AssertionError(f"{out_dir}: {verts} vertices, keyframes {cams} / {pngs}, "
                             f"missing {missing}")
    for name in cams:
        vals = open(os.path.join(kf_dir, name + ".cam")).read().split()
        if len(vals) != 16 or png.read_png(os.path.join(kf_dir, name + ".png")).ndim != 3:
            raise AssertionError(f"{kf_dir}/{name}: a bad keyframe dump")
    return {"verts": verts, "keyframes": len(cams)}


def phase_cli_synthetic(n_frames=30):
    """`python -m texturefusion_torch "" "" 0.02 4 --max-frames 30`, in
    process: the JAX package's README synthetic usage at VGA, textured."""
    from texturefusion_torch.ops import cuda_kernels
    cuda_kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        rc, fps = run_cli(["", "", "0.02", "4", "--out", out, "--max-frames", str(n_frames)])
        launches = dict(cuda_kernels.LAUNCHES)
        res = check_cli_outputs(out, n_frames)
    log(f"[cli-synthetic] rc={rc} {n_frames} frames {fps:.3f} frames/s verts={res['verts']} "
        f"keyframes={res['keyframes']} launches={json.dumps(launches)}")
    if rc != 0 or min(launches.values()) <= 0:
        raise AssertionError(f"[cli-synthetic] rc {rc}, launches {launches}")
    return launches


def _upload_ms(packed):
    """Each packed frame uploaded the pageable way (torch.as_tensor(...).to)
    and through io/prefetch.upload (a pinned copy, then a non-blocking
    copy), each synchronised: mean ms a frame each way."""
    from texturefusion_torch.io.prefetch import upload
    dev = torch.device("cuda")
    out = {}
    for name, fn in (("pageable", lambda f: torch.as_tensor(f).to(dev)),
                     ("pinned", lambda f: upload(f, dev))):
        fn(packed[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in packed:
            fn(f)
            torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / len(packed) * 1e3
    return out


def phase_cli_dataset(frames, reference):
    """[slice]'s 120 loop frames (bench camera, depth noise, no exposure step
    or blur) written as a TUM directory, read back bit for bit, then
    `python -m texturefusion_torch ROOT "" 0.02 0`, textured; its
    trajectory.txt against groundtruth.txt through io/tum."""
    from texturefusion_torch.io import tum
    from texturefusion_torch.ops import cuda_kernels
    config, _, poses, packed = frames
    with tempfile.TemporaryDirectory() as tmp:
        root, out = os.path.join(tmp, "tum"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        write_tum_dataset(root, config.camera, packed, poses)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        _, decode_s = read_back_tum(root, packed)
        up = _upload_ms(packed)
        cuda_kernels.reset_launch_counts()
        rc, fps = run_cli([root, "", "0.02", "0", "--out", out])
        launches = dict(cuda_kernels.LAUNCHES)
        res = check_cli_outputs(out, len(packed))
        ts, est = tum.trajectory_from_tum(os.path.join(out, "trajectory.txt"))
        gt_ts, gt = tum.trajectory_from_tum(os.path.join(root, "groundtruth.txt"))
    pairs = tum.associate_timestamps(ts, gt_ts, max_dt=0.01)
    ate = tum.ate_rmse(est[[i for i, _ in pairs]], gt[[j for _, j in pairs]]) * 1e3
    log(f"[cli-dataset] {len(packed)} frames written as TUM PNGs (filter {TUM_FILTER}) in "
        f"{write_s:.3f} s, {nbytes} bytes; read back bit for bit; PNG decode "
        f"{decode_s * 1e3:.2f} ms a frame (depth + rgb); upload a frame pageable "
        f"{up['pageable']:.4f} ms, pinned {up['pinned']:.4f} ms")
    log(f"[cli-dataset] rc={rc} {fps:.3f} frames/s ate_mm={ate:.3f} over {len(pairs)} poses "
        f"([pipeline] {reference['ate_mm']:.3f}, hardened frames) verts={res['verts']} "
        f"keyframes={res['keyframes']} launches={json.dumps(launches)}")
    if rc != 0 or len(pairs) != len(packed) or not ate <= ATE_MM:
        raise AssertionError(f"[cli-dataset] rc {rc}, {len(pairs)} poses, ATE {ate:.3f} mm")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[cli-dataset] a kernel of the path never launched: {launches}")
    return launches


def load_tool(name: str, folder: str = "tools"):
    """FOLDER/NAME.py of the repo as a module (tools/ and examples/ are
    directories of scripts, not packages)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_run_stats(out_dir) -> dict:
    """The command line's counts from its stat.txt and chunk.txt:
    keyframes, reintegrations, BA rounds (the count of the "cpp_ba"
    stopwatch, 0 when it never ran: reset the STOPWATCH before the run),
    chunks created and chunks meshed."""
    with open(os.path.join(out_dir, "stat.txt")) as f:
        stat = f.read()
    with open(os.path.join(out_dir, "chunk.txt")) as f:
        chunk = f.read()

    def field(pattern, text):
        return int(re.search(pattern, text, re.M).group(1))

    ba = re.search(r"^\s*cpp_ba: .*\((\d+)x\)$", stat, re.M)
    return {"keyframes": field(r"^keyframes: (\d+)$", stat),
            "reintegrations": field(r"^reintegrations: (\d+)$", stat),
            "ba_rounds": int(ba.group(1)) if ba else 0,
            "chunks_created": field(r"chunks_created (\d+)", chunk),
            "chunks_meshed": field(r"meshed (\d+)", chunk)}


def phase_fr1_proxy(n_frames=PROXY_FRAMES):
    """tools/make_tum_proxy.py's fr1 proxy (distorted fr1 camera, Kinect
    noise, shadow dropout, flicker, exposure step, blur burst, mocap-frame
    ground truth) generated on the card, then `python -m texturefusion_torch
    ROOT "" 0.02 0 --out ROOT/out` (its --run), textured; its counts beside
    the JAX package's recorded TPU run."""
    import contextlib
    import io

    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    mk = load_tool("make_tum_proxy")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fr1_proxy")
        out = os.path.join(root, "out")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            mk.generate(root, n_frames, device="cuda")
        gen_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        STOPWATCH.reset()
        cuda_kernels.reset_launch_counts()
        rc, fps = run_cli([root, "", "0.02", "0", "--out", out])
        launches = dict(cuda_kernels.LAUNCHES)
        res = check_cli_outputs(out, n_frames)
        ate_m, n_pairs = mk.trajectory_ate(out, root)
        stats = cli_run_stats(out)
    got = dict(stats, verts=res["verts"], ate_mm=round(ate_m * 1e3, 3))
    log(f"[fr1-proxy] {n_frames} VGA frames generated on the card in {gen_s:.3f} s, "
        f"{nbytes} bytes written; rc={rc} {fps:.3f} frames/s ate_mm={ate_m * 1e3:.3f} over "
        f"{n_pairs} poses launches={json.dumps(launches)}")
    log(f"[fr1-proxy] port {json.dumps(got)}; the JAX package's TPU run (docs/ATE_PROXY.md, "
        f"round 5, not a target) {json.dumps(JAX_PROXY_RUN)}")
    if rc != 0 or n_pairs != n_frames or not ate_m * 1e3 <= ATE_MM:
        raise AssertionError(f"[fr1-proxy] rc {rc}, {n_pairs} poses, ATE {ate_m * 1e3:.3f} mm")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[fr1-proxy] a kernel of the path never launched: {launches}")
    return launches


def phase_demo():
    """tools/demo_synthetic.py in process at --size vga, 8 frames: ground-
    truth mode (K1, K2, IncrementalMesher) and --slam --texture
    (TexturedPipeline, finish(), the exports), each held to the exit code
    the JAX script gives at the same arguments; K1 and K2 launched in
    each."""
    import contextlib
    import io

    from texturefusion_torch.ops import cuda_kernels
    demo = load_tool("demo_synthetic")
    total_launches = dict.fromkeys(cuda_kernels.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for mode, extra in DEMO_MODES.items():
            cuda_kernels.reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                res = demo.run(["--size", "vga", "--out", os.path.join(tmp, mode), *extra])
            launches = dict(cuda_kernels.LAUNCHES)
            ate = "-" if res["ate_mm"] is None else f"{res['ate_mm']:.3f}"
            log(f"[demo] {mode}: rc={res['rc']} (the JAX script on the CPU: exit "
                f"{DEMO_JAX_EXIT[mode]}) verts={res['verts']} "
                f"map_median_mm={res['median_mm']:.3f} ate_mm={ate} keyframes={res['keyframes']} "
                f"lost_frames={res['lost_frames']} {res['fps']:.3f} frames/s "
                f"launches={json.dumps(launches)}")
            if res["rc"] != DEMO_JAX_EXIT[mode]:
                raise AssertionError(f"[demo] {mode}: exit {res['rc']}, the JAX script's "
                                     f"{DEMO_JAX_EXIT[mode]}")
            if launches["bilateral"] <= 0 or launches["tsdf_integrate"] <= 0:
                raise AssertionError(f"[demo] {mode}: K1 or K2 never launched: {launches}")
            for k, v in launches.items():
                total_launches[k] += v
    return total_launches


def _state_equal(a, b) -> dict:
    """The saved pipeline `a` against the restored `b`, bit for bit, by part."""
    va, vb, sa, sb = a.volume, b.volume, a.slam, b.slam
    return {
        "tsdf_rows": all(torch.equal(x, y) for x, y in zip(va.batch, vb.batch)),
        "slot_map": (np.array_equal(va.ids, vb.ids) and np.array_equal(va.used, vb.used)
                     and va.slot_of == vb.slot_of and torch.equal(va.origins, vb.origins)),
        "poses": np.array_equal(sa.poses, sb.poses) and np.array_equal(a.trajectory(),
                                                                      b.trajectory()),
        "keypoint_db": (all(torch.equal(x, y) for x, y in zip(sa.kp_db.kp, sb.kp_db.kp))
                        and torch.equal(sa._row_to_slot, sb._row_to_slot)
                        and torch.equal(sa.db.desc, sb.db.desc)
                        and torch.equal(sa.db.valid, sb.db.valid)),
        "edges": (sa.n_edges == sb.n_edges
                  and all(torch.equal(x, y) for x, y in zip(sa.edges, sb.edges))),
    }


def phase_checkpoint(frames, reference):
    """[pipeline]'s config and frames to frame 60, save_pipeline, load into a
    fresh ReconstructionPipeline (state held to the saved one bit for bit),
    then frames 60-119 and finish() there: new keyframes and edges, one map
    origin, [pipeline]'s gates."""
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils import checkpoint
    _, poses, packed = frames
    config = _pipeline_config()
    cuda_kernels.reset_launch_counts()
    first = _pipeline(config, "cuda")
    for i in range(CKPT_CUT):
        first.process_frame(packed[i], timestamp=float(i), host_packed=packed[i])
    kf_cut, edges_cut = len(first.slam.keyframes), first.slam.n_edges
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline.ckpt")
        _sync("cuda")
        t0 = time.perf_counter()
        checkpoint.save_pipeline(first, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path) + os.path.getsize(path + ".meta")
        pipe = _pipeline(config, "cuda")
        t0 = time.perf_counter()
        checkpoint.load_pipeline(pipe, path)
        _sync("cuda")
        load_s = time.perf_counter() - t0
    same = _state_equal(first, pipe)
    first.close()
    del first
    t0 = time.perf_counter()
    for i in range(CKPT_CUT, len(packed)):
        pipe.process_frame(packed[i], timestamp=float(i), host_packed=packed[i])
    pipe._drain_fusion()
    _sync("cuda")
    loop = time.perf_counter() - t0
    pipe.finish()
    _sync("cuda")
    launches = dict(cuda_kernels.LAUNCHES)
    m, traj = _tracking_metrics(pipe.slam, poses)
    rms, med, n_verts = _map_error_mm(pipe, _bench_scene(), np.stack(poses))
    identical = bool(np.array_equal(traj, reference["traj"]))
    pipe.close()
    log(f"[checkpoint] saved at frame {CKPT_CUT}: {size} bytes, save {save_s:.3f} s, load "
        f"{load_s:.3f} s; restored bit for bit: {json.dumps(same)}")
    log(f"[checkpoint] resumed {len(packed) - CKPT_CUT} frames at "
        f"{(len(packed) - CKPT_CUT) / loop:.3f} frames/s: keyframes {kf_cut} -> {m['keyframes']} "
        f"edges {edges_cut} -> {m['edges']} origins={m['origins']} ate_mm={m['ate_mm']:.3f} "
        f"map_rms_mm={rms:.3f} map_median_mm={med:.3f} verts={n_verts} reintegrations="
        f"{pipe.stats['reintegrations']} beside [pipeline]: ate_mm {reference['ate_mm']:.3f} "
        f"map_rms_mm {reference['map_rms_mm']:.3f} verts {reference['verts']}; trajectory "
        f"identical to [pipeline]'s: {identical} launches={json.dumps(launches)}")
    if not all(same.values()):
        raise AssertionError(f"[checkpoint] restored state differs: {same}")
    if not (m["keyframes"] > kf_cut and m["edges"] > edges_cut and m["origins"] == 1):
        raise AssertionError("[checkpoint] no keyframe or edge after the resume, or a new origin")
    if not (m["ate_mm"] <= ATE_MM and rms <= MAP_RMS_MM):
        raise AssertionError(f"[checkpoint] gates failed: ATE {m['ate_mm']:.3f} mm, map RMS "
                             f"{rms:.3f} mm")
    return launches


def _shards():
    """N_SHARDS shards: one a card where that many cards exist, else all on
    the first card (they then share its stream: no scaling figure)."""
    from texturefusion_torch.parallel import mesh as pmesh
    if torch.cuda.device_count() >= N_SHARDS:
        return pmesh.make_mesh(N_SHARDS, "cuda"), f"{N_SHARDS} cards"
    return pmesh.DeviceMesh(["cuda:0"] * N_SHARDS), f"{N_SHARDS} shards sharing one card"


def _chain_graph(n_kf, device, n_pts=80, noise=0.03, seed=3, n_loops=3):
    """tests/test_parallel.py's keyframe chain with a few loop edges, at
    n_kf keyframes: (noisy poses, edges, active)."""
    from texturefusion_torch.core import se3
    from texturefusion_torch.slam import fastba
    rng = np.random.default_rng(seed)
    gt = se3.se3_exp(torch.tensor([[0.25 * k, 0.01 * k, 0.002 * k * k, 0.0, 0.03 * k,
                                    0.001 * k] for k in range(n_kf)], dtype=torch.float32))
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    pairs = [(k, k + 1) for k in range(n_kf - 1)]
    pairs += [(int(rng.integers(0, n_kf // 2)), n_kf - 1 - i) for i in range(n_loops)]
    edges = fastba.make_edges(len(pairs), "cpu")
    inv = se3.inverse(gt)
    for e, (i, j) in enumerate(pairs):
        p = se3.transform_points(inv[i], torch.as_tensor(pts))
        q = se3.transform_points(inv[j], torch.as_tensor(pts))
        fastba.write_edges(edges, torch.tensor([e]), i, j,
                           [x[None] for x in fastba.preintegrate_edge(p, q, torch.ones(n_pts))])
    xi = torch.as_tensor(rng.normal(0, noise, (n_kf, 6)).astype(np.float32))
    xi[0] = 0.0
    poses = se3.compose(se3.se3_exp(xi), gt)
    return (poses.to(device), fastba.EdgeSums(*(a.to(device) for a in edges)),
            torch.ones(n_kf, dtype=torch.bool, device=device))


def phase_ba_sharded(n_kf=64, n_rounds=10):
    """distributed_gn and schur_gn (sep_budget 24) over N_SHARDS shards of
    the card against the dense fastba.gauss_newton_rounds on the card, on
    a 64-keyframe chain (one round of 4 iterations): poses within
    test_parallel.py's Schur tolerances; ms a round (median of 10, host
    clock ending in a synchronize), edges per shard, separators and the
    psum's bytes an iteration."""
    from texturefusion_torch.config import BAConfig
    from texturefusion_torch.parallel import ba as pba
    from texturefusion_torch.slam import fastba
    mesh, where = _shards()
    poses, edges, active = _chain_graph(n_kf, "cuda")
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=4)
    shards = pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh)
    runs = {"dense": lambda: fastba.gauss_newton_rounds(poses, edges, n_kf, active, cfg),
            "distributed": lambda: pba.distributed_gn(poses, shards, n_kf, active, cfg, mesh),
            "schur": lambda: pba.schur_gn(poses, shards, n_kf, active, cfg, mesh,
                                          sep_budget=BA_SEP_BUDGET)}
    out, ms = {}, {}
    for name, fn in runs.items():
        out[name] = fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms[name] = float(np.median(times) * 1e3)
    dense = out["dense"][0]
    err = {k: float((out[k][0] - dense).abs().max()) for k in ("distributed", "schur")}
    ok = {k: bool(torch.allclose(out[k][0], dense, rtol=BA_RTOL, atol=BA_ATOL)) for k in err}
    n_sep = int(pba._separators(mesh, shards, n_kf, n_kf // mesh.size).sum())
    k6 = 6 * n_kf
    log(f"[ba-sharded] {n_kf}-keyframe chain, {int(edges.valid.sum())} edges over {where}: "
        f"ms a round (4 iterations) dense={ms['dense']:.3f} distributed={ms['distributed']:.3f} "
        f"schur={ms['schur']:.3f}; edges per shard "
        f"{[int(e.valid.sum()) for e in shards]}, separators {n_sep} of {n_kf} (budget "
        f"{BA_SEP_BUDGET}); psum payload an iteration {mesh.size * (k6 * k6 + k6) * 4} bytes "
        f"(each shard's [6K, 6K] H and [6K] b); max |pose - dense| {json.dumps(err)}; errors "
        f"after: dense {float(out['dense'][2]):.3e} distributed "
        f"{float(out['distributed'][2]):.3e} schur {float(out['schur'][2]):.3e} (before "
        f"{float(out['dense'][1]):.3e})")
    if not all(ok.values()) or n_sep > BA_SEP_BUDGET or n_sep == 0:
        raise AssertionError(f"[ba-sharded] sharded BA disagrees with the dense solve: {ok}, "
                             f"or the Schur path did not run ({n_sep} separators)")
    return ms


def phase_multichip():
    """dryrun_multichip over N_SHARDS shards of the card (one full map
    cycle: discovery, sharded integration (K2 on every shard), meshing
    across shards, datacost, MRF, an edge-sharded BA round; then the live
    pipeline, tsdf_sharded, on three tiny frames), its asserts; then the
    map cycle on the card against the same cycle on an 8-shard CPU mesh
    (plain kernels): n_found, vertex counts and labels equal, rows within
    K2's tolerances, poses within 1e-4."""
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.parallel import mesh as pmesh
    from texturefusion_torch.parallel.dryrun import dryrun_multichip, multichip_cycle
    mesh, where = _shards()
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = dryrun_multichip(mesh.size, mesh=mesh)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    g = multichip_cycle(mesh, 8)
    c = multichip_cycle(pmesh.make_mesh(8, "cpu"), 8)
    rows_g = g[0].batch.gather(np.arange(g[0].batch.n_rows), device="cpu")
    rows_c = c[0].batch.gather(np.arange(c[0].batch.n_rows), device="cpu")
    errs = {name: float((a - b).abs().max())
            for name, a, b in zip(K2_ROW_TOL, rows_g, rows_c)}
    rows_ok = all(torch.allclose(a, b, rtol=K2_ROW_TOL[n][0], atol=K2_ROW_TOL[n][1])
                  for n, a, b in zip(K2_ROW_TOL, rows_g, rows_c))
    pose_err = float((g[0].poses.cpu() - c[0].poses).abs().max())
    same = {"n_found": int(g[1]) == int(c[1]),
            "vcount": bool(torch.equal(g[2].cpu(), c[2])),
            "labels": bool(torch.equal(g[3].cpu(), c[3]))}
    log(f"[multichip] dryrun_multichip over {where}: asserts held in {dry_s:.3f} s; n_found="
        f"{r['n_found']} vcount={r['vcount'].tolist()} weight_sum={r['weight_sum']:.1f} "
        f"pipeline chunks={r['pipeline_active']} weight={r['pipeline_weight']:.1f} "
        f"launches={json.dumps(launches)}; map cycle (64 slots) card vs 8 CPU shards: "
        f"{json.dumps(same)} n_found={int(g[1])} vertices={int(g[2].sum())} row max_abs_err "
        f"{json.dumps(errs)} pose max_abs_err={pose_err:.2e}")
    if not (all(same.values()) and rows_ok and pose_err <= 1e-4 and int(g[2].sum()) > 0):
        raise AssertionError("[multichip] the card's map cycle disagrees with the CPU's")
    if not (launches["tsdf_integrate"] >= mesh.size and launches["bilateral"] == 3):
        raise AssertionError(f"[multichip] K2 or K1 did not run as it should: {launches}")
    return launches


SOL_N = 5                     # [sol]: timed calls of each program
SCALING_CAP = 4096            # [bench-multichip]: slots of the sharded TSDF step


def sol_ops(work: dict) -> dict:
    """[sol]'s operations of a row's work (tools/sol_report.py): K2's
    launches and the F-frame mode from the built SASS ([sass]), K1's taps
    at K1_FLOPS_PER_TAP fp32 operations and one exp each."""
    ops = {}

    def add(more):
        for unit, (count, rate) in more.items():
            if unit in ops and ops[unit][1] != rate:
                raise ValueError(f"[sol] {unit} counted at two rates")
            ops[unit] = (ops.get(unit, (0, rate))[0] + count, rate)

    for n_lanes, threads in work.get("k2", ()):
        add(_k2_ops(n_lanes, threads))
    if "frames" in work:
        add(frames_ops(*work["frames"]))
    if "k1_taps" in work:
        taps = work["k1_taps"]
        add({"fp32": (K1_FLOPS_PER_TAP * taps, FP32_FLOPS_PER_S),
             "exp unit": (taps, sm_rate(EXP_PER_SM_CLOCK))})
    return ops


def _positive_times(name: str, lines: dict) -> None:
    """Every time of a tool's lines finite and above 0 (its device columns
    where it has them), and device ops counted; raises."""
    for label, m in lines.items():
        times = [m["ms"]] + [m[k] for k in ("span_ms", "device_ms") if m.get(k) is not None]
        if not all(np.isfinite(t) and t > 0 for t in times) or m.get("device_ops") == 0:
            raise AssertionError(f"[{name}] {label}: a time not finite and positive, or no "
                                 f"device op: {m}")


def phase_sol():
    """tools/sol_report.py's programs at the JAX script's inputs, each alone
    (the K2 rows: integrate, reintegrate, the F-frame mode at F = 6): ms,
    span_ms, device_ms, device_ops, the JAX bytes, the needed bytes, the
    bound with the operations of sol_ops, and the shares over device_ms and
    ms, none above 1.0; K1, K2 and the F-frame mode launched."""
    from texturefusion_torch.ops import cuda_kernels
    sol = load_tool("sol_report")
    cuda_kernels.reset_launch_counts()
    rows = sol.run(sol.sol_config(), "cuda", n=SOL_N, ops_fn=sol_ops,
                   log=lambda msg: log(f"[sol] {msg}"))
    torch.cuda.synchronize()
    launches = dict(cuda_kernels.LAUNCHES)
    _positive_times("sol", {r["kernel"]: r for r in rows})
    shares = [v for r in rows for v in r["frac_of_roofline"].values()]
    log(f"[sol] {len(rows)} rows, largest share {max(shares):.4f}; launches "
        f"{json.dumps(launches)}")
    if [r["kernel"] for r in rows] != list(sol.ROWS) or max(shares) > 1.0:
        raise AssertionError("[sol] rows out of order, or a share above 1.0")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[sol] a kernel was not launched: {launches}")
    return rows, launches


def phase_bench_multichip(cap=SCALING_CAP):
    """tools/bench_multichip.py on one card (a 1-shard mesh) and on
    N_SHARDS shards of it (their overhead, not scaling: the shards share
    its stream): the sharded TSDF step's steps/s (rows bit for bit against
    the one shard's), distributed BA's GN iterations/s, the full map
    cycle's steps/s (n_found, vertex counts and labels equal), and dense
    against Schur ms a GN iteration at K = 64-512 on both (Schur within
    BA_RTOL / BA_ATOL of dense at every K); a mesh of N_SHARDS cards raises
    where fewer exist."""
    bm = load_tool("bench_multichip")
    one = bm.make_bench_mesh("cuda", devices=1)
    shards = bm.make_bench_mesh("cuda", shards_on_one_card=N_SHARDS)
    if torch.cuda.device_count() < N_SHARDS:
        try:
            bm.make_bench_mesh("cuda", devices=N_SHARDS)
        except ValueError as e:
            log(f"[bench-multichip] --devices {N_SHARDS} on "
                f"{torch.cuda.device_count()} card(s) raises: {e}")
        else:
            raise AssertionError(f"[bench-multichip] a mesh of {N_SHARDS} cards did not raise")
    t1, tn = (bm.bench_sharded_tsdf(m, cap, n_iters=10) for m in (one, shards))
    same_rows = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        t1["batch"].gather(np.arange(cap)), tn["batch"].gather(np.arange(cap))))
    ba1, ban = (bm.bench_distributed_ba(m, n_iters=5) for m in (one, shards))
    f1, fn = (bm.bench_full_step(m, n_iters=5) for m in (one, shards))
    same_cycle = (f1["n_found"] == fn["n_found"]
                  and torch.equal(f1["vcount"].cpu(), fn["vcount"].cpu())
                  and torch.equal(f1["labels"].cpu(), fn["labels"].cpu()))
    scale = {f"{m.size}": bm.bench_ba_scale(m, rtol=BA_RTOL, atol=BA_ATOL) for m in (one, shards)}
    rates = {"tsdf_steps_s": [t1["steps_s"], tn["steps_s"]],
             "distributed_ba_gn_iters_s": [ba1, ban],
             "full_step_steps_s": [f1["steps_s"], fn["steps_s"]]}
    log(f"[bench-multichip] 1 card | {N_SHARDS} shards of it (overhead, not scaling): "
        f"{json.dumps(rates)}; sharded TSDF rows bit for bit: {same_rows}; full cycle "
        f"n_found={f1['n_found']} vertices={int(f1['vcount'].sum())}, the same over "
        f"{N_SHARDS} shards: {same_cycle}")
    for n, rows in scale.items():
        log(f"[bench-multichip] BA over {n} shard(s), ms a GN iteration (dense / schur; max "
            f"|schur - dense|): " + "; ".join(
                f"K={r['K']} E={r['E']}: {r['dense_ms_per_gn_iter']:.3f} / "
                f"{r['schur_ms_per_gn_iter']:.3f} ({r['schur_max_abs_diff']:.1e})" for r in rows))
    times = [v for pair in rates.values() for v in pair] + [
        r[k] for rows in scale.values() for r in rows
        for k in ("dense_ms_per_gn_iter", "schur_ms_per_gn_iter")]
    if not all(np.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"[bench-multichip] a rate not finite and positive: {times}")
    if not (same_rows and same_cycle):
        raise AssertionError("[bench-multichip] the shards changed the rows or the map cycle")
    return {"rates": rates, "ba_scale": scale}


def phase_stages():
    """tools/profile_stages.py at VGA on the card: every stage of the JAX
    script, in its order, with device_ms and device_ops."""
    ps = load_tool("profile_stages")
    r = ps.run("cuda", n=3, log=lambda msg: log(f"[stages] {msg}"))
    _positive_times("stages", r["stages"])
    if not (r["chunks"] > 0 and r["verts"] > 0 and r["tris"] > 0):
        raise AssertionError(f"[stages] nothing discovered or meshed: {r}")
    return r


def phase_frame_profile():
    """tools/profile_frame.py at VGA on the card: every line of the JAX
    script, in its order, the pinned copies beside the pageable ones."""
    pf = load_tool("profile_frame")
    r = pf.run("cuda", n=3, log=lambda msg: log(f"[frame-profile] {msg}"))
    _positive_times("frame-profile", r["lines"])
    if r["unique"] <= 0:
        raise AssertionError("[frame-profile] no chunk discovered")
    return r


def sol_report(rows, pipeline_launches, scaling, path) -> None:
    """[sol]'s rows with K1's, K2's and the F-frame mode's launches a frame
    of [pipeline] (K1 runs once a frame), written with [bench-multichip]'s
    rates to `path`."""
    sol = load_tool("sol_report")
    frames = pipeline_launches["bilateral"]
    for name, kernel in ((sol.ROWS[0], "tsdf_integrate"), (sol.ROWS[2], "tsdf_integrate_frames"),
                         (sol.ROWS[6], "bilateral")):
        next(r for r in rows if r["kernel"] == name)["calls_per_cycle"] = (
            pipeline_launches[kernel] / frames)
    sol.write_report(path, rows, scaling, "cuda")
    log(f"[sol] launches a frame of [pipeline]: "
        + json.dumps({r["kernel"]: r["calls_per_cycle"] for r in rows}))


def _one_shard_check(pipe) -> dict:
    """K2 and the F-frame mode on one shard's rows (shard 0, its active
    slots, local indices), on copies, against their plain versions: a
    keyframe's +1 pass and its local frames' depth-only pass."""
    from texturefusion_torch.ops import tsdf as tsdf_ops
    vol = pipe.volume
    part = vol.rows.parts[0]
    act = vol.active_slots()
    idx = torch.as_tensor(vol.mesh.local_row(act[vol.mesh.shard_of(act) == 0]),
                          device=part[0].device)
    st = next(s for _, s in sorted(pipe.kf_states.items()) if s.integrated and s.local_depths)
    pose = torch.as_tensor(st.integrated_pose, dtype=torch.float32, device="cuda")
    depth, quality = st.depth.to("cuda"), st.quality.to("cuda")
    rgb = st.rgb.to("cuda").float() / 255.0
    out = {}
    for mode in ("k2", "frames"):
        a = tsdf_ops.ChunkBatch(*(t.clone() for t in part[:4]))
        b = tsdf_ops.ChunkBatch(*(t.clone() for t in part[:4]))
        if mode == "k2":
            qa, ua = tsdf_ops.integrate_frame_fused(a, part[4], idx, None, depth, rgb, quality,
                                                    pose, 1.0, vol.intr, vol.cfg)
            qb, ub = tsdf_ops.integrate_frame_fused_plain(b, part[4], idx, None, depth, rgb,
                                                          quality, pose, 1.0, vol.intr, vol.cfg)
            ok = torch.equal(ua, ub) and torch.allclose(qa, qb, rtol=K2_Q_TOL[0],
                                                        atol=K2_Q_TOL[1])
        else:
            d = torch.stack([x.to("cuda") for x in st.local_depths])
            p = torch.as_tensor(np.stack([st.integrated_pose @ r for r in st.local_rel_poses]),
                                dtype=torch.float32, device="cuda")
            tsdf_ops.integrate_depths_batched(a, part[4], idx, None, d, p, 1.0, vol.intr, vol.cfg)
            tsdf_ops.integrate_depths_batched_plain(b, part[4], idx, None, d, p, 1.0, vol.intr,
                                                    vol.cfg)
            ok = True
        errs = {n: float((x[idx] - y[idx]).abs().max()) for n, x, y in zip(K2_ROW_TOL, a, b)}
        ok = ok and all(torch.allclose(x[idx], y[idx], rtol=K2_ROW_TOL[n][0],
                                       atol=K2_ROW_TOL[n][1]) for n, x, y in zip(K2_ROW_TOL, a, b))
        out[mode] = {"lanes": int(idx.numel()), "ok": bool(ok), "max_abs_err": errs}
    return out


def sharded_cycle_check(pipe, n_timed=20) -> dict:
    """After a textured run, one texture cycle over every meshed chunk
    through the pipeline's pool reader (sharded: the count columns and the
    projected rows gathered from their shards) and, from copies of the
    same state, texture_cycle_incremental on the pool assembled on one
    device: whether each output and the updated state agree bit for bit.
    The one-device cycle runs twice, and must repeat itself too. On the
    card, the reader alone at the cycle's shape (ms, host dispatch
    included): its two count columns, and its gather of the projected
    lanes beside the same gather from the assembled pool; and the
    cycle's per-keyframe moment sum beside index_add_'s."""
    from texturefusion_torch.ops import marching_cubes as mc
    from texturefusion_torch.texture import patch
    tm, mesher, dev = pipe.texture, pipe.mesher, pipe.texture.device
    newest = len(pipe.slam.keyframes) - 1
    meshed, nbr = mesher.chunk_adjacency_arrays()
    problem, slots, rmask, _ = tm.build_cycle(pipe.volume, meshed, nbr, pipe._tex_states(),
                                              newest, set(meshed.tolist()))
    rows = mesher.pool_rows
    pool = mc.MeshPool(*rows.gather(np.arange(rows.n_rows), device=dev))

    def state():
        return tuple(t.clone() for t in (tm._labels_dev, tm._stats_dev, tm._failed_dev))

    def one_device(st):
        return patch.texture_cycle_incremental(
            problem, torch.as_tensor(slots, device=dev), *st, torch.as_tensor(rmask, device=dev),
            pool.verts, pool.col_packed, pool.vcount, pool.tcount, tm.kf_stack.rgb_packed,
            tm.kf_stack.depth, torch.as_tensor(tm.kf_stack.poses, device=dev),
            max(newest - 1, 0), tm.intr, tm.cfg, tm.cfg.mrf_sweeps, tm.cfg.patch_project_budget)

    sharded, one, again = state(), state(), state()
    got = tm.run_cycle(problem, slots, rmask, newest, mesher.pool_reader(dev), sharded)
    want = one_device(one)
    same = {k: bool(torch.equal(a, b)) for k, a, b in zip(got._fields, got, want)}
    same.update({k: bool(torch.equal(a, b))
                 for k, a, b in zip(("labels", "stats", "failed"), sharded, one)})
    # the one-device cycle again: the program gives the same bits twice
    same["one_device_repeatable"] = all(
        torch.equal(a, b) for a, b in zip(tuple(want) + one, tuple(one_device(again)) + again))
    # the lanes the program gathers: the projected chunks' slots, then trash
    budget = tm.cfg.patch_project_budget
    n_proj = min(int(got.n_changed), budget)
    lanes = torch.full((budget,), rows.n_rows - 1, dtype=torch.int64, device=dev)
    lanes[:n_proj] = torch.as_tensor(slots, device=dev)[got.proj_rows[:n_proj]]
    out = {"exact": all(same.values()), "outputs": same, "meshed": len(meshed),
           "n_changed": int(got.n_changed), "projected": n_proj, "lanes": budget,
           "shards": rows.mesh.size}
    if dev.type == "cuda":
        reader = mesher.pool_reader(dev)
        # the cycle's per-keyframe moment sum as the program makes it, and
        # through index_add_ (atomics, not repeatable) on the same rows
        k = tm.kf_stack.poses.shape[0]
        labels, stats = one[0], one[1]
        seg_ok = (labels >= 0) & (pool.tcount > 0)
        seg_ok[-1] = False
        seg = torch.where(seg_ok, torch.clamp(labels, 0, k - 1), k).to(torch.int64)
        out["ms"] = {
            "columns": cuda_ms(lambda: mesher.pool_reader(dev), n=n_timed),
            "rows": cuda_ms(lambda: reader.rows(lanes), n=n_timed),
            "rows_one_device": cuda_ms(lambda: (pool.verts[lanes], pool.col_packed[lanes]),
                                       n=n_timed),
            "moment_sum": cuda_ms(lambda: patch._segment_sum(seg, stats, k + 1), n=n_timed),
            "moment_sum_index_add": cuda_ms(
                lambda: torch.zeros((k + 1, stats.shape[1]), device=dev).index_add_(0, seg, stats),
                n=n_timed)}
    return out


def phase_pipeline_sharded(frames, reference, textured):
    """TexturedPipeline on [pipeline]'s config and 120 frames with the TSDF
    rows, the mesh pool and BA's edges sharded over N_SHARDS shards (slot
    s on shard s % n): [pipeline]'s gates, ATE and map RMS within 0.5 mm
    of [pipeline]'s, resident chunks per shard within 10% of their mean;
    [pipeline-textured]'s texture gates and its export; one texture
    cycle through the sharded pool reader bit for bit against the same
    cycle on the pool assembled on one card (sharded_cycle_check);
    frames/s, the texture stages, the colour error and the share of
    chunks (by id) with [pipeline-textured]'s label, beside
    [pipeline-textured]'s (`textured`); K2 and F-frame launches per
    shard, the largest position difference to [pipeline], keyframe and
    loop-edge counts beside [pipeline]'s (and the first frame where their
    keyframe decisions part); K2 and the F-frame mode against their plain
    versions on one shard's rows."""
    from texturefusion_torch.ops import cuda_kernels
    from texturefusion_torch.utils.stopwatch import STOPWATCH
    _, poses, packed = frames
    mesh, where = _shards()
    config = _pipeline_config()
    STOPWATCH.reset()
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    pipe, loop, fin = run_pipeline(config, packed, "cuda", mesh=mesh, textured=True)
    launches = dict(cuda_kernels.LAUNCHES)
    shapes = dict(cuda_kernels.FRAME_SHAPES)
    k2_lanes = cuda_kernels.LANES["tsdf_integrate"] / max(launches["tsdf_integrate"], 1)
    name = "pipeline-sharded"
    scene = _bench_scene()
    m = _pipeline_report(name, pipe, loop, fin, scene, poses, launches, len(packed), shapes)
    cycle = sharded_cycle_check(pipe)
    _textured_report(name, pipe, scene, poses, m, textured, ref_name="pipeline-textured",
                     geometry=False)
    common = sorted(m["labels_by_id"].keys() & textured["labels_by_id"].keys())
    same_label = float(np.mean([m["labels_by_id"][c] == textured["labels_by_id"][c]
                                for c in common])) if common else 0.0
    stages = {k: (m["tex_stages"].get(k), textured["tex_stages"].get(k))
              for k in ("tex_device", "tex_fetch", "tex_host")}
    log(f"[{name}] texture beside [pipeline-textured] (seconds, calls): {json.dumps(stages)}; "
        f"texture {m['texture_s']:.3f} vs {textured['texture_s']:.3f} s, texture_final "
        f"{m['texture_final_s']:.3f} vs {textured['texture_final_s']:.3f} s; exported colour "
        f"median {m['colour_errors']['exported']['median']:.3f} vs "
        f"{textured['colour_errors']['exported']['median']:.3f} levels; chunks by id "
        f"{len(m['labels_by_id'])} vs {len(textured['labels_by_id'])}, common {len(common)}, "
        f"same label {same_label:.4f}; one cycle through the sharded reader: "
        f"{json.dumps(cycle)}")
    if not cycle["exact"]:
        raise AssertionError(f"[{name}] a texture cycle through the sharded pool differs from "
                             f"the one-device cycle: {cycle['outputs']}")
    vol = pipe.volume
    n = mesh.size
    act = vol.active_slots()
    resident = np.bincount(vol.mesh.shard_of(act), minlength=n)
    blocks = np.bincount(act // ((vol.cfg.capacity + 1) // n), minlength=n)
    k2 = [a + 2 * b for a, b in zip(vol.rows.per_shard("integrate_frame"),
                                    vol.rows.per_shard("reintegrate_frame"))]
    ff = vol.rows.per_shard("integrate_depths")
    pos_mm = float(np.abs(m["traj"][:, :3, 3] - reference["traj"][:, :3, 3]).max() * 1e3)
    part = next((i for i, (a, b) in enumerate(zip(m["kf_flags"], reference["kf_flags"]))
                 if a != b), None)
    check = _one_shard_check(pipe)
    pipe.close()
    # each launch takes one shard's lanes: K2 and the F-frame mode (F = 3,
    # the local-frame passes) alone at a shard's mean width and at n times it
    f_lanes = frame_shapes_summary(shapes)["local_mean_lanes"]
    widths = {"k2": (k2_lanes, lambda w: k2_width_times(w)),
              "frames_f3": (f_lanes, lambda w: frames_width_times(3, w, False)[:2])}
    alone = {k: {"shard_lanes": round(w, 1),
                 "shard_ms": [round(x, 5) for x in fn(max(int(round(w)), 1))],
                 "whole_lanes": round(w * n, 1),
                 "whole_ms": [round(x, 5) for x in fn(int(round(w * n)))]}
             for k, (w, fn) in widths.items()}
    note = ("each shard on its own card" if len(set(mesh.devices)) == n else
            "shards sharing one card run on one stream: not a scaling figure")
    log(f"[{name}] over {where} (capacity {vol.cfg.capacity}): frames/s {m['fps']:.3f} vs "
        f"[pipeline] {reference['fps']:.3f} ({note}); resident chunks per shard "
        f"{resident.tolist()} (contiguous blocks "
        f"would hold {blocks.tolist()}); K2 launches per shard {k2}, F-frame launches per "
        f"shard {ff}; remesh calls per shard {pipe.mesher.pool_rows.per_shard('remesh')}; "
        f"alone (warm, cold ms) at a shard's mean lanes and at {n}x them {json.dumps(alone)}")
    log(f"[{name}] beside [pipeline]: ate_mm {m['ate_mm']:.3f} vs {reference['ate_mm']:.3f}, "
        f"map_rms_mm {m['map_rms_mm']:.3f} vs {reference['map_rms_mm']:.3f}, keyframes "
        f"{m['keyframes']} vs {reference['keyframes']}, loop_edges {m['loop_edges']} vs "
        f"{reference['loop_edges']}, max position difference {pos_mm:.4f} mm, keyframe "
        f"decisions part at frame {part}; one shard's rows: {json.dumps(check)}")
    if not (sum(k2) == launches["tsdf_integrate"] and sum(ff) == launches["tsdf_integrate_frames"]
            and min(k2) > 0 and min(ff) > 0):
        raise AssertionError(f"[{name}] per-shard launches {k2} / {ff} do not add up to "
                             f"{launches} or a shard never launched")
    if not (abs(m["ate_mm"] - reference["ate_mm"]) <= SHARDED_MM
            and abs(m["map_rms_mm"] - reference["map_rms_mm"]) <= SHARDED_MM):
        raise AssertionError(f"[{name}] ATE or map RMS more than {SHARDED_MM} mm from "
                             "[pipeline]'s")
    if np.abs(resident - resident.mean()).max() > SHARD_BALANCE * resident.mean():
        raise AssertionError(f"[{name}] resident chunks per shard {resident.tolist()} not "
                             f"within {SHARD_BALANCE:.0%} of their mean")
    if not all(c["ok"] for c in check.values()):
        raise AssertionError(f"[{name}] a kernel disagrees with its plain version on one "
                             f"shard's rows: {check}")
    m["launches"] = launches
    return m


def phase_raycast(vol, frames, n_views=RAYCAST_VIEWS):
    """raycast_volume over [slice]'s volume at 8 of the loop's poses, each
    against the scene rendered there: hit share, median |depth - rendered
    depth| where both hold depth, unit normals; refine_depth_to_isosurface
    on one noisy input frame."""
    from texturefusion_torch.io import synthetic
    from texturefusion_torch.ops import raycast
    config, scene, poses, packed = frames
    res_m = config.tsdf.voxel_resolution
    views = np.linspace(0, len(poses) - 1, n_views).round().astype(int).tolist()
    raycast.raycast_volume(vol, poses[views[0]])            # loads the ops' kernels
    times, hits, meds, units = [], [], [], []
    for i in views:
        _sync("cuda")
        t0 = time.perf_counter()
        r = raycast.raycast_volume(vol, poses[i])
        _sync("cuda")
        times.append((time.perf_counter() - t0) * 1e3)
        gt, _ = synthetic.render_frame(scene, vol.intr,
                                       torch.as_tensor(poses[i], dtype=torch.float32,
                                                       device="cuda"))
        both = r.hit & (gt > 0)
        hits.append(float(r.hit.float().mean()))
        meds.append(float((r.depth - gt).abs()[both].median()))
        norm = torch.linalg.vector_norm(r.normals[r.hit], dim=-1)
        units.append(float(((norm - 1.0).abs() < 1e-3).float().mean()))
    i = views[len(views) // 2]
    depth_u16, _ = unpack_frame(packed[i])
    noisy = torch.as_tensor(depth_u16.astype(np.float32) / config.camera.depth_scale,
                            device="cuda")
    pose = torch.as_tensor(poses[i], dtype=torch.float32, device="cuda")
    table = vol._slot_table()
    refined = raycast.refine_depth_to_isosurface(vol.batch.sdf, vol.batch.weight, table.table,
                                                 table.lo, table.trash, noisy, pose, vol.intr,
                                                 config.tsdf)
    gt, _ = synthetic.render_frame(scene, vol.intr, pose)
    ok = (noisy > 0) & (gt > 0)
    before = float((noisy - gt).abs()[ok].median())
    after = float((refined - gt).abs()[ok].median())
    log(f"[raycast] {n_views} views {vol.intr.width}x{vol.intr.height} of the slice's volume "
        f"(frames {views}): ms a raycast {json.dumps([round(t, 3) for t in times])} (median "
        f"{float(np.median(times)):.3f}) hit_share min {min(hits):.4f} mean "
        f"{float(np.mean(hits)):.4f}; median |depth - rendered| max {max(meds) * 1e3:.3f} mm "
        f"(voxel {res_m * 1e3:.0f} mm); unit normals min {min(units):.4f}; refine at frame {i}: "
        f"median |depth - rendered| {before * 1e3:.3f} -> {after * 1e3:.3f} mm")
    if not (min(hits) > RAYCAST_HIT and max(meds) < res_m and min(units) >= RAYCAST_UNIT):
        raise AssertionError(f"[raycast] gates failed: hits {hits}, medians {meds}, unit {units}")
    if not after < before:
        raise AssertionError(f"[raycast] refinement did not move depth to the surface: "
                             f"{before} -> {after}")


def main() -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = phase_device()
    timed("build", phase_build)
    timed("sass", phase_sass)
    k1 = timed("k1", phase_k1)
    k2 = timed("k2", phase_k2)
    k2f = timed("k2-frames", phase_k2_frames)
    sol_rows, sol_launches = timed("sol", phase_sol)
    scaling = timed("bench-multichip", phase_bench_multichip)
    timed("stages", phase_stages)
    timed("frame-profile", phase_frame_profile)
    launches, k2_path, frames, slice_volume = timed("slice", phase_slice)
    timed("raycast", phase_raycast, slice_volume, frames)
    del slice_volume
    timed("small", phase_small)
    timed("profile", phase_profile, frames)
    tracked_launches, tracked_frames = timed("tracked", phase_tracked)
    timed("tracked-small", phase_tracked_small, tracked_frames)
    timed("profile-tracked", phase_profile_tracked, tracked_frames)
    runs = [timed("pipeline", phase_pipeline, tracked_frames)]
    k2f.update(timed("k2-frames-path", phase_k2_frames_path, runs[0]["frame_shapes"]))
    sol_report(sol_rows, runs[0]["launches"], scaling,
               os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                            "sol_report_h100.json"))
    k2f["max_abs_err"] = max(k2f["max_abs_err"], k2f["path_max_abs_err"])
    runs.append(timed("pipeline-async", phase_pipeline, tracked_frames, async_fusion=True,
                      reference=runs[0]))
    runs.append(timed("pipeline-stream", phase_pipeline, tracked_frames,
                      max_resident=runs[0]["active"] // 2, reference=runs[0]))
    runs.append(timed("pipeline-textured", phase_pipeline, tracked_frames, reference=runs[0],
                      textured=True))
    runs.append(timed("pipeline-deferred", phase_pipeline_deferred, tracked_frames, runs[0],
                      runs[3]))
    runs.append(timed("pipeline-bench", phase_pipeline_bench, tracked_frames, runs[0], runs[3]))
    timed("pipeline-small", phase_pipeline_small)
    timed("profile-pipeline", phase_profile_pipeline, tracked_frames)
    cli = [timed("cli-synthetic", phase_cli_synthetic),
           timed("cli-dataset", phase_cli_dataset, frames, runs[0]),
           timed("checkpoint", phase_checkpoint, tracked_frames, runs[0]),
           timed("fr1-proxy", phase_fr1_proxy),
           timed("demo", phase_demo)]
    timed("ba-sharded", phase_ba_sharded)
    cli.append(timed("multichip", phase_multichip))
    runs.append(timed("pipeline-sharded", phase_pipeline_sharded, tracked_frames, runs[0],
                      runs[3]))

    def total(key, *extra):
        return (sum(r["launches"][key] for r in runs) + sum(c[key] for c in cli)
                + sol_launches[key] + sum(extra))

    kernels = [
        {"name": "bilateral", "route": "cuda",
         "source": "texturefusion_torch/csrc/bilateral.cu",
         "replaces": "texturefusion_tpu/ops/pallas_kernels.py:71",
         "launches": total("bilateral", launches["bilateral"], tracked_launches["bilateral"]),
         **k1},
        {"name": "tsdf_integrate", "route": "cuda",
         "source": "texturefusion_torch/csrc/tsdf_integrate.cu",
         "replaces": "examples/pallas_voxel_kernel.py:230",
         "launches": total("tsdf_integrate", launches["tsdf_integrate"]), **k2, **k2_path},
        {"name": "tsdf_integrate_frames", "route": "cuda",
         "source": "texturefusion_torch/csrc/tsdf_integrate.cu",
         "replaces": "examples/pallas_voxel_kernel.py:230",
         "launches": total("tsdf_integrate_frames"), **k2f},
    ]
    log(f"[launches] per phase: slice {json.dumps(launches)}, tracked "
        f"{json.dumps(tracked_launches)}, pipeline / pipeline-async / pipeline-stream / "
        f"pipeline-textured / pipeline-deferred / pipeline-bench / pipeline-sharded "
        f"{json.dumps([r['launches'] for r in runs])}, cli-synthetic / cli-dataset / "
        f"checkpoint / fr1-proxy / demo / multichip {json.dumps(cli)}, sol "
        f"{json.dumps(sol_launches)}")
    log(f"[phase-seconds] {json.dumps(seconds)}")
    log(f"[total] chip_smoke.py ran in {time.perf_counter() - t_start:.1f} s, build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
