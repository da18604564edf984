"""The captured programs (utils/graphs.py): the tracker's two per-frame
programs, BA's round and the stale-frame refinement as one CUDA graph
each, checked on the CPU.

(a) Capture safety: each registered program's function at its cases
    (frame_step_tracked2, promote_probe with and without the tracked
    stats, BA's pruning and last rounds at GCSLAM's first buckets, the
    refinement's registration at the lite settings), every output equal
    to the unguarded call's under graphs.HostSyncGuard, the dispatch
    mode the capture runs under, which fails on any op that reads a
    tensor on the host (`_local_scalar_dense`, `is_nonzero`, `equal`),
    makes a tensor from
    host data (`lift_fresh`), copies between the host and the card, gives
    a shape that depends on the data (`nonzero`, `masked_select`,
    boolean-mask indexing, `unique*`), or solves with a host check
    (`linalg_svd`, `linalg_eigh`), except inside the plain versions of
    K1 and K3 (what the card runs as kernels). Each kind of op is shown
    to trip the guard.
(b) Outputs that outlive a call: `ReplayStandIn` replays as a graph does
    (every call's results written into the same output tensors) through
    the cache's real copies in and out. Under it, the pipelined tracker
    (depths 1-3, deferred promotion, stale-frame refinement, 16 orbit
    frames) takes the same keyframes, stale frames and adopted
    refinements, and gives the same poses bit for bit, as the direct run;
    at depth 2 every stale frame's refinement goes through the cache, one
    capture and then replays. On the card (cuda-marked) the refinement's
    replay gives the eager registration's stats bit for bit.
(c) The probe with device scalars against the JAX `promote_probe`, at
    test_torch_loopclosure.py's tolerances (same candidate slots and
    admission, stats 1e-4, edge sums rtol 1e-4, match indices on ≥ 99% of
    the slots), with 0, 1 and 6 rows in use, and in a DB of twice the
    capacity: a second program, equal results.
(d) The cache: a second static key captures a second program and a
    repeated key replays the first, and BA's rounds count `ba_capture`
    once per key and `ba_replay` at every later call; a function that
    fails, or that reads a tensor on the host, raises through the cache
    with the op named, is not cached and is never run eagerly in its place.
(e) The readers of the refinement's two per-layer metrics,
    stale_refine_ms and refine_replay_share: a value from the span and
    the counts, None without them.
(f) The registry (graphs.PROGRAMS): the four names, a taken one raises;
    the replay shares read `ba` and `refine`; every program counts
    `<name>_capture` and `<name>_replay`; clear_programs and program_count.

The JAX package (BA's graph from test_torch_fastba, the JAX side of
(c)) is imported where it is used, so that the cuda-marked case runs on
a machine without JAX: `PYTHONPATH=. python -m pytest
tests/test_torch_graphs.py --noconftest -m cuda`.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from tfbench import harness
from texturefusion_torch.config import tiny_test_config
from texturefusion_torch.core import camera as tcam
from texturefusion_torch.fusion.pipeline import ReconstructionPipeline
from texturefusion_torch.io import synthetic as tsyn
from texturefusion_torch.models import reconstruction as rec
from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.ops import preprocess as tpre
from texturefusion_torch.config import BAConfig
from texturefusion_torch.slam import fastba, gcslam
from texturefusion_torch.slam import loopclosure as tlc
from texturefusion_torch.slam import matching as tm
from texturefusion_torch.slam import promote as tpr
from texturefusion_torch.slam.features import extract_features
from texturefusion_torch.utils import graphs
from texturefusion_torch.utils.convert import keypoints_from_numpy
from texturefusion_torch.utils.stopwatch import STOPWATCH

torch.set_num_threads(2)

CFG = tiny_test_config()
TI = tcam.Intrinsics.from_config(CFG.camera)
FLOORS = (BAConfig.kf_bucket_floor, BAConfig.edge_bucket_floor)     # (32, 128)
SCALE = CFG.camera.depth_scale
N_CAND = 5


class ReplayStandIn(graphs.CapturedProgram):
    """A graph's replay on the CPU: the function runs on the program's own
    input tensors and writes its results into the same output tensors at
    every call, as a replay does; the cache's copies in and out are its
    own. `guarded` keeps HostSyncGuard around the capture-time call."""

    guarded = False

    def _capturing(self):
        return contextlib.nullcontext()

    def _guarding(self, guard):
        return guard if self.guarded else contextlib.nullcontext()

    def _replay(self):
        leaves = []
        graphs.flatten(self.fn(*self.args, **self.static), leaves)
        for dst, src in zip(self.outputs, leaves):
            dst.copy_(src)

    def _wait(self):
        pass

    def _record(self):
        pass


@pytest.fixture
def stand_in(monkeypatch):
    """CPU calls through the captured-program cache, replayed by ReplayStandIn."""
    monkeypatch.setattr(graphs, "CapturedProgram", ReplayStandIn)
    monkeypatch.setattr(graphs, "_captures", lambda device: True)
    graphs.clear_programs()
    yield ReplayStandIn
    graphs.clear_programs()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _packed(n_frames, seed=3):
    poses = tsyn.orbit_trajectory(n_frames)
    depths, rgbs = tsyn.render_sequence(tsyn.BoxRoomScene(), TI, poses, device="cpu")
    rng = np.random.default_rng(seed)
    out = []
    for d, c in zip(depths, rgbs):
        dn = np.where(d > 0, d + rng.normal(0, 0.004, d.shape) * np.maximum(d, 0.5), 0.0)
        out.append(tpre.pack_frame((dn * SCALE).astype(np.uint16), (c * 255).astype(np.uint8)))
    return poses, out


def _features(packed, device="cpu"):
    b = tpre.preprocess_bundle(torch.as_tensor(packed, device=device), None, TI,
                               depth_scale=SCALE)
    return b, extract_features(b[3], b[0], CFG.tracking, TI)


@pytest.fixture(scope="module")
def step_inputs():
    _, packed = _packed(6)
    b0, kp0 = _features(packed[0])
    _, kp1 = _features(packed[1])
    draws = rec.tracked_draws(7, 2, CFG.tracking, "cpu")
    return (torch.as_tensor(packed[2]), None, kp0, kp1, b0[0], (b0[0] > 0).to(torch.float32),
            draws)


@pytest.fixture(scope="module")
def probe_db(step_inputs):
    """A KeypointDB and descriptor DB of 4 keyframes (slots 0-3) and the
    query frame's keypoints."""
    _, packed = _packed(12)
    r_max = CFG.ba.max_keyframes
    db = tlc.KeyframeDescriptorDB(max_keyframes=r_max, device="cpu")
    kdb = tpr.KeypointDB(r_max, CFG.tracking.max_features_pad, "cpu")
    r2s = torch.full((r_max,), -1, dtype=torch.int64)
    for slot, f in enumerate((0, 3, 6, 9)):
        _, kp = _features(packed[f])
        db.add(slot, kp.desc, kp.valid)
        kdb.add(slot, kp)
        r2s[slot] = slot
    _, kq = _features(packed[11])
    gen = torch.Generator().manual_seed(11)
    draws = tm.ransac_draws(CFG.tracking, CFG.tracking.max_features_pad, gen, (N_CAND,))
    return db, kdb, r2s, kq, draws


# the probe's static arguments, as its program takes them
PROBE_STATICS = dict(salient_threshold=CFG.tracking.salient_score_threshold,
                     huber_delta=CFG.ba.huber_delta, cfg=CFG.tracking, intr=TI, n_cand=N_CAND)


def _probe_args(probe_db, n_rows=4, last_slot=3, have_tracked=False):
    """The probe's tensor arguments over `probe_db`."""
    db, kdb, r2s, kq, draws = probe_db
    return (kdb.kp, db.desc, db.valid, r2s, torch.tensor(n_rows), torch.tensor(last_slot), kq,
            torch.zeros(21), torch.tensor(have_tracked), draws)


# (a) ---------------------------------------------------------------------

class PlainExempt(graphs.HostSyncGuard):
    """HostSyncGuard that lets the plain versions of K1 and K3 (which the
    card runs as kernels) through: ops inside `exempt()` are not checked."""

    def __init__(self):
        super().__init__()
        self.depth = 0

    @contextlib.contextmanager
    def exempt(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.fixture
def guard(monkeypatch):
    """PlainExempt around kabsch_plain and bilateral_filter_plain."""
    g = PlainExempt()
    for module, name in ((tm, "kabsch_plain"), (tpre, "bilateral_filter_plain")):
        plain = getattr(module, name)

        def exempt(*args, _plain=plain, **kw):
            with g.exempt():
                return _plain(*args, **kw)

        monkeypatch.setattr(module, name, exempt)
    return g


@pytest.fixture(scope="module")
def ba_inputs():
    """test_torch_fastba's pose graph at GCSLAM's first buckets: poses,
    edges and active rows as torch tensors."""
    from test_torch_fastba import _both, _bucketed, _graph
    poses, edges, _, _ = _graph()
    return _both(*_bucketed(poses, edges, *FLOORS))[1]


def _refine_args(kp_ref, kp, generator):
    """A stale-frame refinement's arguments: the adopted keyframe's and
    the frame's keypoints, the lite draws, and the static ones."""
    lite = tm.lite_config(CFG.tracking)
    draws = tm.ransac_draws(lite, CFG.tracking.max_features_pad, generator)
    return (kp_ref, kp, draws), dict(cfg=lite, intr=TI)


# the cases of a registered program (name: cases) that each test runs, and
# what a case's eager result shows besides its equality: a registration
# that succeeded, a round that prunes or does not
PROGRAM_CASES = {"frame_step": ["frame_step"], "probe": ["probe", "probe_tracked"],
                 "ba": ["ba", "ba_last"], "refine": ["refine"]}
SHOWS = {"frame_step": lambda out: float(out[4][0]) == 1.0, "ba": lambda out: out[2] is not None,
         "ba_last": lambda out: out[2] is None, "refine": lambda out: float(out[0]) == 1.0}


def _program_inputs(request, case):
    """(tensor arguments, static arguments) of the call `case`."""
    step = request.getfixturevalue("step_inputs")
    ba = lambda prunes: (request.getfixturevalue("ba_inputs"),     # noqa: E731
                         dict(n_kf=FLOORS[0], cfg=BAConfig(), prunes=prunes))
    return {"frame_step": lambda: (step, dict(intr=TI, tcfg=CFG.tracking, depth_scale=SCALE)),
            "probe": lambda: (_probe_args(request.getfixturevalue("probe_db")), PROBE_STATICS),
            "probe_tracked": lambda: (_probe_args(request.getfixturevalue("probe_db"),
                                                  have_tracked=True), PROBE_STATICS),
            "ba": lambda: ba(True), "ba_last": lambda: ba(False),
            "refine": lambda: _refine_args(step[2], step[3], torch.Generator().manual_seed(9)),
            }[case]()


def _assert_same(got, want):
    lg, lw = [], []
    assert graphs.flatten(got, lg) == graphs.flatten(want, lw)
    for a, b in zip(lg, lw, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,case", [(n, c) for n, cs in PROGRAM_CASES.items() for c in cs])
def test_every_program_is_capture_safe(guard, request, name, case):
    args, statics = _program_inputs(request, case)
    fn = graphs.PROGRAMS[name].fn
    want = fn(*args, **statics)
    with guard:
        got = fn(*args, **statics)
    _assert_same(got, want)
    assert SHOWS.get(case, lambda out: True)(want)


@pytest.mark.parametrize("op", ["item", "bool", "nonzero", "masked_select", "bool_index",
                                "bool_setitem", "unique", "svd", "eigh", "from_host",
                                "repeat_interleave", "scalar_index"])
def test_guard_trips_on_each_kind(op):
    x = torch.arange(9, dtype=torch.float32).reshape(3, 3) + torch.eye(3) * 10
    ops = {"item": lambda: x.sum().item(), "bool": lambda: bool(x.sum() > 0),
           "nonzero": lambda: torch.nonzero(x > 3), "masked_select": lambda: x[x > 3].sum(),
           "bool_index": lambda: x[x.sum(1) > 20], "bool_setitem": lambda: x.clone().__setitem__(
               x > 3, x.sum()), "unique": lambda: torch.unique(x.round()),
           "svd": lambda: torch.linalg.svd(x), "eigh": lambda: torch.linalg.eigh(x + x.T),
           "from_host": lambda: torch.tensor([1.0, 2.0]) + x[0, :2],
           # BA's pin mask as it was spread over the six rows of a pose (the
           # tensor form, which torch versions that do not expand the int
           # form dispatch), and its median as it was picked from the
           # sorted errors
           "repeat_interleave": lambda: torch.repeat_interleave(
               x[0] > 3, torch.full_like(x[0], 6, dtype=torch.int64)),
           "scalar_index": lambda: x.reshape(-1)[torch.argmax(x)]}
    with pytest.raises(RuntimeError, match="host|data|solver"):
        with graphs.HostSyncGuard():
            ops[op]()


# (b) ---------------------------------------------------------------------

class TrackingOnly(ReconstructionPipeline):
    def fusion_cycle(self, finished_slot):
        pass


def _pipelined_run(config, packed):
    pipe = TrackingOnly(config, device="cpu")
    for i, frame in enumerate(packed):
        pipe.process_frame(frame, timestamp=float(i), host_packed=frame)
    pipe.flush_tracking()
    slam = pipe.slam
    return ([k.frame_index for k in slam.keyframes], list(slam.stale_frames),
            slam.refine_adopted, slam.promote_late, slam.trajectory(), slam.refine_dispatched)


@pytest.fixture(scope="module")
def orbit16():
    return _packed(16, seed=5)[1]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_tracker_through_the_cache(stand_in, orbit16, depth):
    config = CFG.replace(parallel=dataclasses.replace(CFG.parallel, pipelined_tracking=True,
                                                      pipeline_depth=depth))
    assert config.tracking.defer_promote and config.tracking.refine_stale
    graphed = _pipelined_run(config, orbit16)
    n_programs = (len(rec.FRAME_STEP_PROGRAMS.programs), len(tpr.PROBE_PROGRAMS.programs))
    replays = sum(p.replays for p in rec.FRAME_STEP_PROGRAMS.programs.values())
    with pytest.MonkeyPatch.context() as mp:      # the direct run: no cache at all
        mp.setattr(graphs, "_captures", lambda device: False)
        direct = _pipelined_run(config, orbit16)
    # the first depth + 1 frames are dispatched before the first keyframe is
    # adopted; the first tracked one runs eagerly and makes the program
    assert n_programs == (1, 1) and replays == len(orbit16) - 2 - depth
    assert len(graphed[0]) >= 3 and graphed[:4] == direct[:4]
    if depth >= 2:
        assert graphed[1], "no frame finalized against a superseded keyframe"
    np.testing.assert_array_equal(graphed[4], direct[4])


REFINE_COUNTS = ("refine_capture", "refine_replay", "stale_refine")


def test_every_stale_frame_refines_through_the_cache(stand_in, orbit16):
    """At depth 2 each stale frame's refinement is one call of
    REFINE_PROGRAMS inside the span `stale_refine`: the first makes the
    program (`refine_capture`), every later one replays it
    (`refine_replay`). Poses, stale frames and adopted refinements equal
    a run without the cache, which counts no capture and no replay."""
    config = CFG.replace(parallel=dataclasses.replace(CFG.parallel, pipelined_tracking=True,
                                                      pipeline_depth=2))

    def counted(run):
        before = {k: STOPWATCH.counts.get(k, 0) for k in REFINE_COUNTS}
        out = run()
        return out, {k: STOPWATCH.counts.get(k, 0) - before[k] for k in REFINE_COUNTS}

    graphed, n = counted(lambda: _pipelined_run(config, orbit16))
    with pytest.MonkeyPatch.context() as mp:      # the direct run: no cache at all
        mp.setattr(graphs, "_captures", lambda device: False)
        direct, n_direct = counted(lambda: _pipelined_run(config, orbit16))
    dispatched = graphed[5]
    assert dispatched == len(graphed[1]) >= 2
    assert n == {"refine_capture": 1, "refine_replay": dispatched - 1, "stale_refine": dispatched}
    assert n_direct == {"refine_capture": 0, "refine_replay": 0, "stale_refine": dispatched}
    assert len(gcslam.REFINE_PROGRAMS.programs) == 1
    assert graphed[1:3] == direct[1:3] and graphed[5] == direct[5]
    np.testing.assert_array_equal(graphed[4], direct[4])


@pytest.mark.cuda
def test_refine_replay_equals_eager_on_the_card(cuda_device):
    """On the card the refinement's program, replayed on three pairs of
    tiny orbit frames with draws of their own, gives the eager
    registration's stats bit for bit: one capture, then two replays."""
    cuda_kernels.build()
    _, packed = _packed(6)
    kps = [_features(p, cuda_device)[1] for p in packed[:3]]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    graphs.clear_programs()
    for ref, src in ((0, 1), (0, 2), (1, 2)):
        args, kw = _refine_args(kps[ref], kps[src], gen)
        want = gcslam._refine_program(*args, **kw)
        got = gcslam.REFINE_PROGRAMS(*args, **kw)
        assert got.device == want.device and torch.equal(got, want), (ref, src)
    progs = list(gcslam.REFINE_PROGRAMS.programs.values())
    assert len(progs) == 1 and progs[0].replays == 2
    graphs.clear_programs()


# (c) ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    """test_torch_loopclosure's keyframes: the loop of 12 frames, 6 keyframes."""
    import jax.numpy as jnp
    from texturefusion_tpu.io import synthetic as jsyn
    from texturefusion_tpu.ops import preprocess as jpre
    from texturefusion_tpu.slam import features as jf
    jcfg, JI = _jax_config()
    poses = jsyn.loop_trajectory(12, radius=0.6)
    depths, rgbs = jsyn.render_sequence(jsyn.BoxRoomScene(), JI, poses)
    jkp = [jf.extract_features(jpre.rgb_to_gray(jnp.asarray(c)) * 255.0, jnp.asarray(d),
                               jcfg.tracking, JI) for d, c in zip(depths, rgbs)]
    return jkp, [keypoints_from_numpy(k, "cpu") for k in jkp]


def _jax_config():
    """The JAX package's tiny config and its intrinsics."""
    from texturefusion_tpu.config import tiny_test_config as jax_tiny_config
    from texturefusion_tpu.core import camera as jcam
    jcfg = jax_tiny_config()
    return jcfg, jcam.Intrinsics.from_config(jcfg.camera)


def _dbs(jax_state, n_rows, capacity):
    from texturefusion_tpu.slam import loopclosure as jlc
    from texturefusion_tpu.slam import promote as jpr
    jkp, tkp = jax_state
    jdb = jlc.KeyframeDescriptorDB(max_keyframes=capacity)
    tdb = tlc.KeyframeDescriptorDB(max_keyframes=capacity, device="cpu")
    jkdb = jpr.KeypointDB(capacity, CFG.tracking.max_features_pad)
    tkdb = tpr.KeypointDB(capacity, CFG.tracking.max_features_pad, "cpu")
    for slot, f in enumerate((0, 2, 4, 6, 8, 10)[:n_rows]):
        jdb.add(slot, jkp[f].desc, jkp[f].valid)
        tdb.add(slot, tkp[f].desc, tkp[f].valid)
        jkdb.add(slot, jkp[f])
        tkdb.add(slot, tkp[f])
    return jdb, tdb, jkdb, tkdb


@pytest.mark.parametrize("n_rows,capacity", [(6, 8), (6, 16), (1, 8), (0, 8)])
def test_probe_with_device_scalars_matches_jax(stand_in, jax_state, n_rows, capacity):
    import jax
    import jax.numpy as jnp
    from test_torch_draws import batch_draws
    from texturefusion_tpu.slam import promote as jpr
    jcfg, JI = _jax_config()
    jkp, tkp = jax_state
    jdb, tdb, jkdb, tkdb = _dbs(jax_state, n_rows, capacity)
    last_slot = max(n_rows - 1, 0)
    r2s = np.full(capacity, -1, np.int32)
    r2s[:n_rows] = np.arange(n_rows)
    key = jax.random.PRNGKey(11)
    jp = jpr.promote_probe(jkdb.kp, jdb.desc, jdb.valid, jnp.asarray(r2s), jnp.int32(n_rows),
                           jnp.int32(last_slot), jkp[11], jnp.zeros(21), jnp.asarray(False),
                           key, CFG.tracking.salient_score_threshold, CFG.ba.huber_delta,
                           jcfg.tracking, JI, N_CAND)
    targs = (tkdb.kp, tdb.desc, tdb.valid, torch.as_tensor(r2s).long(), torch.tensor(n_rows),
             torch.tensor(last_slot), tkp[11], torch.zeros(21), torch.tensor(False),
             batch_draws(key, N_CAND, CFG.tracking, CFG.tracking.max_features_pad))
    first = tpr.PROBE_PROGRAMS(*targs, **PROBE_STATICS)     # eager; makes the program
    tp = tpr.PROBE_PROGRAMS(*targs, **PROBE_STATICS)        # the replay
    assert all(torch.equal(a, b) for a, b in zip(tp, first))
    np.testing.assert_array_equal(tp.cand_slots.numpy(), np.asarray(jp.cand_slots))
    np.testing.assert_array_equal(tp.cand_ok.numpy(), np.asarray(jp.cand_ok))
    if n_rows == 6:
        assert tp.cand_ok[1:].any()                  # a loop-closure candidate is admitted
    np.testing.assert_allclose(tp.stats.numpy(), np.asarray(jp.stats), atol=1e-4, rtol=1e-4)
    for name in ("s_w", "s_p", "s_q", "s_pp", "s_qq", "s_pq"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert (tp.midx.numpy() == np.asarray(jp.midx)).mean() >= 0.99
    np.testing.assert_allclose(tp.fetch.numpy(), np.asarray(jp.fetch), atol=1e-4, rtol=1e-4)
    assert len(tpr.PROBE_PROGRAMS.programs) == 1


def test_a_grown_db_is_a_second_program(stand_in, jax_state):
    outs = []
    for capacity in (8, 16):
        _, tdb, _, tkdb = _dbs(jax_state, 6, capacity)
        r2s = torch.full((capacity,), -1, dtype=torch.int64)
        r2s[:6] = torch.arange(6)
        draws = tm.ransac_draws(CFG.tracking, CFG.tracking.max_features_pad,
                                torch.Generator().manual_seed(2), (N_CAND,))
        outs.append(tpr.PROBE_PROGRAMS(
            tkdb.kp, tdb.desc, tdb.valid, r2s, torch.tensor(6), torch.tensor(5),
            jax_state[1][11], torch.zeros(21), torch.tensor(False), draws, **PROBE_STATICS))
    assert len(tpr.PROBE_PROGRAMS.programs) == 2
    assert torch.equal(outs[0].fetch, outs[1].fetch)     # unused rows change nothing


# (d) ---------------------------------------------------------------------

def test_cache_keys_and_replays(stand_in, step_inputs):
    """A repeated key replays (its results equal eager's:
    test_every_program_counts_its_captures_and_replays); a depth plane and
    another depth scale are keys of their own; every result is fresh."""
    packed, rgb, kp0, kp1, kf_depth, kf_weight, draws = step_inputs
    statics = dict(intr=TI, tcfg=CFG.tracking, depth_scale=SCALE)
    for _ in range(2):
        got = rec.FRAME_STEP_PROGRAMS(*step_inputs, **statics)
    assert len(rec.FRAME_STEP_PROGRAMS.programs) == 1
    # a depth plane is another key, and so is another depth scale
    depth = (packed[..., 0].to(torch.float32) + packed[..., 1].to(torch.float32) * 256.0)
    rgb_f = packed[..., 2:5].to(torch.float32) / 255.0
    rec.FRAME_STEP_PROGRAMS(depth, rgb_f, kp0, kp1, kf_depth, kf_weight, draws, **statics)
    rec.FRAME_STEP_PROGRAMS(packed, rgb, kp0, kp1, kf_depth, kf_weight, draws,
                            **dict(statics, depth_scale=SCALE * 2))
    progs = list(rec.FRAME_STEP_PROGRAMS.programs.values())
    assert len(progs) == 3 and [p.replays for p in progs] == [1, 0, 0]
    # outputs are fresh tensors: no call returns a buffer of the program
    outs = {t.data_ptr() for p in progs for t in p.outputs}
    assert not outs & {t.data_ptr() for t in got[4:]}


def test_ba_rounds_count_captures_and_replays(stand_in, ba_inputs):
    """Two BAs of three rounds at one bucket: the first round (pruning) and
    the last (not pruning) are two keys, captured once each; every other
    round is a replay, and computes what the direct rounds compute. A
    second bucket captures its two again."""
    poses, edges, active = ba_inputs
    cfg = BAConfig()
    before = STOPWATCH.counts.copy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "_captures", lambda device: False)
        want = fastba.optimize(poses, edges, FLOORS[0], active, cfg)
    assert (STOPWATCH.counts["ba_capture"], STOPWATCH.counts["ba_replay"]) == (
        before["ba_capture"], before["ba_replay"])
    for _ in range(2):
        got = fastba.optimize(poses, edges, FLOORS[0], active, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert torch.equal(got[1].valid, want[1].valid)
    assert len(fastba.BA_ROUND_PROGRAMS.programs) == 2
    assert STOPWATCH.counts["ba_capture"] - before["ba_capture"] == 2
    assert STOPWATCH.counts["ba_replay"] - before["ba_replay"] == 4
    wider = fastba.EdgeSums(*(torch.cat([a, torch.zeros_like(a)]) for a in edges))
    fastba.optimize(poses, wider, FLOORS[0], active, cfg)
    assert len(fastba.BA_ROUND_PROGRAMS.programs) == 4
    assert STOPWATCH.counts["ba_capture"] - before["ba_capture"] == 4
    assert STOPWATCH.counts["ba_replay"] - before["ba_replay"] == 5


@pytest.mark.parametrize("failure", ["raises", "host_read"])
def test_cache_does_not_hide_a_failure(stand_in, monkeypatch, failure):
    """A function that fails raises its own error (at the first, eager
    call); one that reads a tensor on the host runs that call, but its
    capture raises, naming the op."""
    monkeypatch.setattr(ReplayStandIn, "guarded", True)
    calls = []

    def fn(x, *, scale):
        calls.append(scale)
        if failure == "raises":
            raise ValueError("the function failed")
        return x * float(x.sum())                # a host read: refused by the guard

    cache = graphs.GraphCache(fn, "failing")
    x = torch.ones(4)
    for _ in range(2):
        if failure == "raises":
            with pytest.raises(ValueError, match="the function failed"):
                cache(x, scale=2.0)
        else:
            with pytest.raises(RuntimeError, match="failing: the CUDA graph capture failed at "
                                                   "aten._local_scalar_dense"):
                cache(x, scale=2.0)
    assert not cache.programs
    # one call (the eager first) or two (and the capture) an attempt; no eager fallback
    assert len(calls) == (2 if failure == "raises" else 4)


# (e) ---------------------------------------------------------------------

def _run(totals=None, counts=None):
    return harness.Run(seed=1, setup_s=1.0, window_s=1.0, sessions=[],
                       stopwatch_totals=totals or {}, stopwatch_counts=counts or {})


@pytest.mark.parametrize("totals,counts,want", [
    ({"stale_refine": 0.06, "update_frame": 3.0}, {"stale_refine": 30, "update_frame": 90}, 2.0),
    ({"update_frame": 3.0}, {"update_frame": 90, "refine_replay": 29}, None), ({}, {}, None)])
def test_stale_refine_ms_reads_the_span(totals, counts, want):
    """Host ms a stale frame's refinement; None from a program without the
    span `stale_refine`, as the parent of the captured refinement."""
    got = harness.load_reader("stale_refine_ms").read(_run(totals, counts))
    assert got is None if want is None else got == pytest.approx(want)


@pytest.mark.parametrize("counts,want", [({}, None), ({"stale_refine": 12}, None),
                                         ({"refine_capture": 1, "refine_replay": 55}, 55 / 56),
                                         ({"refine_capture": 2}, 0.0)])
def test_refine_replay_share_reads_the_counts(counts, want):
    """The share of refinements replayed; None from a program that counts
    no captured refinement."""
    got = harness.load_reader("refine_replay_share").read(_run(counts=counts))
    assert got is None if want is None else got == pytest.approx(want)


# (f) ---------------------------------------------------------------------

def test_the_registry_holds_the_four_programs():
    assert graphs.PROGRAMS == {"frame_step": rec.FRAME_STEP_PROGRAMS, "probe": tpr.PROBE_PROGRAMS,
                               "ba": fastba.BA_ROUND_PROGRAMS, "refine": gcslam.REFINE_PROGRAMS}
    assert all(cache.name == name for name, cache in graphs.PROGRAMS.items())
    assert set(PROGRAM_CASES) == set(graphs.PROGRAMS)
    with pytest.raises(ValueError, match="'ba' is declared already"):
        graphs.program("ba", fastba._round_program)
    assert graphs.PROGRAMS["ba"] is fastba.BA_ROUND_PROGRAMS


@pytest.mark.parametrize("name,reader", [("ba", "ba_replay_share"),
                                         ("refine", "refine_replay_share")])
def test_the_replay_shares_read_a_registered_program(name, reader):
    counts = {name + "_capture": 1, name + "_replay": 3}
    assert name in graphs.PROGRAMS
    assert harness.load_reader(reader).read(_run(counts=counts)) == pytest.approx(0.75)


@pytest.mark.parametrize("name", sorted(graphs.PROGRAMS))
def test_every_program_counts_its_captures_and_replays(stand_in, request, name):
    """The first call is the span `<name>_capture`, each later one a
    `<name>_replay`; every call gives the eager result."""
    prog, (args, statics) = graphs.PROGRAMS[name], _program_inputs(request, name)
    keys = (name + "_capture", name + "_replay")
    before, timed = [STOPWATCH.counts.get(k, 0) for k in keys], STOPWATCH.totals.get(keys[0], 0)
    want = prog.fn(*args, **statics)
    for n in range(3):
        _assert_same(prog(*args, **statics), want)
        assert [STOPWATCH.counts.get(k, 0) - b for k, b in zip(keys, before)] == [1, n]
    assert len(prog.programs) == 1 and STOPWATCH.totals[keys[0]] > timed
    assert keys[1] not in STOPWATCH.totals


def test_clear_programs_empties_the_registry(stand_in, request):
    for name in graphs.PROGRAMS:
        args, statics = _program_inputs(request, name)
        graphs.PROGRAMS[name](*args, **statics)
    args, statics = _program_inputs(request, "ba_last")
    fastba.BA_ROUND_PROGRAMS(*args, **statics)
    assert {n: len(p.programs) for n, p in graphs.PROGRAMS.items()} == {
        "frame_step": 1, "probe": 1, "ba": 2, "refine": 1}
    assert graphs.program_count() == 5
    graphs.clear_programs()
    assert graphs.program_count() == 0 and not any(p.programs for p in graphs.PROGRAMS.values())
