"""The port's span recorder (texturefusion_torch/utils/stopwatch.py) and
what is read of it: the per-layer readers ba_round_ms,
tracking_offcpu_ms and ba_replay_share, and tfbench/spanlog.py, which puts the span log on
the device trace's clock.

`tests/data/torch_trace_h100.json` is `record()` run on an NVIDIA H100
80GB HBM3 (torch 2.11): the profile's host rows (`spanlog.host_rows`: the
"tf." ranges and the CUDA runtime's launches) and the span log. On a
card, `python -m pytest tests/test_torch_tracing.py --noconftest -q -m
cuda` checks a fresh recording the same way; to write one:
`PYTHONPATH=. python -c "import json, sys; sys.path.insert(0, 'tests');
import test_torch_tracing as t; json.dump(t.record(), open('x.json', 'w'))"`.
"""

import concurrent.futures
import json
import os
import re
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfbench import harness, spanlog, trace
from texturefusion_torch.utils import stopwatch as sw_mod
from texturefusion_torch.utils.stopwatch import STOPWATCH, Span, Stopwatch

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_trace_h100.json")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reader(name):
    return harness.load_reader(name, here=os.path.join(ROOT, "tfbench"))


# ------------------------------------------------------------ aggregates


def test_aggregates_and_report_for_a_fixed_sequence(monkeypatch):
    """A fixed span sequence on fixed clocks gives the aggregates and the
    report lines the stopwatch has always given (the format
    chip_smoke.cli_run_stats parses), with or without ids, and a span's
    `aggregate` renamed inside its block adds there."""
    wall = iter(range(0, 10**12, 10**6))            # each read 1 ms after the last
    cpu = iter(range(0, 10**12, 5 * 10**5))         # 0.5 ms
    monkeypatch.setattr(sw_mod, "_wall", lambda: next(wall))
    monkeypatch.setattr(sw_mod, "_cpu", lambda: next(cpu))
    sw = Stopwatch()
    with sw.time("cpp_ba"):
        pass
    with sw.time("cpp_ba", frame=4):
        with sw.time("ba_gn_round"):
            pass
    with sw.time("update_frame", frame=5) as span:
        span.aggregate = "promotion"
    sw.count("tex_skipped")
    sw.count("tex_skipped", 2)
    assert dict(sw.counts) == {"cpp_ba": 2, "ba_gn_round": 1, "promotion": 1, "tex_skipped": 3}
    assert sw.totals["cpp_ba"] == pytest.approx(0.004)     # 1 ms, then 3 ms around a child
    assert sw.totals["ba_gn_round"] == pytest.approx(0.001)
    assert sw.totals_cpu["cpp_ba"] == pytest.approx(0.002)
    assert "update_frame" not in sw.totals
    assert sw.averages_ms() == pytest.approx({"cpp_ba": 2.0, "ba_gn_round": 1.0, "promotion": 1.0})
    assert sw.report().splitlines() == [
        "     ba_gn_round:     1.00 ms avg (cpu    0.50) (1x)",
        "          cpp_ba:     2.00 ms avg (cpu    1.00) (2x)",
        "       promotion:     1.00 ms avg (cpu    0.50) (1x)",
        "     tex_skipped: 3 events"]
    sw.reset()
    assert not sw.totals and not sw.counts and not sw.totals_cpu and sw.report() == ""


def test_offcpu_adds_a_span_time_off_the_cpu_as_an_aggregate(monkeypatch):
    """`offcpu=True` adds wall less thread CPU time to name + "_offcpu",
    which the benchmark reads through `totals` and `counts`; it is no id."""
    wall = iter(range(0, 10**12, 10**6))            # 1 ms a read
    cpu = iter(range(0, 10**12, 2 * 10**5))         # 0.2 ms
    monkeypatch.setattr(sw_mod, "_wall", lambda: next(wall))
    monkeypatch.setattr(sw_mod, "_cpu", lambda: next(cpu))
    sw = Stopwatch()
    sw.start_recording()
    for k in (3, 4):
        with sw.time("frame", offcpu=True, frame=k):
            pass
    with sw.time("preprocess"):
        pass
    spans = sw.stop_recording()
    assert [s.ids for s in spans] == [{"frame": 3}, {"frame": 4}, {}]
    assert dict(sw.counts) == {"frame": 2, "frame_offcpu": 2, "preprocess": 1}
    assert sw.totals["frame_offcpu"] == pytest.approx(2 * 0.0008)
    assert sw.totals["frame"] == pytest.approx(0.002)
    assert "    frame_offcpu:     0.80 ms avg (cpu    0.00) (2x)" in sw.report().splitlines()


def test_the_stopwatch_keeps_no_tick_tock_and_no_slow_log():
    src = open(sw_mod.__file__).read()
    assert not hasattr(Stopwatch, "tick") and not hasattr(Stopwatch, "tock")
    assert "TF_SLOW_LOG" not in src and "environ" not in src


def test_the_port_writes_no_counter_directly():
    """Every counter goes through the locked count()."""
    pkg = os.path.join(ROOT, "texturefusion_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(base, f)).read()
                assert not re.search(r"STOPWATCH\.(counts|totals)\[[^\]]*\]\s*\+?=", text), f


@pytest.mark.parametrize("kind", ["count", "time"])
def test_counts_stay_exact_under_two_hammering_threads(kind):
    sw = Stopwatch()
    n = 20000

    def hammer():
        for _ in range(n):
            if kind == "count":
                sw.count("hits")
            else:
                with sw.time("hits"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sw.counts["hits"] == 2 * n


# ------------------------------------------------------------ the span log


def _worker():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="fusion")
    pool.submit(lambda: None).result()          # the thread exists before any recording
    return pool


def test_the_log_holds_parents_threads_and_ids():
    sw = Stopwatch()
    pool = _worker()
    try:
        def cycle():
            with sw.time("fusion_cycle", kf=2, cause=7):
                with sw.time("texture"):
                    time.sleep(0.001)
            return threading.get_native_id(), threading.get_ident()

        sw.start_recording()
        with sw.time("frame", frame=9):
            with sw.time("update_frame", frame=7) as span:
                with sw.time("ba_gn_round"):
                    worker = pool.submit(cycle).result(timeout=60)
                span.aggregate = "promotion"
            with sw.time("device_wait"):
                pass
        spans = sw.stop_recording()
    finally:
        pool.shutdown(wait=True)
    got = [(s.name, s.thread, s.parent, s.ids) for s in spans]
    assert got == [("frame", "MainThread", -1, {"frame": 9}),
                   ("update_frame", "MainThread", 0, {"frame": 7}),
                   ("ba_gn_round", "MainThread", 1, {"frame": 7}),
                   ("fusion_cycle", "fusion_0", -1, {"kf": 2, "cause": 7}),
                   ("texture", "fusion_0", 3, {"kf": 2, "cause": 7}),
                   ("device_wait", "MainThread", 0, {"frame": 9})]
    assert all(s.t0 <= s.t1 and s.cpu is not None and s.cpu >= 0 for s in spans)
    assert spans[0].t0 <= spans[2].t0 <= spans[3].t0 <= spans[4].t1 <= spans[2].t1
    assert (spans[3].tid, spans[3].ident) == worker
    assert spans[0].tid == threading.get_native_id()
    assert sw.counts["promotion"] == 1 and "update_frame" not in sw.counts
    assert sw.stop_recording() == []                 # a new log each recording


def test_the_log_is_bounded_and_a_span_open_at_the_stop_stays_open():
    sw = Stopwatch()
    sw.start_recording(capacity=3)
    for _ in range(5):
        with sw.time("x"):
            pass
    with sw.time("open"):
        assert len(sw.stop_recording()) == 3 and sw.dropped == 3
    sw.start_recording()
    with sw.time("late"):
        pass
    spans = sw.stop_recording()
    assert [(s.name, s.parent) for s in spans] == [("late", -1)]
    assert sw.counts["x"] == 5 and sw.counts["open"] == 1


def test_no_log_and_no_range_while_recording_is_off(monkeypatch):
    sw = Stopwatch()
    calls = []
    monkeypatch.setattr(sw, "_open", lambda timed: calls.append(timed.name))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with sw.time("frame", frame=1):
            torch.ones(4).add_(1)
    assert calls == [] and sw.stop_recording() == []
    assert not [e for e in prof.events() if e.name.startswith(sw_mod.SPAN_PREFIX)]
    assert sw.counts["frame"] == 1


def test_ranges_enter_the_profile_on_the_recording_thread_only():
    sw = Stopwatch()
    pool = _worker()
    entered = []
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sw.start_recording()
            real = sw._record_function

            def counting(name):
                entered.append((name, threading.current_thread().name))
                return real(name)

            sw._record_function = counting
            with sw.time("frame", frame=0):
                with sw.time("ba_gn_round"):
                    torch.ones(8).mul_(2)
                pool.submit(_span, sw, "texture").result(timeout=60)
            spans = sw.stop_recording()
    finally:
        pool.shutdown(wait=True)
    assert entered == [("tf.frame", "MainThread"), ("tf.ba_gn_round", "MainThread")]
    names = [e.name for e in prof.events() if e.name.startswith("tf.")]
    assert sorted(names) == ["tf.ba_gn_round", "tf.frame"]
    assert [s.name for s in spans] == ["frame", "ba_gn_round", "texture"]
    rows = spanlog.host_rows(prof)
    ranges = [r for r in rows if r[0].startswith("tf.")]
    assert {r[1] for r in ranges} == {threading.get_native_id()}


def _span(sw, name):
    with sw.time(name):
        pass


def test_the_clock_fit_maps_a_worker_span_on_a_cpu_profile():
    """A worker thread started before the profile: its span is not in
    the trace, and the fit of the recording thread's ranges puts it
    inside the range it ran in."""
    pool = _worker()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            STOPWATCH.start_recording()
            try:
                for k in range(6):
                    with STOPWATCH.time("frame", frame=k):
                        with STOPWATCH.time("ba_gn_round"):
                            pool.submit(_cycle_on_cpu, k).result(timeout=60)
                            torch.ones(16).add_(k)
                        time.sleep(0.002)
            finally:
                spans = STOPWATCH.stop_recording()
    finally:
        pool.shutdown(wait=True)
    rows = spanlog.host_rows(prof)
    assert not [r for r in rows if r[0] == "tf.fusion_cycle"]
    keys = spanlog.span_keys(rows, spans, [])
    clock = keys["clock"]
    assert clock["anchors"] == 12
    slack = clock["residual_us"] + 1.0
    rounds = [s for s in keys["spans"] if s["name"] == "ba_gn_round"]
    cycles = [s for s in keys["spans"] if s["name"] == "fusion_cycle"]
    assert len(rounds) == len(cycles) == 6
    for r, c in zip(rounds, cycles):
        assert r["start"] - slack <= c["start"] < c["end"] <= r["end"] + slack
        assert c["ids"]["kf"] == r["ids"]["frame"] and c["thread"] == "fusion_0"


def _cycle_on_cpu(k):
    with STOPWATCH.time("fusion_cycle", kf=k, cause=k):
        time.sleep(0.001)


# ------------------------------------------------------------ the card's profile


def record(n: int = 4) -> dict:
    """On a card: `n` frames, each a `ba_gn_round` with three matmuls and
    a CUDA graph replay on the recording thread, during which a fusion
    thread started before the profile runs a `fusion_cycle` > `texture`
    (four matmuls and a subtraction on its own stream), then a
    `device_wait` and 2 ms of sleep; the profile's host rows of the "tf."
    ranges and launches, the span log and both threads' ids."""
    x = torch.randn(256, 256, device="cuda")
    graph = torch.cuda.CUDAGraph()
    warm = torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        x * 2 + 1
    torch.cuda.current_stream().wait_stream(warm)
    with torch.cuda.graph(graph):
        x * 2 + 1
    torch.cuda.synchronize()
    pool = _worker()
    side = torch.cuda.Stream()

    def cycle(k):
        with STOPWATCH.time("fusion_cycle", kf=k, cause=10 * k):
            with torch.cuda.stream(side):
                with STOPWATCH.time("texture"):
                    for _ in range(4):
                        z = x @ x
                    z.sub_(1)
                side.synchronize()
        return threading.get_native_id(), threading.get_ident()

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            STOPWATCH.start_recording()
            try:
                for k in range(n):
                    with STOPWATCH.time("frame", frame=k):
                        with STOPWATCH.time("ba_gn_round"):
                            job = pool.submit(cycle, k)
                            for _ in range(3):
                                x @ x
                            graph.replay()
                            worker = job.result(timeout=60)
                        with STOPWATCH.time("device_wait"):
                            torch.cuda.synchronize()
                        time.sleep(0.002)
            finally:
                spans = STOPWATCH.stop_recording()
    finally:
        pool.shutdown(wait=True)
    rows = [r for r in spanlog.host_rows(prof)
            if r[0].startswith(spanlog.SPAN_PREFIX) or r[0] in spanlog.LAUNCHES]
    return {"meta": {"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
                     "threads": {"main": [threading.get_native_id(), threading.get_ident()],
                                 "worker": list(worker)}},
            "rows": rows, "spans": [{k: getattr(sp, k) for k in Span.__slots__} for sp in spans]}


def _fixture(d=None):
    if d is None:
        with open(FIXTURE) as f:
            d = json.load(f)
    spans = []
    for s in d["spans"]:
        sp = Span(s["name"], s["thread"], s["tid"], s["ident"], s["parent"], s["ids"])
        sp.t0, sp.t1, sp.cpu = s["t0"], s["t1"], s["cpu"]
        spans.append(sp)
    return d, [tuple(r) for r in d["rows"]], spans


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUPTI traces the CUDA runtime's calls there only)")
    return torch.device("cuda")


def test_a_card_profile_numbers_ranges_and_launches_alike():
    """On the card, kineto gives the recording thread's ranges and its
    runtime launches the same thread id (its system id), and the launches
    of a thread started before the profile the low 32 bits of its
    pthread id: so the launches inside a BA round on the tracking thread
    are told from the fusion thread's made meanwhile."""
    check_card_profile(*_fixture())


@pytest.mark.cuda
def test_a_fresh_card_profile_numbers_ranges_and_launches_alike(cuda_device):
    check_card_profile(*_fixture(json.loads(json.dumps(record()))))


def check_card_profile(d, rows, spans):
    main, worker = d["meta"]["threads"]["main"], d["meta"]["threads"]["worker"]
    ranges = {r[1] for r in rows if r[0].startswith("tf.")}
    launch_tids = {r[1] & 0xFFFFFFFF for r in rows if r[0] in spanlog.LAUNCHES}
    assert ranges == {main[0]}
    assert launch_tids == {main[0], worker[1] & 0xFFFFFFFF}
    keys = spanlog.span_keys(rows, spans, [])
    assert keys["threads"] == {"MainThread": [main[0], main[1] & 0xFFFFFFFF],
                               "fusion_0": [worker[0], worker[1] & 0xFFFFFFFF]}
    assert keys["clock"]["anchors"] == 12
    rounds = [s for s in keys["spans"] if s["name"] == "ba_gn_round"]
    cycles = [s for s in keys["spans"] if s["name"] == "fusion_cycle"]
    for r, c in zip(rounds, cycles):
        assert r["start"] <= c["start"] < c["end"] <= r["end"]
        inside = [x for x in rows if x[0] in spanlog.LAUNCHES and r["start"] <= x[2] <= r["end"]]
        assert {x[1] & 0xFFFFFFFF for x in inside} == {main[0], worker[1] & 0xFFFFFFFF}
    # the count a round takes the tracking thread's launches alone
    mine = sum(1 for r in rounds for x in rows if x[0] in spanlog.LAUNCHES and x[1] == main[0]
               and r["start"] <= x[2] <= r["end"])
    assert spanlog.launches_per_round(keys) == mine / len(rounds) > 0


def test_the_clock_fit_of_the_card_profile_is_tight():
    """The fit's offset from the ranges' ends; every anchor but the first
    (the profile's first range pays its lazy set-up) within 20 us."""
    _, rows, spans = _fixture()
    clock = spanlog.fit_clock(rows, spans)
    offs = sorted(abs(r[1] * 1e3 - spans[i].t1 - clock["offset_ns"]) for i, r in clock["pairs"])
    assert offs[-2] < 20e3
    assert clock["residual_us"] == pytest.approx(offs[-1] * 1e-3)


# ------------------------------------------------------------ the readers


def _run(trace=None, totals=None, counts=None):
    return harness.Run(seed=1, setup_s=1.0, window_s=1.0, sessions=[],
                       stopwatch_totals=totals or {}, stopwatch_counts=counts or {},
                       trace=trace)


def test_the_readers_on_a_synthetic_run():
    run = _run(totals={"ba_gn_round": 0.9, "frame": 2.0, "frame_offcpu": 0.5},
               counts={"ba_gn_round": 12, "frame": 20, "frame_offcpu": 20})
    assert load_reader("ba_round_ms").read(run) == pytest.approx(75.0)
    assert load_reader("tracking_offcpu_ms").read(run) == pytest.approx(25.0)
    spans = [{"name": "ba_gn_round", "tid": 5, "start": 100.0, "end": 200.0},
             {"name": "frame", "tid": 5, "start": 50.0, "end": 400.0},
             {"name": "ba_gn_round", "tid": 5, "start": 300.0, "end": 350.0}]
    launches = [("cudaLaunchKernel", 5, 100.0, 101.0), ("cudaLaunchKernel", 5, 150.0, 151.0),
                ("cudaGraphLaunch", 5, 199.0, 210.0), ("cudaLaunchKernel", 9, 160.0, 161.0),
                ("cudaLaunchKernel", 5, 250.0, 251.0), ("cudaMemcpyAsync", 5, 320.0, 321.0)]
    assert spanlog.launches_per_round({"spans": spans, "launches": launches}) == pytest.approx(2.0)
    assert spanlog.launches_per_round({"spans": spans[1:2], "launches": launches}) is None


def test_the_readers_give_nothing_for_a_program_without_spans():
    """A program without the spans `ba_gn_round` and `frame`: the readers
    return None and raise nothing."""
    run = _run(trace={"window_s": 1.0, "busy_s": 0.1, "by_name": {}, "ops": [], "idle_gaps": []},
               totals={"preprocess": 1.0}, counts={"preprocess": 10})
    for name in ("ba_round_ms", "tracking_offcpu_ms"):
        assert load_reader(name).read(run) is None
        assert load_reader(name).read(_run()) is None


@pytest.mark.parametrize("counts,want", [({}, None), ({"ba_gn_round": 12}, None),
                                         ({"ba_capture": 2, "ba_replay": 94}, 94 / 96),
                                         ({"ba_capture": 3}, 0.0)])
def test_ba_replay_share_reads_the_counts(counts, want):
    """The share of BA rounds replayed; None from a program that counts no
    captured round, as the parent of the captured rounds does."""
    got = load_reader("ba_replay_share").read(_run(counts=counts))
    assert got is None if want is None else got == pytest.approx(want)


# ------------------------------------------------------------ reduce


class _E:
    """A FunctionEvent's fields that reduce() reads."""

    def __init__(self, name, device, a, b, annotation=False):
        self.name, self.device_type, self.is_user_annotation = name, device, annotation
        self.time_range = type("R", (), {"start": a, "end": b})()


class _K:
    """A kineto event's fields that host_rows() reads."""

    def __init__(self, name, tid, a, b):
        self._v = (name, tid, a, b)

    def name(self):
        return self._v[0]

    def device_resource_id(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1e3) + 10**9

    def end_ns(self):
        return int(self._v[3] * 1e3) + 10**9

    def device_type(self):
        return torch.autograd.DeviceType.CPU


class _Prof:
    def __init__(self, events, host):
        self._events = events
        results = type("KR", (), {"events": lambda _: host, "trace_start_ns": lambda _: 10**9})()
        self.profiler = type("P", (), {"kineto_results": results})()

    def events(self):
        return self._events


def _profile():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    tid = 77
    host = [(trace.WINDOW, 0.0, 1000.0), ("tf.frame", 10.0, 900.0), ("aten::add", 100.0, 120.0),
            ("cudaLaunchKernel", 105.0, 110.0), ("tf.ba_gn_round", 300.0, 700.0),
            ("cudaLaunchKernel", 310.0, 312.0), ("cudaLaunchKernel", 500.0, 502.0)]
    dev = [("at::cuda::spin_kernel(long)", -50.0, -40.0), ("k_add", 110.0, 130.0),
           ("k_a", 315.0, 330.0), ("k_b", 505.0, 520.0), ("tf.frame", 110.0, 520.0)]
    events = ([_E(n, cpu, a, b, n.startswith("tf.")) for n, a, b in host]
              + [_E(n, cuda, a, b, n.startswith("tf.")) for n, a, b in dev])
    kineto = [_K(n, tid, a, b) for n, a, b in host]
    spans = []
    for name, a, b, parent in (("frame", 10.0, 900.0, -1), ("ba_gn_round", 300.0, 700.0, 0)):
        sp = Span(name, "MainThread", tid, tid, parent, {"frame": 3})
        sp.t0, sp.t1 = int(a * 1e3) - 5000, int(b * 1e3) - 5000   # the log's clock: 5 us behind
        spans.append(sp)
    sp = Span("tex_host", "fusion_0", 88, 88, -1, {"kf": 1, "cause": 3})
    sp.t0, sp.t1 = 590_000 - 5000, 800_000 - 5000
    spans.append(sp)
    return _Prof(events, kineto), spans


def test_reduce_keeps_its_keys_when_spans_are_present():
    prof, spans = _profile()
    plain, traced = trace.reduce(prof), spanlog.reduce(prof, spans)
    for k in ("window_s", "busy_s", "by_name", "ops"):
        assert plain[k] == traced[k], k
    assert set(plain) == {"window_s", "busy_s", "by_name", "ops", "idle_gaps"}
    assert plain["busy_s"] == pytest.approx(50e-6)       # k_add 20 + k_a 15 + k_b 15 us
    # the gaps the tracking thread's ranges cover are named by them, where
    # a profile without the ranges names them "python (no op)"
    assert plain["idle_gaps"] == traced["idle_gaps"]
    named = dict(traced["idle_gaps"])
    assert named == pytest.approx({"tf.frame": 775e-6, "tf.ba_gn_round": 175e-6})
    bare = _Prof([e for e in prof.events() if not e.name.startswith("tf.")], [])
    assert dict(trace.reduce(bare)["idle_gaps"]) == pytest.approx({"python (no op)": 950e-6})
    assert traced["clock"]["offset_ns"] == pytest.approx(5000.0)
    assert traced["clock"]["anchors"] == 2 and traced["clock"]["residual_us"] == 0
    tex = [s for s in traced["spans"] if s["name"] == "tex_host"][0]
    assert (tex["start"], tex["end"]) == pytest.approx((590.0, 800.0))
    # the idle time: 0-110, 130-315, 330-505, 520-1000 us
    assert traced["idle_s"] == pytest.approx(950e-6)
    main = dict(map(tuple, traced["idle_by_span"]["MainThread"]))
    assert main["ba_gn_round"] == pytest.approx((15 + 175 + 180) * 1e-6)
    assert main["frame"] == pytest.approx((100 + 170 + 200) * 1e-6)
    assert main[spanlog.NO_SPAN] == pytest.approx((10 + 100) * 1e-6)
    fusion = dict(map(tuple, traced["idle_by_span"]["fusion_0"]))
    assert fusion["tex_host"] == pytest.approx(210e-6)              # inside 520-1000
    assert traced["idle_unspanned_s"] == pytest.approx((10 + 100) * 1e-6)
    assert [r[0] for r in traced["launches"]] == ["cudaLaunchKernel"] * 3
    assert spanlog.launches_per_round(traced) == 2.0
    got = spanlog.summary(traced)
    assert got["ba_rounds"] == 1 and got["ba_launches_per_round"] == 2.0
    assert got["ba_round_ms_traced"] == pytest.approx(0.4)
    assert got["device_idle_share"] == pytest.approx(0.95)


def test_innermost_and_overlap():
    spans = [{"name": "a", "start": 0.0, "end": 100.0}, {"name": "b", "start": 10.0, "end": 40.0},
             {"name": "c", "start": 20.0, "end": 30.0}, {"name": "d", "start": 35.0, "end": 60.0},
             {"name": "e", "start": 150.0, "end": 160.0}]
    seg = spanlog.innermost(spans)
    assert seg == [(0.0, 10.0, "a"), (10.0, 20.0, "b"), (20.0, 30.0, "c"), (30.0, 35.0, "b"),
                   (35.0, 40.0, "d"), (40.0, 100.0, "a"), (150.0, 160.0, "e")]
    got = spanlog.overlap([(5.0, 25.0), (90.0, 155.0)], seg)
    assert got == pytest.approx({"a": 15e-6, "b": 10e-6, "c": 5e-6, "e": 5e-6})
