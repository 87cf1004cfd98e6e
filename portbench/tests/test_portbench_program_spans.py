"""The readers of the program's own spans (``program_spans.py``) on a small
synthetic profiler trace: the device idle time split by the main thread's
stage (the four shares sum to ``device_idle_pct``), the DB post stage's
device time credited by the launching thread, placement on the trace's
clock, and nothing read against a program that keeps no spans."""
from types import SimpleNamespace

import pytest

from portbench import harness, program_spans, tracing
from synapta_tpu_torch.utils import profiler

# the ids the trace gives the threads' launches: the main thread (which
# started the profiler) its OS id, the others the size of their pthread
# ids' low 32 bits as a signed integer (pairs read from traces on the H100)
MAIN, FEED, REC = 12, 1426073920, 918550208
OS_ID = {MAIN: MAIN, FEED: 4010, REC: 4011}
PTHREAD = {MAIN: 0x7FA1B0000740, FEED: 0x7FA1AAFFD6C0, REC: 0x7F6236BFF6C0}
IDLE = ["idle_in_prepare_pct", "idle_in_dispatch_pct", "idle_in_enrich_pct",
        "idle_between_stages_pct"]
METRICS = IDLE + ["db_post_ms_per_view"]


def _x(cat, name, ts, dur, tid=0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(tid, at, corr, start, end, name="k"):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 2, tid, corr),
            _x("kernel", name, start, end - start, 7, corr)]


# (name, id, start, end on the trace's clock in µs)
HARNESS = [("serve", 7, 0, 1000), ("process", 8, 5, 995), ("prepare", 9, 10, 300),
           ("ocr_dispatch", 10, 300, 500), ("enrich", 11, 600, 800),
           ("enrich", 12, 950, 990)]

EVENTS = [
    # the harness's spans on the main thread: one book, its process(), its
    # stages
    *[_x("user_annotation", f"pb.{name}#{sid}", a, b - a, MAIN)
      for name, sid, a, b in HARNESS],
    # the feed thread's analyze chunk, launched inside features_dispatch
    *_launch(FEED, 30, 1, 100, 200),
    # the DB post stage on the main thread, and a feed-thread launch in the
    # same interval that is not the post stage's
    *_launch(MAIN, 355, 2, 360, 380),
    *_launch(FEED, 370, 3, 370, 390),
    # the recognizer, enqueued inside rec_dispatch, runs during enrich
    *_launch(REC, 470, 4, 650, 700),
]

# (name, tid, start, end on the trace's clock in µs, attrs)
PROGRAM = [
    ("book", MAIN, 5, 995, {"pages": 2}),
    ("prepare_body", MAIN, 10, 300, {"pages": 2, "regions": 2}),
    ("features_dispatch", FEED, 20, 60, {"crops": 2}),
    ("dispatch", MAIN, 300, 500, {}),
    ("db_post", MAIN, 350, 400, {"views": 2}),
    ("rec_dispatch", REC, 450, 480, {"tiles": 40, "rows": 128}),
    ("enrich", MAIN, 600, 800, {}),
]


def _host_ns(us, lag_us=1e6):
    """The host clock runs ``lag_us`` behind the trace's."""
    return int(round((us + lag_us) * 1e3))


def fake_run(monkeypatch, program=PROGRAM, lag=lambda us: 1e6):
    timers = profiler.StageTimers()
    for i, (name, tid, a, b, attrs) in enumerate(program):
        timers.spans.append(profiler.Span(name, 100 + i, None, "b0", 0, OS_ID[tid],
                                          PTHREAD[tid], _host_ns(a, lag(a)),
                                          _host_ns(b, lag(b)), dict(attrs)))
    monkeypatch.setattr(profiler, "TIMERS", timers)
    dtrace = tracing.device_trace(EVENTS)
    spans = [tracing.Span(name, sid, MAIN, (a + lag(a)) / 1e6, (b + lag(b)) / 1e6)
             for name, sid, a, b in HARNESS]
    tracing.attribute(dtrace, spans)
    return SimpleNamespace(spans=spans, books=[], window_s=1e-3, pages=2, segments=2,
                           timers={}, trace=dtrace, busy_s=dtrace.busy_s(),
                           setup_s=1.0, models={}, counts=None)


def read(name, run):
    return harness.reader(name)(run)


@pytest.mark.parametrize("name,want", [
    # idle: [0, 100] [200, 360] [390, 650] [700, 1000] of a 1000 µs window
    ("idle_in_prepare_pct", 19.0),       # [10, 100] + [200, 300]
    ("idle_in_dispatch_pct", 17.0),      # [300, 360] + [390, 500]
    ("idle_in_enrich_pct", 15.0),        # [600, 650] + [700, 800]
    ("idle_between_stages_pct", 31.0),   # [0, 10] + [500, 600] + [800, 1000]
    ("db_post_ms_per_view", 0.01),       # the main thread's 20 µs over 2 views
])
def test_reader(monkeypatch, name, want):
    assert read(name, fake_run(monkeypatch)) == pytest.approx(want)


def test_idle_shares_sum_to_the_device_idle_share(monkeypatch):
    run = fake_run(monkeypatch)
    shares = [read(n, run) for n in IDLE]
    assert sum(shares) == pytest.approx(read("device_idle_pct", run))
    assert read("device_idle_pct", run) == pytest.approx(82.0)


def test_launches_are_credited_by_thread(monkeypatch):
    run = fake_run(monkeypatch)
    prog = program_spans.load(run)
    by = {s.name: prog.device_s(s) for s in prog.spans}
    assert by["db_post"] == pytest.approx(20e-6)   # not the feed's 20 µs
    assert by["features_dispatch"] == pytest.approx(100e-6)
    assert by["rec_dispatch"] == pytest.approx(50e-6)
    assert by["book"] == pytest.approx(20e-6)      # the main thread's only
    # the feed thread's launch at 370 µs falls in none of its spans
    assert prog.launch_coverage(["features_dispatch"]) == pytest.approx(0.5)
    assert prog.launch_coverage(["rec_dispatch"]) == 1.0
    assert prog.launch_coverage(["features_dispatch", "rec_dispatch"]) == pytest.approx(2 / 3)
    assert prog.drift_us() == pytest.approx(0.0, abs=1e-6)


def test_a_reused_pthread_id_joins_the_threads(monkeypatch):
    # a later book's feed thread: another OS id, the same pthread id, and
    # so the same trace id; its span holds the launch at 370 µs
    later = ("features_dispatch", FEED, 360, 380, {"crops": 1})
    run = fake_run(monkeypatch, program=PROGRAM + [later])
    prog = program_spans.load(run)
    prog.spans[-1].tid = 4012
    assert prog.launch_coverage(["features_dispatch"]) == 1.0
    assert prog.device_s(prog.spans[-1]) == pytest.approx(20e-6)


def test_placement_follows_a_drifting_offset(monkeypatch):
    # the host clock falls 100 µs further behind over the window
    lag = lambda us: 1e6 + 0.1 * us  # noqa: E731
    run = fake_run(monkeypatch, lag=lag)
    prog = program_spans.load(run)
    db = next(s for s in prog.spans if s.name == "db_post")
    assert prog.interval(db) == pytest.approx((350, 400), abs=1e-3)
    # the least offsets: at 10 µs and at 950 µs
    assert prog.drift_us() == pytest.approx(-94.0)


def test_the_spans_are_read_once_and_cached(monkeypatch):
    run = fake_run(monkeypatch)
    first = [read(n, run) for n in METRICS]
    assert len(profiler.TIMERS.spans) == 0         # handed out once
    assert [read(n, run) for n in METRICS] == first


@pytest.mark.parametrize("name", METRICS)
def test_nothing_read_against_a_program_without_spans(monkeypatch, name):
    run = fake_run(monkeypatch)
    # the parent's StageTimers: totals and counts, no spans
    monkeypatch.setattr(profiler, "TIMERS", SimpleNamespace(totals={}, counts={}))
    assert read(name, run) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_read_without_a_trace(monkeypatch, name):
    run = fake_run(monkeypatch)
    run.trace, run.busy_s = None, None
    assert read(name, run) is None
