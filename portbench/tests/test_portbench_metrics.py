"""Every metric reader on a small synthetic profiler trace and span record,
and the result line built from a fake run."""
import json
from types import SimpleNamespace

import pytest

from portbench import counts, harness, tracing

REC = {"convs": [[1, 32, 1, 1], [32, 64, 2, 2], [64, 128, 2, 2],
                 [128, 192, 2, 1], [192, 192, 2, 1]],
       "dim": 192, "blocks": 2, "heads": 4, "mlp_ratio": 2, "classes": 161,
       "tile": [32, 384]}


def _x(cat, name, ts, dur, tid=0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    # the main thread (12): a book, its process(), the DB detector
    _x("user_annotation", "pb.serve#7", 0, 1000, 12),
    _x("user_annotation", "pb.process#8", 5, 990, 12),
    _x("user_annotation", "pb.db#5", 600, 100, 12),
    _x("user_annotation", "pb.db_chunk#6", 610, 50, 12),
    _x("cuda_runtime", "cudaLaunchKernel", 620, 2, 12, 6),
    _x("kernel", "db_conv", 700, 40, 7, 6),
    # the feed thread (10): an analyze chunk with a CC and an edge-stats call
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2, 10, 1),
    _x("kernel", "cc_kernel", 200, 30, 7, 1),
    _x("cuda_driver", "cuLaunchKernel", 50, 2, 10, 2),
    _x("kernel", "cummax", 240, 50, 7, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 65, 2, 10, 3),
    _x("kernel", "es_stencil", 300, 10, 7, 3),
    # the recognizer on thread 11: a copy and a kernel
    _x("cuda_runtime", "cudaMemcpyAsync", 410, 2, 11, 4),
    _x("gpu_memcpy", "Memcpy HtoD", 420, 5, 7, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 415, 2, 11, 5),
    _x("kernel", "gemm", 430, 100, 7, 5),
    # an aten op and an instant event the reader skips
    _x("cpu_op", "aten::add", 1, 1, 10),
    {"ph": "i", "name": "marker", "ts": 5},
]


def _span(name, sid, tid, t0, t1, **attrs):
    """A span on the host clock, in seconds: the trace's clock less 1 s."""
    return tracing.Span(name, sid, tid, (t0 + 1e6) / 1e6, (t1 + 1e6) / 1e6, attrs)


# the program's own spans of the main thread (12), on the trace's clock in
# µs: the book, its prepare, its dispatch with the DB post stage inside,
# its enrich
PROGRAM = [("book", 5, 995, {"pages": 2}), ("prepare_body", 10, 190, {"pages": 2}),
           ("dispatch", 190, 700, {}), ("db_post", 610, 660, {"views": 3}),
           ("enrich", 700, 990, {})]


def program_timers(monkeypatch):
    """The program's ``TIMERS`` holding ``PROGRAM``, as a traced window
    leaves it (host ``perf_counter_ns``: the trace's clock less 1 s)."""
    from synapta_tpu_torch.utils import profiler

    timers = profiler.StageTimers()
    for i, (name, a, b, attrs) in enumerate(PROGRAM):
        timers.spans.append(profiler.Span(name, 100 + i, None, "b0", 0, 12, 0x7FA1B0000740,
                                          int((a + 1e6) * 1e3), int((b + 1e6) * 1e3),
                                          dict(attrs)))
    monkeypatch.setattr(profiler, "TIMERS", timers)


def fake_run(books=None):
    dtrace = tracing.device_trace(EVENTS)
    # the host clock of the spans runs 1 s behind the trace's; the spans of
    # threads 10 and 11 have no annotation (the profiler records only the
    # profiling thread's), the main thread's (12) do
    spans = [
        _span("serve", 7, 12, 0, 1000), _span("process", 8, 12, 5, 995),
        _span("analyze", 1, 10, 0, 100, chunks=1, crops=16),
        _span("cc", 2, 10, 10, 30, shape=[16, 256, 256], connectivity=8),
        _span("edge_stats", 3, 10, 60, 70, shape=[16, 512, 512], counts=6),
        _span("recognizer", 4, 11, 400, 450, tiles=100, batches=1, tile=[32, 384]),
        _span("db", 5, 12, 600, 700, crops=3),
        _span("db_chunk", 6, 12, 610, 660, views=3, size=512),
    ]
    tracing.attribute(dtrace, spans)
    books = books or [{"status": "done", "errors": 0, "turnaround_s": t}
                      for t in (0.5, 0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 0.8, 0.9, 1.0, 2.0)]
    return SimpleNamespace(
        spans=spans, books=books, window_s=1e-3, pages=40, segments=20,
        timers={"prepare_body": 0.4, "build_segment": 0.1, "writer_append": 0.02},
        trace=dtrace, busy_s=dtrace.busy_s(), counts=counts, setup_s=12.5,
        models={"recognizer": REC, "detector": {"size": 512}})


def read(name, run):
    return harness.reader(name)(run)


def test_device_time_goes_to_every_span_holding_the_launch():
    run = fake_run()
    by = {s.name: s.device_s for s in run.spans}
    assert by["analyze"] == pytest.approx(90e-6)      # cc + cummax + stencil
    assert by["cc"] == pytest.approx(30e-6)
    assert by["edge_stats"] == pytest.approx(10e-6)
    assert by["recognizer"] == pytest.approx(105e-6)  # the copy and the gemm
    assert by["db"] == by["db_chunk"] == pytest.approx(40e-6)
    assert by["serve"] == by["process"] == pytest.approx(40e-6)
    assert run.busy_s == pytest.approx(235e-6)


@pytest.mark.parametrize("name,want", [
    ("prepare_ms_per_page", 10.0),
    ("enrich_ms_per_segment", 6.0),
    ("analyze_ms_per_chunk", 0.09),
    ("cc_roofline_pct", 100 * (16 * 256 * 256 * 8 + 64) / 3.35e12 / 30e-6),
    ("edge_stats_roofline_pct", 100 * (16 * 512 * 512 * 4 + 384) / 3.35e12 / 10e-6),
    ("recognizer_us_per_tile", 1.05),
    ("db_ms_per_view", 0.04 / 3),
    ("device_idle_pct", 76.5),
    ("page_mfu_pct", None),
    ("pages_per_s", 40000.0),
    ("setup_s", 12.5),
])
def test_reader(name, want):
    run = fake_run()
    if name == "page_mfu_pct":
        f32, bf16 = counts.detector_flops(512)
        want = 100 * (100 * counts.recognizer_flops(REC) / 989e12
                      + 3 * (f32 / 67e12 + bf16 / 989e12)) / 1e-3
    assert read(name, run) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "analyze_ms_per_chunk", "cc_roofline_pct", "edge_stats_roofline_pct",
    "recognizer_us_per_tile", "db_ms_per_view", "device_idle_pct",
    "page_mfu_pct"])
def test_reader_without_a_trace_returns_nothing(name):
    run = fake_run()
    run.trace, run.busy_s = None, None
    for s in run.spans:
        s.device_s = None
    assert read(name, run) is None


def test_idle_gaps_and_ops():
    run = fake_run()
    ops = dict(run.trace.op_totals())
    assert ops["gemm"] == pytest.approx(100e-6)
    gaps = run.trace.idle_gaps()
    # the longest gap (530 -> 700 us) falls inside the DB chunk's span
    assert gaps[0] == ["db_chunk", pytest.approx(170e-6)]
    assert [g[1] for g in gaps] == pytest.approx([170e-6, 110e-6, 10e-6, 10e-6, 5e-6])


def test_result_line_from_a_fake_run(monkeypatch):
    bench = harness.load_benchmark()
    cell = harness.cell_spec(bench, "scanned-chapters")
    program_timers(monkeypatch)
    run = fake_run()
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    numbers = {"books_incomplete": 0, "visuals_missed": 0, "rec_gap": 0.1,
               "analyze_diff": 0.0}
    limits = {"books_incomplete": 0, "visuals_missed": 0, "rec_gap": 1.5}
    out = harness.assemble(cell, run, False, numbers, limits, dev)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] == 11 and out["failed"] == 0
    assert set(out["metrics"]) == {"pages_per_s", "setup_s"}
    assert out["metrics"]["pages_per_s"]["unit"] == "pages/s"
    assert out["checks"]["visuals_missed"] == {"value": 0, "limit": 0}
    assert out["checks"]["rec_gap"] == {"value": 0.1, "limit": 1.5}
    traced = harness.assemble(cell, run, True, numbers, limits, dev)
    assert set(traced["metrics"]) == {m["name"] for m in cell["per_layer"]}
    got = {n: m["value"] for n, m in traced["metrics"].items()}
    assert sum(got[n] for n in ("idle_in_prepare_pct", "idle_in_dispatch_pct",
                                "idle_in_enrich_pct", "idle_between_stages_pct")
               ) == pytest.approx(got["device_idle_pct"])
    assert got["db_post_ms_per_view"] == pytest.approx(0.04 / 3)
    assert traced["device"]["busy_s"] == pytest.approx(235e-6)
    assert len(traced["breakdown"]["device_ops"]) <= 10
    json.dumps(traced)
    bad = harness.assemble(cell, run, False, dict(numbers, visuals_missed=1), limits, dev)
    assert bad["correct"] is False
    missing = harness.assemble(cell, run, False, {}, limits, dev)
    assert missing["correct"] is False
