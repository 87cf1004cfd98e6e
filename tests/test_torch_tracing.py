"""The port's span recorder, ``utils/profiler.py`` (CPU).

- With no profiler recording, ``TIMERS.stage`` keeps no span, and its
  totals and counts equal those of the JAX package's ``StageTimers`` (the
  copy the recorder grew from) over the same stages on the same clock.
- Under a CPU ``torch.profiler``, a ``BookQueue`` run of two books (a
  two-page test book and a one-page scanned book, one page a super-batch)
  keeps ``book``, ``prepare_body``, ``dispatch``, ``enrich`` and
  ``db_post`` on the main thread with their book and batch,
  ``features_dispatch`` and ``rec_dispatch`` on the feed thread with the
  main-thread span that submitted them as parent, and ``png_encode`` on the
  PNG pool's threads; every span also counts in the totals.
- Totals and counts stay exact with 8 threads × 10,000 stages, recording
  or not.
- ``torch_trace`` writes the program's spans of every thread into its trace
  file on the trace's clock: the ``aten::`` operations run inside a span
  fall inside it there.
"""
import contextlib
import glob
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from synapta_tpu.utils import profiler as jax_profiler
from synapta_tpu_torch.utils import profiler
from synapta_tpu_torch.utils.profiler import TIMERS, SpanPool, StageTimers

from torchfixtures import pin_threads

pin_threads()


def _fake_clock(monkeypatch, *modules):
    """A clock per thread that moves one second each time it is read."""
    local = threading.local()

    def tick():
        local.t = getattr(local, "t", 0) + 1
        return local.t

    fake = SimpleNamespace(perf_counter=tick,
                           perf_counter_ns=lambda: tick() * 1_000_000_000)
    for m in modules:
        monkeypatch.setattr(m, "time", fake)


def _stages(timers):
    for i in range(5):
        with timers.stage("outer"):
            with timers.stage("inner"):
                pass
            if i % 2:
                with timers.stage("odd"):
                    pass


def test_recording_off_keeps_no_span_and_the_parents_totals(monkeypatch):
    assert not profiler.recording()
    _fake_clock(monkeypatch, profiler, jax_profiler)
    port, parent = StageTimers(), jax_profiler.StageTimers()
    _stages(port)
    _stages(parent)
    assert len(port.spans) == 0
    assert dict(port.totals) == dict(parent.totals)
    assert dict(port.counts) == dict(parent.counts)
    assert port.report() == parent.report()


@pytest.fixture(scope="module")
def queue_spans(tmp_path_factory):
    from synapta_tpu_torch.config import OCRConfig, PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book, make_test_book
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.serve import BookQueue

    d = tmp_path_factory.mktemp("tracing")
    make_test_book(str(d / "book.pdf"), pages=2, seed=11)
    make_scanned_book(str(d / "scan.pdf"), pages=1, seed=2)
    cfg = PipelineConfig(use_vision_llm=False, pages_per_batch=1, analyze_depth=1,
                         recognize_depth=1, ocr=OCRConfig(crop_batch=2, line_batch=16))
    q = BookQueue(output_root=str(d / "out"), config=cfg,
                  llm_client=DisabledClient(), device="cpu")
    q.add(str(d / "book.pdf"), book_id="book")
    q.add(str(d / "scan.pdf"), book_id="scan")
    TIMERS.spans_between(0, 0)  # empty the buffer
    counts0 = dict(TIMERS.counts)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        manifest = q.run()
        t1 = time.perf_counter_ns()
    assert all(b["status"] == "done" for b in manifest["books"].values())
    counts = {k: v - counts0.get(k, 0) for k, v in TIMERS.counts.items()}
    return TIMERS.spans_between(t0, t1), threading.get_native_id(), counts


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_main_thread_spans_name_their_book_and_batch(queue_spans):
    spans, main, _ = queue_spans
    books = _named(spans, "book")
    assert [(s.book, s.attrs, s.tid) for s in books] == [
        ("book", {"pages": 2}, main), ("scan", {"pages": 1}, main)]
    prep = _named(spans, "prepare_body")
    assert [(s.book, s.batch, s.attrs["pages"], s.tid) for s in prep] == [
        ("book", 0, 1, main), ("book", 1, 1, main), ("scan", 0, 1, main)]
    assert [s.attrs["regions"] for s in prep] == [0, 1, 1]  # page 0: text
    for name in ("dispatch", "enrich"):
        # the batches with regions, at the loop's site (book) and the drain's
        assert [(s.book, s.batch, s.tid) for s in _named(spans, name)] == [
            ("book", 1, main), ("scan", 0, main)], name
    by_id = {s.sid: s for s in spans}
    book_of = {s.book: s.sid for s in books}
    for s in spans:
        if s.name in ("prepare_body", "dispatch", "enrich"):
            assert s.parent == book_of[s.book]
    post, = _named(spans, "db_post")
    assert (post.book, post.batch, post.tid, post.attrs) == ("scan", 0, main, {"views": 1})
    assert by_id[post.parent].name == "dispatch"


def test_worker_spans_carry_their_submitters_context(queue_spans):
    spans, main, _ = queue_spans
    by_id = {s.sid: s for s in spans}
    for name, parent in (("features_dispatch", "book"), ("rec_dispatch", "ocr_dispatch")):
        got = _named(spans, name)
        assert [(s.book, s.batch) for s in got] == [("book", 1), ("scan", 0)], name
        for s in got:
            p = by_id[s.parent]
            assert s.tid != main and p.tid == main and p.name == parent
            assert p.book == s.book
    feed = {s.book: s.tid for s in _named(spans, "features_dispatch")}
    assert {s.book: s.tid for s in _named(spans, "rec_dispatch")} == feed
    assert [s.attrs["crops"] for s in _named(spans, "features_dispatch")] == [1, 1]
    for s in _named(spans, "rec_dispatch"):
        assert 0 < s.attrs["tiles"] <= s.attrs["rows"] and s.attrs["rows"] % 16 == 0
    png = _named(spans, "png_encode")
    assert [(s.book, s.batch) for s in png] == [("book", 1), ("scan", 0)]
    for s in png:
        assert s.tid not in (main, feed[s.book])
        assert by_id[s.parent].name == "prepare_body"


def test_every_span_counts_in_the_totals(queue_spans):
    spans, _, counts = queue_spans
    kept = {}
    for s in spans:
        kept[s.name] = kept.get(s.name, 0) + 1
    assert kept == {k: v for k, v in counts.items() if v}
    for name in ("ingest_open", "detect", "render", "device_pass", "features",
                 "ocr_dispatch", "ocr_tile_prep", "ocr", "ocr_recognize",
                 "build_segment", "writer_append", "finalize"):
        assert kept.get(name), name
    assert not any(s.name.startswith("pb.") for s in spans)


@contextlib.contextmanager
def _switch_often():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("recording", [False, True])
def test_totals_are_exact_across_threads(monkeypatch, recording):
    timers = StageTimers()
    _fake_clock(monkeypatch, profiler)
    n_threads, n = 8, 10_000

    def work():
        for _ in range(n):
            with timers.stage("shared"):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    prof = profile(activities=[ProfilerActivity.CPU]) if recording else contextlib.nullcontext()
    with _switch_often(), prof:
        assert profiler.recording() == recording
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert timers.counts["shared"] == n_threads * n
    assert timers.totals["shared"] == n_threads * n  # one fake second each
    assert len(timers.spans) == (n_threads * n if recording else 0)
    assert len({s.sid for s in timers.spans}) == len(timers.spans)


@pytest.mark.parametrize("ptid,want", [
    # (pthread id, the tid of its CUDA launches in a profiler trace on the
    # H100): the size of the low 32 bits read as a signed integer
    (0x7FA1AAFFD6C0, 1426073920), (0x7FA1AB7FE6C0, 1417681216),
    (140581722388160, 1147144512), (140055507105472, 918550208),
    (140055389664960, 801109696),
])
def test_trace_tids_of_a_thread_the_profiler_did_not_start_on(ptid, want):
    span = profiler.Span("x", 1, None, None, None, 4321, ptid, 0, 1, {})
    assert span.trace_tids() == (4321, want)


def _trace_events(log_dir):
    path, = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_aten_operations_fall_inside_their_span_in_the_trace(tmp_path):
    with profiler.torch_trace(str(tmp_path)):
        for k in range(3):
            with TIMERS.stage("matmul", batch=k):
                time.sleep(0.002)
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.002)
    events = _trace_events(str(tmp_path))
    spans = [e for e in events if e.get("cat") == "program_span"]
    mms = sorted(e["ts"] for e in events
                 if e.get("ph") == "X" and e.get("name") == "aten::mm")
    assert [s["args"]["batch"] for s in spans] == [0, 1, 2] and len(mms) == 3
    for s, t in zip(spans, mms):
        assert s["name"] == "matmul" and s["tid"] == threading.get_native_id()
        assert s["ts"] + 1000 < t < s["ts"] + s["dur"] - 1000  # 1 ms inside


def test_torch_trace_writes_the_spans_of_every_thread(tmp_path):
    def work():
        with TIMERS.stage("work", rows=2):
            time.sleep(0.001)
        return threading.get_native_id()

    pool = SpanPool(max_workers=1)
    try:
        with profiler.torch_trace(str(tmp_path)):
            with TIMERS.stage("submit", book="b0", batch=3):
                tid = pool.submit(work).result(timeout=60)
    finally:
        pool.shutdown(wait=True)
    spans = {e["name"]: e for e in _trace_events(str(tmp_path))
             if e.get("cat") == "program_span"}
    assert set(spans) == {"submit", "work"}
    submit, work_ = spans["submit"], spans["work"]
    assert submit["tid"] == threading.get_native_id() != tid == work_["tid"]
    assert work_["args"] == {"id": work_["args"]["id"], "parent": submit["args"]["id"],
                             "book": "b0", "batch": 3, "rows": 2}
    assert submit["ts"] <= work_["ts"] and work_["ts"] + work_["dur"] <= submit["ts"] + submit["dur"]
