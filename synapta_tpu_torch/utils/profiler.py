"""Tracing/profiling hooks (SURVEY.md §5: the reference had none).

Stage timers aggregate wall time per pipeline stage; ``torch_trace`` wraps a
block in the PyTorch profiler for TensorBoard-viewable device traces.

While a ``torch.profiler`` records, every stage is also kept as a ``Span``
(its book, super-batch, parent span and thread, on ``perf_counter_ns``),
and ``torch_trace`` writes the spans of every thread into its trace file.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import socket
import sys
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

SPAN_LIMIT = 1 << 18  # spans kept between two reads; the oldest go first
TRACE_ANCHOR = "synapta.trace_anchor"


@dataclass
class Span:
    """One stage of one thread: ``t0`` and ``t1`` in ``perf_counter_ns``,
    ``tid`` the OS thread id and ``ptid`` the pthread id
    (``threading.get_ident()``), ``parent`` the id of the span open on this
    thread or of the span that submitted this thread's task, ``attrs`` the
    counts given at the boundary."""
    name: str
    sid: int
    parent: Optional[int]
    book: Optional[str]
    batch: Optional[int]
    tid: int
    ptid: int
    t0: int
    t1: int
    attrs: dict

    def trace_tids(self) -> tuple:
        """The ``tid`` a profiler trace may give this thread: the OS id
        where the profiler records the thread (the one that started it);
        else, on CUDA launches, the size of the pthread id's low 32 bits
        read as a signed integer."""
        low = self.ptid & 0xFFFFFFFF
        return self.tid, (1 << 32) - low if low >> 31 else low


# (book, batch, id of the open span) of the running code; SpanPool hands it
# to the tasks it runs
_CONTEXT = contextvars.ContextVar("synapta_span_context",
                                  default=(None, None, None))


def recording() -> bool:
    """True while a ``torch.profiler`` records (the flag its ``__enter__``
    sets); imports nothing when torch is not loaded."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: deque = deque(maxlen=SPAN_LIMIT)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    @contextlib.contextmanager
    def stage(self, name: str, **attrs) -> Iterator[dict]:
        """Add the block's wall time to ``totals[name]``. While a profiler
        records, also keep it as a span: ``book`` and ``batch`` (if given)
        name it and the stages inside it; the other keywords are its counts.
        Yields those counts, for the block to add to."""
        rec = recording()
        if rec:
            book, batch, parent = _CONTEXT.get()
            book, batch = attrs.pop("book", book), attrs.pop("batch", batch)
            sid = next(self._ids)
            token = _CONTEXT.set((book, batch, sid))
        t0 = time.perf_counter_ns()
        try:
            yield attrs
        finally:
            t1 = time.perf_counter_ns()
            if rec:
                _CONTEXT.reset(token)
                span = Span(name, sid, parent, book, batch, threading.get_native_id(),
                            threading.get_ident(), t0, t1, attrs)
            with self._lock:
                self.totals[name] += (t1 - t0) / 1e9
                self.counts[name] += 1
                if rec:
                    self.spans.append(span)

    @contextlib.contextmanager
    def batch(self, index: int) -> Iterator[None]:
        """Name the super-batch of the stages opened inside the block (and
        of the tasks they submit through a ``SpanPool``); no span of its
        own."""
        book, _, parent = _CONTEXT.get()
        token = _CONTEXT.set((book, index, parent))
        try:
            yield
        finally:
            _CONTEXT.reset(token)

    def spans_between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The kept spans that lie within [t0_ns, t1_ns] (perf_counter_ns);
        empties the buffer."""
        with self._lock:
            spans = list(self.spans)
            self.spans.clear()
        return [s for s in spans if s.t0 >= t0_ns and s.t1 <= t1_ns]

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        return {
            k: {
                "total_s": round(totals[k], 4),
                "calls": counts[k],
                "mean_ms": round(1000 * totals[k] / max(counts[k], 1), 3),
            }
            for k in sorted(totals, key=lambda k: -totals[k])
        }


TIMERS = StageTimers()


class SpanPool(ThreadPoolExecutor):
    """A thread pool whose tasks run in their submitter's span context:
    their stages carry its book and batch, and the submitting span as their
    parent."""

    def submit(self, fn, /, *args, **kwargs):
        return super().submit(contextvars.copy_context().run, fn, *args, **kwargs)


@contextlib.contextmanager
def torch_trace(log_dir: str | None = None) -> Iterator:
    """Device-level profiler trace (view with TensorBoard or Perfetto):
    CPU activities and, where there is a GPU, CUDA ones, written to
    ``log_dir`` as ``<host>_<pid>.<time>.pt.trace.json`` when the block
    ends, with the block's ``TIMERS`` spans of every thread as complete
    events (``"cat": "program_span"``) on the trace's clock. Yields the
    ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    log_dir = log_dir or os.environ.get("SYNAPTA_TRACE_DIR", "/tmp/synapta_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    ends = []  # perf_counter_ns about the anchor's enter and exit

    def export(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                     f".{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _write_program_spans(path, ends, TIMERS.spans_between(ends[0], ends[-1]))

    with profile(activities=activities, on_trace_ready=export) as prof:
        anchor = record_function(TRACE_ANCHOR)
        t = time.perf_counter_ns()
        anchor.__enter__()
        ends.append((t + time.perf_counter_ns()) // 2)
        try:
            yield prof
        finally:
            t = time.perf_counter_ns()
            anchor.__exit__(None, None, None)
            ends.append((t + time.perf_counter_ns()) // 2)


def _write_program_spans(path: str, ends: List[int], spans: List[Span]) -> None:
    """Add ``spans`` to the exported trace at ``path``, placed on its clock
    by the anchor annotation: its start and end stand for ``ends`` (the
    perf_counter_ns of its enter and exit), linear between them."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    a = next(e for e in events
             if e.get("ph") == "X" and e.get("name") == TRACE_ANCHOR)
    a0, a1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
    rate = (a1 - a0) / max(ends[1] - ends[0], 1)  # trace µs per host ns

    def place(t_ns: int) -> float:
        return a0 + (t_ns - ends[0]) * rate

    seen = {e.get("tid") for e in events}
    for s in spans:
        ts = place(s.t0)
        # the row of the thread's own launches where the trace has them
        tid = next((t for t in s.trace_tids() if t in seen), s.tid)
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name,
            "pid": a.get("pid", os.getpid()), "tid": tid,
            "ts": round(ts, 3), "dur": round(place(s.t1) - ts, 3),
            "args": {"id": s.sid, "parent": s.parent, "book": s.book,
                     "batch": s.batch, **s.attrs}})
    with open(path, "w") as f:
        json.dump(trace, f)
