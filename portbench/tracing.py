"""Spans that the benchmark records around calls into the program's layers,
and the reading of the profiler's device trace.

A layer's span is declared by a file ``spans/<layer>.py`` of its own:
``TARGET = "module:attr.path"`` names the call boundary (the name the
program looks up at call time), and an optional ``attrs(args, kwargs,
result) -> dict`` records counts from the call's arguments (shapes, real
rows). ``install`` wraps every declared boundary for the run: each call
appends a ``Span`` (name, id, thread, host start and end, attrs) to the
recorder (a boundary the program under test lacks is skipped with a line on
standard error), and while the profiler runs it also enters
``record_function("pb.<name>#<id>")``. The profiler records those
annotations on the thread that started it only; ``attribute`` uses them to
put every span on the trace's clock and gives each span the device time of
the operations launched from its thread while it was open.
"""
from __future__ import annotations

import bisect
import functools
import glob
import importlib
import importlib.util
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = "pb."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    name: str
    sid: int
    tid: int  # the OS thread id
    t0: float
    t1: float = 0.0
    attrs: dict = field(default_factory=dict)
    device_s: Optional[float] = None  # set from the trace

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """Spans kept in memory for the run; ``tracing`` turns on the profiler
    annotations."""

    def __init__(self):
        self.spans: List[Span] = []
        self.tracing = False
        self._lock = threading.Lock()
        self._next = 0

    def open(self, name: str) -> Span:
        with self._lock:
            self._next += 1
            sid = self._next
        return Span(name, sid, threading.get_native_id(), time.perf_counter())

    def close(self, sp: Span) -> None:
        sp.t1 = time.perf_counter()
        with self._lock:
            self.spans.append(sp)

    def between(self, t0: float, t1: float) -> List[Span]:
        return [s for s in self.spans if s.t0 >= t0 and s.t1 <= t1]


def _resolve(target: str):
    """"module:Attr.path" -> (owner object, attribute name)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def load_span_specs(root: str = HERE) -> Dict[str, object]:
    """Every ``spans/<layer>.py``, by layer name."""
    specs = {}
    for path in sorted(glob.glob(os.path.join(root, "spans", "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_span_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        specs[name] = mod
    return specs


def wrap(owner, attr: str, name: str, rec: Recorder, attrs_fn=None):
    """Replace ``owner.attr`` by a recording wrapper; -> an undo callable."""
    orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

    @functools.wraps(orig)
    def spanned(*args, **kwargs):
        sp = rec.open(name)
        ctx = None
        if rec.tracing:
            from torch.profiler import record_function

            ctx = record_function(f"{PREFIX}{name}#{sp.sid}")
            ctx.__enter__()
        try:
            out = orig(*args, **kwargs)
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
            rec.close(sp)
        if attrs_fn is not None:
            sp.attrs = attrs_fn(args, kwargs, out)
        return out

    setattr(owner, attr, spanned)
    return lambda: setattr(owner, attr, orig)


def install(rec: Recorder, root: str = HERE) -> List:
    """Wrap every declared span boundary; -> undo callables. A span whose
    target the program under test lacks (a module, a class or a function
    that a later tree adds) is skipped with one line on standard error:
    the metrics that read only it report nothing, as without a trace."""
    undo = []
    for name, mod in load_span_specs(root).items():
        try:
            owner, attr = _resolve(mod.TARGET)
            getattr(owner, attr)
        except (ImportError, AttributeError) as e:
            print(f"portbench: span spans/{name}.py skipped: no {mod.TARGET} "
                  f"({type(e).__name__}: {e})", file=sys.stderr, flush=True)
            continue
        undo.append(wrap(owner, attr, name, rec, getattr(mod, "attrs", None)))
    return undo


# ------------------------------------------------------------------ trace


@dataclass
class DeviceTrace:
    """What the profiler's trace says of the device: every operation's
    interval (µs, the trace's clock), per launching thread the launch times
    and prefix sums of the launched operations' device seconds, and the
    ``pb.`` annotations' host intervals."""
    ops: List[tuple]              # (start_us, end_us, name)
    launch_sums: Dict[object, tuple]
    annotations: List[tuple]      # (start_us, end_us, tid, name)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return union_length([(a, b) for a, b, _ in self.ops]) / 1e6

    def op_totals(self, top: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for a, b, n in self.ops:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, main_span: str = "serve", top: int = 10) -> List[list]:
        """The longest idle gaps of the device, each named by the innermost
        harness span open at its middle on the main thread (the thread
        that records ``main_span``)."""
        ivs = merge([(a, b) for a, b, _ in self.ops])
        gaps = [(ivs[i][1], ivs[i + 1][0]) for i in range(len(ivs) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        tids = {a[2] for a in self.annotations
                if a[3].startswith(f"{PREFIX}{main_span}#")}
        main = [a for a in self.annotations if a[2] in tids]
        out = []
        for g0, g1 in gaps[:top]:
            mid = 0.5 * (g0 + g1)
            inner = [a for a in main if a[0] <= mid <= a[1]]
            label = (min(inner, key=lambda a: a[1] - a[0])[3]
                     if inner else "outside spans")
            out.append([label.split("#")[0].removeprefix(PREFIX),
                        (g1 - g0) / 1e6])
        return out


def merge(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_length(ivs) -> float:
    return sum(b - a for a, b in merge(ivs))


def read_chrome_trace(path: str) -> DeviceTrace:
    """Parse an exported profiler trace: device operations, their launches
    and the ``pb.`` annotations."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return device_trace(events)


def device_trace(events: List[dict]) -> DeviceTrace:
    ops, launches, ann = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((ts, ts + dur, e.get("name", ""),
                        (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            ann.append((ts, ts + dur, e.get("tid"), e["name"]))
    # per launching thread: the device seconds of the operations launched,
    # in launch order, as prefix sums
    per_tid: Dict[object, List[tuple]] = {}
    for a, b, _, corr in ops:
        if corr in launches:
            tid, t = launches[corr]
            per_tid.setdefault(tid, []).append((t, (b - a) / 1e6))
    sums = {tid: _prefix(rows) for tid, rows in per_tid.items()}
    return DeviceTrace([(a, b, n) for a, b, n, _ in ops], sums, ann)


def _prefix(rows):
    rows.sort()
    acc = [0.0]
    for _, d in rows:
        acc.append(acc[-1] + d)
    return [t for t, _ in rows], acc


def attribute(dtrace: "DeviceTrace", spans: List[Span]) -> None:
    """Set each span's ``device_s``: the device seconds of the operations
    launched from its thread between its ends. The spans' host clock is
    put on the trace's by the spans the profiler also recorded as
    annotations, those of the profiling (main) thread. The trace names the
    main thread as the annotations do; a span of another thread (the
    pipeline's one device-feed thread) takes the launches of every thread
    but the main one. Nested spans each count the operations they hold."""
    by_sid = {int(n.rsplit("#", 1)[1]): a0 for a0, _, _, n in dtrace.annotations}
    pairs = sorted(by_sid[s.sid] - s.t0 * 1e6 for s in spans if s.sid in by_sid)
    if not pairs:
        return
    off = pairs[len(pairs) // 2]
    main = {a[2] for a in dtrace.annotations}
    main_ids = {s.tid for s in spans if s.sid in by_sid}
    others = _prefix([(t, d) for tid, (times, acc) in dtrace.launch_sums.items()
                      if tid not in main
                      for t, d in zip(times, (b - a for a, b in zip(acc, acc[1:])))])
    for s in spans:
        if s.tid in main_ids:
            times, acc = next((dtrace.launch_sums[t] for t in main
                               if t in dtrace.launch_sums), ([], [0.0]))
        else:
            times, acc = others
        i0 = bisect.bisect_left(times, s.t0 * 1e6 + off)
        i1 = bisect.bisect_right(times, s.t1 * 1e6 + off)
        s.device_s = acc[i1] - acc[i0]
