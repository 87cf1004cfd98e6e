"""The program's own spans of the measured window, placed on the profiler
trace's clock, and what the readers of ``metrics/`` take from them.

``synapta_tpu_torch.utils.profiler.TIMERS`` keeps every stage of every
thread as a span (name, id, parent, book, batch, thread ids, start and end
on ``perf_counter_ns``, counts) while a profiler records, as it does in
the harness's traced window. The harness's own spans read the same host
clock (``perf_counter``), and each of their ``pb.`` annotations pairs a
host time with a trace time. An annotation opens after its span's host
time, later still when another thread holds the interpreter, so the
running minimum of those offsets places every program span, of any
thread. A span's device time is that of the operations launched from its
own thread while it was open: the trace gives the thread that started the
profiler its OS id, and the CUDA launches of every other thread an id made
from its pthread id (``Span.trace_tids``), which a later book's thread may
reuse. The main thread is the one that records ``book``.

``load`` returns None, and every reader reports nothing, for a run without
a trace or against a program that keeps no spans.
"""
from __future__ import annotations

import bisect
import importlib
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from portbench import tracing

# the main thread's stages that split the device's idle time, in order of
# precedence; the rest of the window is "between"
IDLE_STAGES = {"prepare": ("prepare_body", "prepare_wait"),
               "dispatch": ("dispatch",), "enrich": ("enrich",)}
SMOOTH = 31  # offsets in the running minimum, at most a tenth of them


@dataclass
class Program:
    spans: list                 # the program's spans of the window
    main_tid: int
    window: Tuple[float, float]  # the window on the trace's clock, µs
    window_us: float            # its length by the host's clock
    pairs: List[Tuple[float, float]]  # (host µs, trace µs less host µs)
    smooth: List[float]               # the pairs' offsets, running minimum
    launch_sums: dict

    def __post_init__(self):
        self._xs = [h for h, _ in self.pairs]

    def place(self, t_ns: int) -> float:
        """A host ``perf_counter_ns`` on the trace's clock (µs)."""
        host, xs = t_ns / 1e3, self._xs
        i = bisect.bisect_left(xs, host)
        if i <= 0:
            return host + self.smooth[0]
        if i >= len(xs):
            return host + self.smooth[-1]
        x0, x1 = xs[i - 1], xs[i]
        w = (host - x0) / (x1 - x0) if x1 > x0 else 0.0
        return host + self.smooth[i - 1] + w * (self.smooth[i] - self.smooth[i - 1])

    def interval(self, s) -> Tuple[float, float]:
        return self.place(s.t0), self.place(s.t1)

    def trace_tid(self, s):
        """The ``tid`` under which the trace holds the launches of the
        span's thread (None: it launched nothing)."""
        return next((t for t in s.trace_tids() if t in self.launch_sums), None)

    def device_s(self, s) -> float:
        """Device seconds of the operations launched from the span's thread
        while it was open."""
        times, acc = self.launch_sums.get(self.trace_tid(s), ([], [0.0]))
        a, b = self.interval(s)
        return acc[bisect.bisect_right(times, b)] - acc[bisect.bisect_left(times, a)]

    def drift_us(self) -> float:
        """The least offset in the window's last tenth less that in its
        first tenth."""
        lo, hi = self.pairs[0][0], self.pairs[-1][0]
        tenth = (hi - lo) / 10
        first = [o for h, o in self.pairs if h <= lo + tenth]
        last = [o for h, o in self.pairs if h >= hi - tenth]
        return min(last) - min(first)

    def launch_coverage(self, names) -> Optional[float]:
        """Share of the window's launches from the threads that record the
        spans ``names`` that fall inside one of those threads' spans (a
        later book's threads may reuse a pthread id, and so a trace id)."""
        launched = inside = 0
        by_tid: Dict[object, list] = {}
        for s in self.spans:
            by_tid.setdefault(self.trace_tid(s), []).append(s)
        for tid, mine in by_tid.items():
            if tid is None or not any(s.name in names for s in mine):
                continue
            times = [t for t in self.launch_sums[tid][0]
                     if self.window[0] <= t <= self.window[1]]
            ivs = tracing.merge([self.interval(s) for s in mine])
            launched += len(times)
            inside += _inside(times, ivs)
        return inside / launched if launched else None

    def idle_pct(self, busy) -> Dict[str, float]:
        """The window's device idle time split by the main thread's stage,
        each a share of the window (%): ``IDLE_STAGES`` and ``between``."""
        t0, t1 = self.window
        idle, at = [], t0
        for a, b in busy:
            if b <= at:
                continue
            if a >= t1:
                break
            if a > at:
                idle.append([at, a])
            at = max(at, b)
        if at < t1:
            idle.append([at, t1])
        out = {}
        for cat, names in IDLE_STAGES.items():
            ivs = tracing.merge([self.interval(s) for s in self.spans
                                 if s.tid == self.main_tid and s.name in names])
            inside, idle = _split(idle, ivs)
            out[cat] = 100.0 * inside / self.window_us
        out["between"] = 100.0 * sum(b - a for a, b in idle) / self.window_us
        return out


def _inside(times, ivs) -> int:
    """How many of ``times`` fall in the sorted, disjoint ``ivs``."""
    starts = [a for a, _ in ivs]
    n = 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= ivs[i][1]
    return n


def _split(idle, ivs):
    """-> (length of ``idle`` inside ``ivs``, the rest of ``idle``); both
    lists sorted and disjoint."""
    inside, rest, j = 0.0, [], 0
    for a, b in idle:
        while j < len(ivs) and ivs[j][1] <= a:
            j += 1
        k, at = j, a
        while k < len(ivs) and ivs[k][0] < b:
            lo, hi = max(ivs[k][0], at), min(ivs[k][1], b)
            if lo > at:
                rest.append([at, lo])
            if hi > lo:
                inside += hi - lo
            at = max(at, hi)
            k += 1
        if at < b:
            rest.append([at, b])
    return inside, rest


def _running_min(values: List[float], k: int) -> List[float]:
    h = k // 2
    return [min(values[max(0, i - h):i + h + 1]) for i in range(len(values))]


def load(run) -> Optional[Program]:
    """The run's program spans, placed (cached on the run: ``TIMERS`` hands
    its spans out once)."""
    if not hasattr(run, "program"):
        run.program = _load(run)
    return run.program


def _load(run) -> Optional[Program]:
    if run.trace is None or not run.window_s:
        return None
    try:
        timers = importlib.import_module("synapta_tpu_torch.utils.profiler").TIMERS
    except ImportError:
        return None
    take = getattr(timers, "spans_between", None)
    serve = [s for s in run.spans if s.name == "serve"]
    if take is None or not serve:
        return None
    w1 = max(s.t1 for s in serve)  # the window ends with the last book
    w0 = w1 - run.window_s
    spans = take(int(w0 * 1e9) - 1_000_000, int(w1 * 1e9) + 1_000_000)  # 1 ms slack
    main = [s.tid for s in spans if s.name == "book"]
    by_sid = {int(n.rsplit("#", 1)[1]): a0 for a0, _, _, n in run.trace.annotations}
    pairs = sorted((s.t0 * 1e6, by_sid[s.sid] - s.t0 * 1e6)
                   for s in run.spans if s.sid in by_sid)
    if not main or len(pairs) < 2:
        return None
    prog = Program(spans, statistics.mode(main), (0.0, 0.0), run.window_s * 1e6,
                   pairs, _running_min([o for _, o in pairs],
                                       min(SMOOTH, len(pairs) // 10)),
                   run.trace.launch_sums)
    prog.window = (prog.place(int(w0 * 1e9)), prog.place(int(w1 * 1e9)))
    return prog


def idle_pct(run, stage: str) -> Optional[float]:
    """Share of the window (%) in which the device ran nothing while the
    main thread was in ``stage`` (a key of ``IDLE_STAGES``, or
    ``between``)."""
    prog = load(run)
    if prog is None:
        return None
    if not hasattr(run, "idle_split"):
        run.idle_split = prog.idle_pct(tracing.merge([(a, b) for a, b, _ in run.trace.ops]))
    return run.idle_split[stage]
