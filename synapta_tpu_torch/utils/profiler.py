"""Tracing/profiling hooks (SURVEY.md §5: the reference had none).

Stage timers aggregate wall time per pipeline stage; ``torch_trace`` wraps a
block in the PyTorch profiler for TensorBoard-viewable device traces.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "calls": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals, key=lambda k: -self.totals[k])
        }


TIMERS = StageTimers()


@contextlib.contextmanager
def torch_trace(log_dir: str | None = None) -> Iterator:
    """Device-level profiler trace (view with TensorBoard or Perfetto):
    CPU activities and, where there is a GPU, CUDA ones, written to
    ``log_dir`` as ``<host>_<pid>.<time>.pt.trace.json`` when the block
    ends. Yields the ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.environ.get("SYNAPTA_TRACE_DIR", "/tmp/synapta_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
