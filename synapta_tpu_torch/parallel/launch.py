"""Start the ranks of one program on this host and collect their results.

PyTorch's multi-device training is one process per device, so whatever the
JAX package runs on its single-process mesh (the dry run's dp x tp step, the
tests' clusters) the port runs as N spawned processes that join through
``init_distributed`` on a localhost coordinator.
"""
from __future__ import annotations

import multiprocessing
import socket
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, coordinator, args, conn) -> None:
    try:
        conn.send((True, fn(rank, world, coordinator, *args)))
    except BaseException:  # reported to the parent, which raises
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_ranks(fn: Callable[..., Any], world: int, *args,
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, coordinator, *args)`` in ``world`` spawned
    processes and return their results in rank order. ``fn`` is a
    module-level function; it, ``args`` and its result are pickled.
    ``coordinator`` is a fresh "127.0.0.1:port" for ``init_distributed``.
    Raises RuntimeError with the rank's traceback if a rank fails, and kills
    every rank that is still alive after ``timeout`` seconds in all."""
    ctx = multiprocessing.get_context("spawn")
    coordinator = f"127.0.0.1:{free_port()}"
    procs, conns = [], []
    for rank in range(world):
        parent, child = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main,
                        args=(fn, rank, world, coordinator, args, child))
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    results: List[Any] = [None] * world
    failed = None
    deadline = time.monotonic() + timeout
    pending = dict(zip(conns, range(world)))
    try:
        # results as they come: a rank that fails is seen at once, though
        # the ranks before it wait for it in a collective
        while pending and failed is None:
            ready = wait(list(pending), max(0.0, deadline - time.monotonic()))
            if not ready:
                failed = (f"ranks {sorted(pending.values())} of {world}: "
                          f"no result after {timeout} s")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    ok, value = conn.recv()
                except EOFError:
                    ok, value = False, "exited without a result"
                if ok:
                    results[rank] = value
                elif failed is None:
                    failed = f"rank {rank} of {world} failed:\n{value}"
    finally:
        # after a failure the other ranks may wait in a collective for ever
        for p in procs:
            p.join(5.0 if failed else max(5.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    return results
