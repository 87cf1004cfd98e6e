#!/usr/bin/env python3
"""Time the port's edge-stats kernel (synapta_tpu_torch/csrc/edge_stats.cu)
on one NVIDIA GPU, launch by launch, for one or several checkouts.

    python3 scripts/torch_edge_stats_timing.py                # this checkout
    python3 scripts/torch_edge_stats_timing.py --trees A B    # A B B A, in turns

Each tree is timed in a process of its own, started with that tree as its
working directory, so two commits are compared on the same card within one
call (e.g. ``git archive <parent>`` unpacked into ``.scratch/parent``, then
``--trees .scratch/parent .``). A tree builds its own kernels first (nvcc, a
few seconds). The input is (16, 512, 512) float32 of seeded integer-valued
gray: 8 crops of blocks and rules (the opens fire) and 8 of noise.

For every route the tree's wrapper has (``use_pallas`` False and True since
the default route was added; one route before), one JSON line gives the
median of 20 CUDA-event times of a call, and the mean device time of each
of the call's two launches (``es_stencil``, ``es_opens``) from a
``torch.profiler`` trace of 20 calls, with the card's name and power limit. Needs CUDA; without
it the script exits 1.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def gray_batch():
    import numpy as np
    import torch

    rng = np.random.default_rng(42)
    blocks = rng.integers(0, 2, (8, 32, 32)).repeat(16, 1).repeat(16, 2) * 255.0
    for b in range(8):
        for y in rng.integers(0, 512, 6):
            blocks[b, y, :] = 0.0
    noise = rng.integers(0, 256, (8, 512, 512))
    return torch.from_numpy(np.concatenate([blocks, noise]).astype(np.float32)).cuda()


def time_this_tree() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from synapta_tpu_torch.ops.cuda_kernels import fused_edge_stats_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    gray = gray_batch()
    two_routes = "use_pallas" in inspect.signature(fused_edge_stats_cuda).parameters
    routes = ({"default": {"use_pallas": False}, "pallas": {"use_pallas": True}}
              if two_routes else {"pallas": {}})
    out = {"tree": os.getcwd(), "card": card, "shape": list(gray.shape), "routes": {}}
    for name, kw in routes.items():
        for _ in range(3):
            counts = fused_edge_stats_cuda(gray, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fused_edge_stats_cuda(gray, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fused_edge_stats_cuda(gray, **kw)
            torch.cuda.synchronize()
        launches = {}
        for row in prof.key_averages():
            for kernel in ("es_stencil", "es_opens"):
                us = getattr(row, "self_device_time_total", 0.0)
                if kernel in row.key and us > 0:
                    launches[kernel] = {"mean_us": us / row.count,
                                        "launches": row.count}
        out["routes"][name] = {
            "call_ms_median": times[len(times) // 2],
            "call_ms_min": times[0],
            "launch": launches,
            "counts_sum": counts.sum(dim=0).tolist(),
        }
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to time, in turns")
    args = ap.parse_args()
    if not args.trees:
        return time_this_tree()
    order = args.trees + args.trees[::-1]
    for tree in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                             cwd=os.path.abspath(tree))
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
