#!/usr/bin/env python3
"""Smoke test of the PyTorch port (synapta_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds both CUDA kernels from synapta_tpu_torch/csrc, checks each against
its plain PyTorch twin at the main path's shapes (the CC kernel at all five
call sites: the four of the analyze pass and the DB line detector's, also on
a random mask that does not settle within the cap, and its rounds against
the twin's; the edge-stats kernel on both of its routes, the default one
that the main path runs and the Pallas kernel's, on rendered crops and on
integer noise), times each beside its plain twin and its bound (the least time
the card could take: bytes over HBM rate against operations over peak
rate), checks the recognizer and the DB detector in bf16 on the GPU against
float32 on the CPU, then drives the port's entry points on the GPU:

- VisualSegmentationPipeline(device="cuda"): the 8-page cycle of
  ``make_test_book`` on the GPU and on the CPU (the two segment JSON
  payloads must match key by key and the CSVs cell by cell, apart from the
  entries of ``ALLOWED_DIFFERENCES``, the table the tier-1 tests hold the
  port to the JAX pipeline with) and a 64-page book at the production
  chunk shapes;
- the scanned-page path (full-page rasters through the DB detector under the
  default line_detector="auto"): the 2-page scanned book of the tier-1 test
  on the GPU and on the CPU (the whole JSON and CSV, as the 8-page book's),
  a 4-page one (the same, but OCR confidences are printed, not bounded) and
  a 16-page one through eval.evaluate_scanned (0 errors, CER <= 0.025); ``DBLineDetector.detect_lines`` on a drawn crop
  that takes the native-resolution path (2 x 2 views of 512², ``db_native``);
- serve.BookQueue(device="cuda") over a test book and a scanned book: both
  done with 0 errors, and a second run skips both;
- training, which launches no kernel of the port's own (cuDNN, cuBLAS and
  torch's CTC loss): three optimiser steps of each trainer in float32 on
  the GPU against the CPU from the same parameters and batches, and the
  first loss in bf16 on the GPU against float32 on the CPU
  (``train_step_parity``); ``models.train.train(device="cuda")`` from
  scratch at full width, 150 steps of 64 lines (the loss falls to the bar,
  the checkpoint reads back to the trained model's logits); the shipped
  recognizer's CER on 256 synthetic lines (< 0.05); and
  ``models.detector.train_detector(device="cuda")`` from scratch, 60 steps
  of 8 pages at 512², with steps/s, samples/s and the host's data share;
- multi-device execution (synapta_tpu_torch/parallel) on the one card:
  both kernels against their twins at the shard shapes, each shard on a
  stream of its own (``dp_kernels``); one 16-crop chunk through
  ``device_analyze`` on a 2-shard virtual data mesh, equal to the unsharded
  pass (``dp_analyze``); the 64-page book on that mesh, with the segments of
  the mesh-of-one run and twice its kernel launches (``dp_pipeline``); in a
  spawned process an NCCL group of one rank: three float32 steps of
  ``make_dp_tp_train_step`` at full width against ``make_train_step``, then
  ``train(use_mesh=True, device="cuda")`` for 101 steps
  (``dist_nccl_ws1``); two spawned ranks that share the card over gloo, dp 2
  and then tp 2, against the same single-process steps
  (``dist_two_ranks``); ``graft_entry.dryrun_multichip(2, "cuda")``
  (``dryrun``) and the ``graft_entry.entry()`` forward (``entry``).

Kernel launch counters are set to 0 just before each of the 64-page, the
16-page scanned and the 2-shard 64-page runs and read just after, with the
route of every edge-stats launch (all must be the default route's). Every
phase prints one JSON line; any failure exits nonzero. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

``--profile`` runs the 64-page book, the 16-page scanned book, one DB chunk
(model, post stage) and one step of each trainer (its batch drawn on the
host included) once more under ``utils.profiler.torch_trace`` (device-busy
share, device time by kernel; traces in trace_<label>/ of the output
directory, beside the build log). There is no CPU fallback:
without CUDA the script exits 1 and prints no result. Synthetic inputs are
made from fixed seeds.
"""
from __future__ import annotations

import contextlib
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 42
CARD = {}  # name and power limit, repeated on every line with a time
# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM3
# bytes/s, and float32 operations/s outside the tensor cores (also used for
# the CC kernel's 32-bit integer compares and maxes).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The DB detector in bf16 on the GPU against float32 on the CPU, on the 16
# scanned views (the CPU's bf16 against float32 gave 0.99993 of the pixels
# and 293 of 293 boxes)
DB_PROB_AGREE_MIN = 0.999
DB_BOX_MATCH_MIN = 0.95
SCANNED_CER_MAX = 0.025  # the JAX package's bar, tests/test_detector.py
# The whole page cycle of make_test_book: the book the tier-1 test holds to
# the JAX pipeline (tests/test_torch_pipeline.py); here the card is held to
# the CPU on it, under ALLOWED_DIFFERENCES.
BOOK8_SEED = 11
# (pages, seed) of the scanned book the tier-1 test holds to the JAX
# pipeline (tests/test_torch_entrypoints.py)
SCAN2_PAGES_SEED = (2, 2)
# an OCR confidence in the segment JSON: a text line's or a segment's mean
CONFIDENCE_PATH = r"segments\[\d+\]\.ocr_result\.(blocks\[\d+\]\.)?confidence"
# Training. Three steps of each trainer in float32 on the card against the
# CPU, from the same parameters and batches (warmup 2 of 10, peak lr 1e-3).
# The CPU rehearsal (float32 against float64 on the CPU) gave loss errors up
# to 1.6e-6 relative, parameter updates 3.8e-3 (recognizer) and 4.5e-4
# (detector) apart in relative norm, at most 8.8e-4 on one parameter, and a
# bf16 first loss 2.6e-4 / 4.1e-4 from float32. The bars leave room for the
# card's other orders of summation and its CTC backward's atomics; one
# parameter may differ by at most 2 × (lr₂ + lr₃), where Adam's first steps
# take the other sign of a gradient at rounding level.
TRAIN_PARITY = {"loss_rel": 1e-4, "delta_rel_norm": 0.05,
                "param_max_abs": 3e-3, "bf16_loss_rel": 5e-3}
REC_STEPS = 150  # batch 64; more than the schedule's 100 warmup steps
DET_STEPS = 60   # batch 8 at 512²; more than the schedule's 50 warmup steps
# From scratch, the mean loss of the last tenth of the steps over the first
# tenth's. The CPU rehearsal of the same runs (bf16, seed 42) gave 0.199
# (recognizer, 372 -> 74) and 0.228 (detector, 5.61 -> 1.28).
REC_LOSS_DROP_MAX = 0.5
DET_LOSS_DROP_MAX = 0.5


def bound(nbytes: float, ops: float):
    """(least ms the card could take, "bytes" or "operations"): each input
    byte read once and each output byte written once over the memory rate,
    against the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line a phase; ``elapsed_s`` = seconds since the script began."""
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms over `runs` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def forked_ms(mesh, fns, runs: int = 10, warmup: int = 2) -> float:
    """Median device time in ms of fns[i]() enqueued on shard i's stream of
    a data mesh, all shards at once: from a fork off the current stream to
    the join back onto it."""
    import torch

    main = torch.cuda.current_stream()

    def both():
        for i, fn in enumerate(fns):
            mesh.streams[i].wait_stream(main)
            with mesh.stream(i):
                fn()
        for st in mesh.streams:
            main.wait_stream(st)

    return cuda_ms(both, runs, warmup)


TRAIN_SCHEDULE = (0.0, 1e-3, 2, 10)  # warmup 2 of 10: steps 2 and 3 move


def dist_steps(rank, world, coordinator, backend, model_axis, tree, batches):
    """One rank of the dp x tp parity phases: join over ``backend``, lay the
    ranks out data x model, cut the full-width float32 recognizer over
    'model' and take one ``make_dp_tp_train_step`` step per global batch ->
    (mesh shape, losses, the gathered parameters by torch name, timings:
    the mean wall of the steps after the first, and of one all-reduce of a
    float32 buffer as long as the model's gradients, over every rank)."""
    import torch
    import torch.distributed as dist

    from synapta_tpu_torch.models import optim
    from synapta_tpu_torch.models import recognizer as R
    from synapta_tpu_torch.models import train as T
    from synapta_tpu_torch.parallel import mesh as M

    if M.init_distributed(coordinator, world, rank, backend, "cuda") is not True:
        raise RuntimeError("init_distributed joined no process group")
    try:
        mesh = M.make_mesh(world, model_axis=model_axis, device="cuda")
        model = T.create_model(torch.float32)
        model.load_state_dict(R.params_from_flax(tree))
        model = M.shard_params(model.to("cuda"), mesh).train()
        step = M.make_dp_tp_train_step(model, optim.adamw(
            model.parameters(),
            optim.warmup_cosine_decay_schedule(*TRAIN_SCHEDULE), b2=0.98), mesh)
        losses, walls = [], []
        for b in batches:
            t = time.perf_counter()
            losses.append(float(step(*b)))  # reading the loss waits for the step
            walls.append(time.perf_counter() - t)
        full = M.unshard_params(model, mesh)
        flat = torch.zeros(sum(v.numel() for v in full.values()), device="cuda")
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(flat)
        torch.cuda.synchronize()
        timings = {"step_ms": sum(walls[1:]) / len(walls[1:]) * 1e3,
                   "allreduce_ms": (time.perf_counter() - t) / 5 * 1e3,
                   "allreduce_bytes": flat.numel() * 4}
        params = {k: v.double().cpu().numpy() for k, v in full.items()}
        return M.mesh_shape(mesh), losses, params, timings
    finally:
        dist.destroy_process_group()


def dist_train(rank, world, coordinator, steps, seed, out):
    """One rank of ``train(use_mesh=True, device="cuda")``, joined through
    the three env vars as the CLI's ``--mesh`` is (NCCL) -> the run without
    its model."""
    import torch.distributed as dist

    from synapta_tpu_torch.models import train as T

    os.environ.update(SYNAPTA_COORDINATOR=coordinator,
                      SYNAPTA_NUM_PROCESSES=str(world),
                      SYNAPTA_PROCESS_ID=str(rank))
    run = T.train(steps=steps, batch=64, seed=seed, out=out, log_every=50,
                  device="cuda", use_mesh=True)
    run.pop("model")
    run["group_left"] = dist.is_initialized()
    return run


def prepare(pdf: str, pages):
    """The port's host prepare stage (detect + render) over `pages`."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.ingest import open_pdf
    from synapta_tpu_torch.io.loader import prepare_batch
    from synapta_tpu_torch.vision.detect import DetectionEngine

    cfg = PipelineConfig()
    render_doc = open_pdf(pdf)
    engine = DetectionEngine(open_pdf(pdf), cfg.detection, pixels_doc=render_doc)
    prepared = prepare_batch(engine, render_doc, cfg.detection.render_dpi,
                             cfg.ocr.crop_size, pages)
    if prepared is None:
        raise RuntimeError(f"no visual regions on pages {list(pages)}")
    return prepared


def rendered_crops(pdf: str, pages, n: int = 16):
    """The first n region canvases (B, 512, 512, 3) uint8 and their true
    (h, w), through the port's host prepare stage (detect + render)."""
    import numpy as np

    prepared = prepare(pdf, pages)
    canvases = np.array(prepared[1][:n])  # copy out of the loader's ring
    dims = [tuple(d) for d in prepared[2][:n]]
    real = canvases.shape[0]
    if real < n:
        pad = np.full((n - real,) + canvases.shape[1:], 255, np.uint8)
        canvases = np.concatenate([canvases, pad])
        dims += [(1, 1)] * (n - real)
    return canvases, np.array(dims, np.int32), real


def box_match_share(want, got, iou_min: float = 0.9) -> float:
    """Share of line boxes (of the longer list, over all crops) that have a
    partner in the other list at IoU >= iou_min."""
    from synapta_tpu_torch.eval import _box_iou

    hits = total = 0
    for w, g in zip(want, got):
        hits += sum(any(_box_iou(a, b) >= iou_min for b in g) for a in w)
        total += max(len(w), len(g))
    return hits / max(total, 1)


def json_differences(a, b, path=""):
    """Every leaf (or shape) where two JSON values differ -> (path, a, b)."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            p = f"{path}.{k}" if path else k
            if k not in a or k not in b:
                yield p, a.get(k, "<missing>"), b.get(k, "<missing>")
            else:
                yield from json_differences(a[k], b[k], p)
    elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from json_differences(x, y, f"{path}[{i}]")
    elif type(a) is not type(b) or a != b:
        yield path, a, b


# "The same segments": every key of one run's segment JSON equals the other
# run's unless its path matches one of these entries. The tier-1 tests hold
# the port on the CPU to the JAX pipeline with this table
# (tests/test_torch_pipeline.py, tests/test_torch_entrypoints.py); the e2e
# phases below hold the card to the CPU with it. No cell of the summary CSV
# may differ (its confidence column is rounded to two decimals).
# (JSON path pattern, how the values may differ, tolerance, reason)
ALLOWED_DIFFERENCES = (
    (r"segments\[\d+\]\.image_path", "basename", None,
     "the crop's file lies in each run's own output directory; the file "
     "names are equal"),
    (r"segments\[\d+\]\.ocr_result\.blocks\[\d+\]\.confidence", "abs", 0.5,
     "mean greedy-path probability of a text line, 0..100: the bf16 models "
     "round alike but sum their float32 products in other orders (XLA's CPU "
     "kernels, the CPU's, the card's); measured at most 0.145 port against "
     "JAX on the 8-page book and 0.023 on the 2-page scanned book but its "
     "knife-edge line (CPU), 0.139 and 0.066 the card against the CPU. A "
     "frame whose greedy choice is a near-tie between blank and a character "
     "moves a line's value by 2-3 with its text unchanged (4-page scanned "
     "book, seed 42: 2.74 port against JAX, 0.61 the card against the CPU), "
     "which this bound does not cover"),
    (r"segments\[\d+\]\.ocr_result\.confidence", "abs", 1e-3,
     "the mean of a segment's block confidences, 0..1; measured at most "
     "6.0e-5 port against JAX (CPU), 1.2e-4 the card against the CPU; a "
     "near-tie line moves it as it moves its block (1.4e-3, 4-page scanned "
     "book, port against JAX)"),
)


def allowed_difference(path: str, a, b):
    """The index of the ALLOWED_DIFFERENCES entry that lets this difference
    pass, or None."""
    for i, (pattern, how, tol, _) in enumerate(ALLOWED_DIFFERENCES):
        if not re.fullmatch(pattern, path):
            continue
        if how == "basename":
            ok = (isinstance(a, str) and isinstance(b, str)
                  and os.path.basename(a) == os.path.basename(b))
        else:
            ok = (isinstance(a, float) and isinstance(b, float)
                  and abs(a - b) <= tol)
        return i if ok else None
    return None


def headers_found(*names) -> dict:
    """Whether ``g++ -E`` finds each C header (nothing is built)."""
    found = {}
    for name in names:
        try:
            res = subprocess.run(
                ["g++", "-E", "-x", "c++", "-"], input=f"#include <{name}>\n",
                capture_output=True, text=True, timeout=60)
            found[name] = res.returncode == 0
        except (OSError, subprocess.SubprocessError):
            found[name] = False
    return found


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "synapta_tpu_torch")):
        return fail("synapta_tpu_torch/ not found next to chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False (no GPU, no result)")

    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    ensure_fixture_fonts()
    import numpy as np

    # ------------------------------------------------------------ 0. env
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    smi_line = smi[0] if smi else "unknown, unknown"
    device_name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    CARD.update(card=smi_line)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=device_name, capability=list(cap), count=torch.cuda.device_count(),
         python=sys.version.split()[0],
         headers=headers_found("jpeglib.h", "zlib.h"), **CARD)
    if cap != (9, 0):
        return fail(f"needs compute capability 9.0 (Hopper), got {cap}")
    dev = torch.device("cuda")
    from synapta_tpu_torch.device import resolve_device

    resolve_device("cuda")  # sets the TF32 switches off

    # ---------------------------------------------------------- 1. build
    from synapta_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_log())
    emit("build", seconds=build_s, library=_build.library_path().name)

    from synapta_tpu_torch.io.pdf_writer import make_scanned_book, make_test_book
    from synapta_tpu_torch.models import detector as D
    from synapta_tpu_torch.ocr.linedet import fuse_text_mask
    from synapta_tpu_torch.ops import features
    from synapta_tpu_torch.ops.cc import connected_components_reference
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats,
        fused_edge_stats_cuda,
        fused_edge_stats_reference,
    )
    from synapta_tpu_torch.ops.features import _core_features, _enclosed_mask
    from synapta_tpu_torch.ops.filters import downsample2, downsample2_min
    from synapta_tpu_torch.ops.color import gray_quarter_host

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    book64 = os.path.join(tmp, "book64.pdf")
    truths = make_test_book(book64, pages=64, seed=SEED)
    canvases, sizes, real = rendered_crops(book64, range(0, 16))
    gray_np, rgb_q_np = gray_quarter_host(canvases)
    rgb_q_np = np.ascontiguousarray(rgb_q_np[:, ::2, ::2])
    gray_u8 = torch.from_numpy(gray_np).to(dev)
    rgb_q = torch.from_numpy(rgb_q_np).to(dev)

    # the DB detector's 16-view chunk: 16 scanned pages, one region each;
    # page-scale scans (ratio > 2) take the canvas path, one 512² view a crop
    scan16 = os.path.join(tmp, "scan16.pdf")
    make_scanned_book(scan16, pages=16, seed=SEED)
    scan_prep = prepare(scan16, range(16))
    scan_canv = np.array(scan_prep[1])
    scan_ctxs = list(scan_prep[5])
    if scan_canv.shape[0] != 16 or not all(c and c[1] > 2.0 for c in scan_ctxs):
        return fail(f"scanned book: {scan_canv.shape[0]} regions, not 16 "
                    "canvas-path crops")
    db_gray = torch.from_numpy(D.DBLineDetector._luma(scan_canv)).to(dev)
    det = D.DBLineDetector(device="cuda")
    db_logits_gpu = D.db_logits(det.model, db_gray)
    db_mask = D.closed_mask(db_logits_gpu, det.prob_thresh)

    # ------------------------------------------------------------- 2. cc
    with torch.inference_mode():
        feats = _core_features(gray_u8, rgb_q)
        ink, vink, bg = feats["_ink"], feats["_vink"], feats["_bg"]
        main_masks = {  # the four main-path call sites: (mask, cap, conn)
            "ink_blobs": (downsample2(ink), 6, 8),
            "vink_bars": (downsample2_min(vink), 4, 8),
            "enclosed_bg": (downsample2(_enclosed_mask(1.0 - bg)), 6, 4),
            "text_lines": (downsample2(fuse_text_mask(ink)), 10, 8),
        }
    gen = np.random.default_rng(SEED)
    rand = torch.from_numpy(
        (gen.random((16, 256, 256)) < 0.45).astype(np.float32)).to(dev)

    def cc_site(site, mask, iters, conn):
        """Check one call site against the twin (rendered and random masks),
        time it; -> (row, None) or (None, failure message)."""
        mask = mask.contiguous()
        rounds, max_err = {}, 0
        # the random mask does not settle within the cap: the fixed-round case
        for kind, m in (("rendered", mask), ("random", rand)):
            got, k_rounds = connected_components_cuda(m, iters, conn,
                                                      return_rounds=True)
            torch.cuda.synchronize()
            want, p_rounds = connected_components_reference(m, iters, conn,
                                                            return_rounds=True)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            rounds[kind] = k_rounds.cpu().tolist()
            max_err = max(max_err, err)
            if err or rounds[kind] != p_rounds.tolist():
                emit("cc", site=site, input=kind, mismatched=int((got != want).sum()),
                     rounds=rounds[kind], twin_rounds=p_rounds.tolist())
                return None, f"cc kernel != twin at {site} ({kind})"
        k_ms = cuda_ms(lambda: connected_components_cuda(mask, iters, conn))
        p_ms = cuda_ms(lambda: connected_components_reference(mask, iters, conn))
        # bound: the mask in, labels and rounds out; 32-bit compares and maxes
        # per pixel per round (8 for the 3x3 max, 2 for each of four scans)
        B, H, W = mask.shape
        ops = sum(rounds["rendered"]) * H * W * ((8 if conn == 8 else 0) + 8)
        nbytes = B * H * W * 8 + B * 4
        b_ms, b_by = bound(nbytes, ops)
        return {"site": site, "shape": list(mask.shape), "max_iters": iters,
                "connectivity": conn, "components": int(
                    connected_components_cuda(mask, iters, conn).unique().numel() - 1),
                "rounds": rounds["rendered"], "random_rounds": rounds["random"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": max_err, "bytes": nbytes, "ops": ops}, None

    cc_rows, cc_err, cc_ms, cc_plain_ms, cc_bound_ms = [], 0, 0.0, 0.0, 0.0
    cc_ops = cc_bytes = 0.0
    for site, (mask, iters, conn) in main_masks.items():
        row, err_msg = cc_site(site, mask, iters, conn)
        if err_msg:
            return fail(err_msg)
        cc_bytes += row["bytes"]
        cc_ops += row["ops"]
        cc_err = max(cc_err, row["max_abs_err"])
        cc_ms += row["ms"]
        cc_plain_ms += row["plain_ms"]
        cc_bound_ms += row["bound_ms"]
        cc_rows.append(row)
    cc_bound_by = bound(cc_bytes, cc_ops)[1]
    emit("cc", exact=True, sites=cc_rows, ms_per_chunk=cc_ms,
         plain_ms_per_chunk=cc_plain_ms, bound_ms_per_chunk=cc_bound_ms,
         bound_share=cc_bound_ms / cc_ms, **CARD)
    # the fifth call site, once per 16-view DB chunk (models/detector.py)
    db_row, err_msg = cc_site("db_boxes", db_mask, 10, 8)
    if err_msg:
        return fail(err_msg)
    cc_err = max(cc_err, db_row["max_abs_err"])
    cc_checked = [row["site"] for row in cc_rows] + [db_row["site"]]
    emit("cc_db_site", exact=True, **db_row,
         bound_share=db_row["bound_ms"] / db_row["ms"], **CARD)

    # ----------------------------------------------------- 3. edge stats
    # both routes of the one kernel: the default (what the main path runs:
    # centred opens, wrapped NMS, six counts with the union) and the Pallas
    # kernel's (five counts), each against its twin on the rendered crops
    # and on integer-valued noise
    gray = gray_u8.to(torch.float32)
    gray[-1] = 255.0  # one blank crop
    gray = gray.contiguous()
    noise = torch.from_numpy(gen.integers(0, 256, (16, 512, 512)).astype(
        np.float32)).to(dev)
    ROUTES = {"default": False, "pallas": True}
    edge = {}
    for route, use_pallas in ROUTES.items():
        row = {"max_abs_err": 0.0}
        for kind, g in (("rendered", gray), ("noise", noise)):
            got = fused_edge_stats_cuda(g, use_pallas=use_pallas)
            torch.cuda.synchronize()
            want = fused_edge_stats_reference(g, use_pallas=use_pallas)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((got - want).abs().max()))
            if row["max_abs_err"] != 0.0 or got.shape != want.shape:
                emit("edge_stats", route=route, input=kind, got=got.tolist(),
                     want=want.tolist())
                return fail(f"edge-stats kernel != twin ({route} route, {kind})")
            row[f"counts_crop0_{kind}"] = got[0].tolist()
        got = fused_edge_stats_cuda(gray, use_pallas=use_pallas)
        if tuple(got.shape) != (16, 5 if use_pallas else 6):
            return fail(f"edge-stats {route} route returned {tuple(got.shape)}")
        if float(got[-1].abs().sum()) != 0.0:
            return fail("blank crop has nonzero edge counts")
        # bound: the gray batch in, the counts out; 60 float32 operations a
        # pixel (the Pallas kernel's CostEstimate)
        row["bytes"] = gray.numel() * 4 + got.numel() * 4
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], 60.0 * gray.numel())
        edge[route] = row
    # the two routes timed in turns within this one call
    turns = {r: {"ms": [], "plain_ms": []} for r in ROUTES}
    for route in ("default", "pallas", "pallas", "default"):
        up = ROUTES[route]
        turns[route]["ms"].append(cuda_ms(
            lambda: fused_edge_stats_cuda(gray, use_pallas=up)))
        turns[route]["plain_ms"].append(cuda_ms(
            lambda: fused_edge_stats_reference(gray, use_pallas=up)))
    for route, row in edge.items():
        row["ms_turns"] = turns[route]["ms"]
        row["ms"] = sum(turns[route]["ms"]) / 2
        row["plain_ms"] = sum(turns[route]["plain_ms"]) / 2
        row["bound_share"] = row["bound_ms"] / row["ms"]
    if edge["default"]["counts_crop0_rendered"][:5] == edge["pallas"][
            "counts_crop0_rendered"] and edge["default"]["counts_crop0_noise"][
            :5] == edge["pallas"]["counts_crop0_noise"]:
        return fail("the two edge-stats routes gave the same counts")
    emit("edge_stats", exact=True, shape=list(gray.shape), routes=edge, **CARD)

    # ----------------------------------------------------- 4. recognizer
    from synapta_tpu_torch.config import OCRConfig
    from synapta_tpu_torch.models.msgpack_io import load_params
    from synapta_tpu_torch.models.recognizer import recognizer_from_flax
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.ops.features import device_analyze_dispatch, unpack_analysis

    ocr = TorchOCR(OCRConfig(), device="cuda")
    tiles = []
    for start in range(0, 64, 16):
        crops, crop_sizes, n_real = rendered_crops(book64, range(start, start + 16))
        packed = device_analyze_dispatch(crops, sizes=crop_sizes, device=dev)
        _, boxes = unpack_analysis(packed.cpu().numpy(), crops.shape[0])
        tiles += ocr.collect_tiles(crops[:n_real], None, boxes[:n_real])[0]
        if len(tiles) >= 128:
            break
    tiles = np.stack(tiles[:128])
    ocr_cpu = TorchOCR(OCRConfig(), device="cpu")
    ocr_cpu.model = recognizer_from_flax(load_params(), dtype=torch.float32,
                                         device="cpu")
    rec_gpu = ocr.recognize_tiles(tiles)
    rec_cpu = ocr_cpu.recognize_tiles(tiles)
    agree = sum(a["text"] == b["text"] for a, b in zip(rec_gpu, rec_cpu)) / len(tiles)
    tiles_dev = torch.from_numpy(tiles).to(dev)
    rec_ms = cuda_ms(lambda: ocr._decode(tiles_dev), runs=10)
    emit("recognizer", tiles=int(tiles.shape[0]), tile_shape=list(tiles.shape[1:]),
         bf16_gpu_vs_f32_cpu_equal_share=agree, ms_per_128_tiles=rec_ms,
         sample=[rec_gpu[0]["text"], rec_cpu[0]["text"]], **CARD)
    if agree < 0.95:
        return fail(f"recognizer agreement {agree:.3f} < 0.95")

    # --------------------------------------------------- 5. db detector
    # bf16 on the card against float32 on the CPU, on the same 16 views
    cpu_model = D.detector_from_flax(D.load_det_params(), dtype=torch.float32,
                                     device="cpu")
    db_logits_cpu = D.db_logits(cpu_model, db_gray.cpu())
    thresh_logit = math.log(det.prob_thresh / (1.0 - det.prob_thresh))
    prob_agree = float(((db_logits_gpu.cpu() > thresh_logit)
                        == (db_logits_cpu > thresh_logit)).float().mean())
    det_cpu = D.DBLineDetector(device="cpu")
    det_cpu.model = cpu_model
    lines_gpu = det.detect_lines(scan_canv, hires=scan_ctxs)
    lines_cpu = det_cpu.detect_lines(scan_canv, hires=scan_ctxs)
    box_share = box_match_share(lines_cpu, lines_gpu)
    db_model_ms = cuda_ms(lambda: D.db_logits(det.model, db_gray))
    db_post_ms = cuda_ms(lambda: D.mask_boxes(D.closed_mask(db_logits_gpu,
                                                            det.prob_thresh)))
    emit("db_detector", views=int(db_gray.shape[0]),
         view_shape=list(db_gray.shape[1:]),
         prob_agree_at_thresh=prob_agree, prob_agree_min=DB_PROB_AGREE_MIN,
         max_abs_logit_diff=float((db_logits_gpu.cpu() - db_logits_cpu).abs().max()),
         lines=[sum(map(len, lines_gpu)), sum(map(len, lines_cpu))],
         box_match_share_iou90=box_share, box_match_min=DB_BOX_MATCH_MIN,
         ms_model=db_model_ms, ms_post=db_post_ms, ms_cc=db_row["ms"],
         rounds=db_row["rounds"], **CARD)
    if prob_agree < DB_PROB_AGREE_MIN or box_share < DB_BOX_MATCH_MIN:
        return fail(f"db detector: prob agreement {prob_agree:.5f}, boxes "
                    f"matched {box_share:.3f}")

    # the native-resolution path: a crop box-downscaled by 1.05 < ratio <= 2
    # is detected on 512² views of its native image (2 x 2 views, stride 448)
    from PIL import Image, ImageDraw, ImageFont

    import synapta_tpu_torch.io.pdf_writer as pdf_writer
    from synapta_tpu_torch.eval import _prep_standalone

    rng4 = np.random.default_rng(4)
    im = Image.new("L", (820, 640), 240)
    draw = ImageDraw.Draw(im)
    font = ImageFont.truetype(pdf_writer.DEJAVU, 15)
    words = "the return of each asset depends on its weight and risk".split()
    for y in range(30, 600, 26):
        draw.text((40, y), " ".join(rng4.permutation(words)[:8]), fill=20, font=font)
    img = np.asarray(im, np.float32) + rng4.normal(0, 4, (640, 820))
    img = np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)
    nat_canvas, _, nat_ctx = _prep_standalone(img, 512)
    if not 1.05 < nat_ctx[1] <= 2.0:
        return fail(f"db_native: the crop's ratio {nat_ctx[1]} takes the canvas path")
    n_views = len(det._views(np.zeros((int(640 * 960 / 820), 960), np.uint8)))
    connected_components_cuda.launches = 0
    t = time.perf_counter()
    nat_gpu = det.detect_lines(nat_canvas[None], hires=[nat_ctx])
    nat_wall = time.perf_counter() - t
    native_cc_launches = connected_components_cuda.launches
    nat_cpu = det_cpu.detect_lines(nat_canvas[None], hires=[nat_ctx])
    nat_share = box_match_share(nat_cpu, nat_gpu)
    emit("db_native", crop=list(img.shape), ratio=nat_ctx[1], views=n_views,
         lines=[len(nat_gpu[0]), len(nat_cpu[0])],
         box_match_share_iou90=nat_share, box_match_min=DB_BOX_MATCH_MIN,
         cc_launches=native_cc_launches, wall_s=nat_wall, **CARD)
    if (nat_share < DB_BOX_MATCH_MIN or len(nat_cpu[0]) < 15 or n_views != 4
            or native_cc_launches < 1):
        return fail(f"db_native: boxes matched {nat_share:.3f}, {len(nat_cpu[0])} "
                    f"lines, {n_views} views, {native_cc_launches} CC launches")

    # ------------------------------------------------------------ 6. e2e
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.utils.profiler import TIMERS
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    def run(pdf, out, device, mesh=None):
        pipe = VisualSegmentationPipeline(
            book_id="smoke", pdf_path=pdf, output_dir=out, use_mermaid=False,
            config=PipelineConfig(use_vision_llm=False),
            llm_client=DisabledClient(), resume=False, device=device,
        )
        pipe.mesh = mesh  # None: the pipeline builds its own
        t = time.perf_counter()
        segs = pipe.process()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        pipe.close()
        return pipe, segs, wall

    def key(s):
        b = s.bbox
        return (s.segment_id, s.page_no, (b.x0, b.y0, b.x1, b.y1),
                str(s.segment_type), s.caption_text)

    def payload(out):
        with open(os.path.join(out, "smoke_visual_segments.json")) as f:
            return json.load(f)

    # the route of every edge-stats launch from here on, beside the count
    routes_seen = []

    def recording_edge_stats(gray, line_k=20, grid_k=25, high=150.0,
                             use_pallas=False):
        routes_seen.append("pallas" if use_pallas else "default")
        return fused_edge_stats(gray, line_k, grid_k, high, use_pallas)

    features.fused_edge_stats = recording_edge_stats  # what _core_features calls

    def edge_launches():
        """The edge-stats launches since the counters were set to 0, with
        the route they ran; None unless each was seen and ran the default."""
        seen = routes_seen[:]
        del routes_seen[:]
        n = fused_edge_stats_cuda.launches
        if seen != ["default"] * n:
            return None
        return {"route": "default", "launches": n}

    def payload_differences(out_a, out_b):
        """The keys of two runs' segment JSON outside ALLOWED_DIFFERENCES,
        the largest confidence differences (a text line's, 0..100, and a
        segment's mean, 0..1) and whether the summary CSVs are equal."""
        conf = {"block": 0.0, "mean": 0.0}
        outside = []
        for path, a, b in json_differences(payload(out_a), payload(out_b)):
            if (path.endswith(".confidence") and ".ocr_result." in path
                    and isinstance(a, float) and isinstance(b, float)):
                kind = "block" if ".blocks[" in path else "mean"
                conf[kind] = max(conf[kind], abs(a - b))
            if allowed_difference(path, a, b) is None:
                outside.append([path, a, b])
        csvs = []
        for out in (out_a, out_b):
            with open(os.path.join(out, "smoke_visual_summary.csv")) as f:
                csvs.append(f.read())
        return outside, conf, csvs[0] == csvs[1]

    table = {pattern: tol for pattern, _, tol, _ in ALLOWED_DIFFERENCES}
    book8 = os.path.join(tmp, "book8.pdf")
    make_test_book(book8, pages=8, seed=BOOK8_SEED)
    p_gpu, s_gpu, w_gpu = run(book8, os.path.join(tmp, "o8_gpu"), "cuda")
    p_cpu, s_cpu, w_cpu = run(book8, os.path.join(tmp, "o8_cpu"), "cpu")
    same = [key(s) for s in s_gpu] == [key(s) for s in s_cpu]
    outside, conf_diff, csv_equal = payload_differences(
        os.path.join(tmp, "o8_gpu"), os.path.join(tmp, "o8_cpu"))
    emit("e2e_8page", segments=len(s_gpu), cuda_equals_cpu=same,
         keys_outside_table=len(outside), differing_keys=outside[:20],
         confidence_max_abs_diff=conf_diff, allowed=table, csv_equal=csv_equal,
         errors=[p_gpu.stats.errors, p_cpu.stats.errors],
         wall_s_cuda=w_gpu, wall_s_cpu=w_cpu, **CARD)
    if (not same or len(s_gpu) != 8 or p_gpu.stats.errors
            or p_cpu.stats.errors):
        return fail("8-page book: cuda and cpu segments differ (or errors)")
    if outside or not csv_equal:
        return fail(f"8-page book: the cuda and cpu JSON payloads differ "
                    f"outside the table: {outside[:5]}, csv equal {csv_equal}")

    # the main path: counters start at 0 here and are read right after
    connected_components_cuda.launches = 0
    fused_edge_stats_cuda.launches = 0
    del routes_seen[:]
    stage0 = dict(TIMERS.totals)
    chunks0 = TIMERS.counts.get("features_dispatch", 0)
    out64 = os.path.join(tmp, "o64")
    pipe, segs, wall = run(book64, out64, "cuda")
    stage_s = {k: v - stage0.get(k, 0.0) for k, v in TIMERS.totals.items()
               if v - stage0.get(k, 0.0) > 0}
    launches = {"cc": connected_components_cuda.launches,
                "edge_stats": fused_edge_stats_cuda.launches}
    edge_by_path = {"book64": edge_launches()}
    chunks = TIMERS.counts.get("features_dispatch", 0) - chunks0
    st = pipe.stats
    written = all(os.path.exists(os.path.join(out64, f"smoke_{s}"))
                  for s in ("visual_segments.json", "visual_summary.csv"))
    # the repo's own quality checks (tests/test_pipeline.py): every visual
    # page found, and chart/flowchart pages classified
    visual_pages = {t.page_no + 1 for t in truths if t.visuals}
    found_pages = {s.page_no for s in segs}
    recall = len(visual_pages & found_pages) / max(len(visual_pages), 1)
    expected = {"chart_bar": "chart", "chart_line": "chart",
                "chart_pie": "chart", "flowchart": "flowchart"}
    kinds = {}
    for t in truths:
        for v in t.visuals:
            kinds.setdefault(t.page_no + 1, []).append(v.kind)
    hits = total = 0
    for s in segs:
        for k in kinds.get(s.page_no, []):
            if k in expected:
                total += 1
                hits += str(getattr(s.segment_type, "value", s.segment_type)) == expected[k]
    emit("e2e_64page", pages=st.pages, regions=st.regions, segments=len(segs),
         errors=st.errors, chunks=chunks, launches=launches, outputs_written=written,
         mesh=pipe.mesh.shape,
         visual_page_recall=recall, classified=[hits, total],
         wall_s=wall, pages_per_s=st.pages / wall,
         host_stage_s=dict(sorted(stage_s.items(), key=lambda kv: -kv[1])),
         **CARD)
    if st.errors or not segs or not written:
        return fail("64-page run had errors, no segments, or no outputs")
    if torch.cuda.device_count() == 1 and (
            pipe.mesh.shape != {"data": 1} or pipe.mesh.streams != (None,)):
        return fail(f"the default pipeline's mesh on one card is {pipe.mesh}")
    book64_pages_per_s = st.pages / wall
    if launches["cc"] < 4 * chunks or launches["edge_stats"] < chunks or chunks == 0:
        return fail(f"kernel launches {launches} too few for {chunks} chunks")
    if edge_by_path["book64"] is None:
        return fail("64-page book: an edge-stats launch off the default route")
    if recall < 0.95 or total == 0 or hits / total < 0.75:
        return fail(f"quality: recall {recall:.3f}, classified {hits}/{total}")

    # ---------------------------------------------------- 7. e2e scanned
    def scanned_pair(pages, seed, label):
        pdf = os.path.join(tmp, f"{label}.pdf")
        make_scanned_book(pdf, pages=pages, seed=seed)
        runs = [run(pdf, os.path.join(tmp, f"{label}_{d}"), d)
                for d in ("cuda", "cpu")]
        (p_gpu, s_gpu, w_gpu), (p_cpu, s_cpu, w_cpu) = runs
        ok = ([key(s) for s in s_gpu] == [key(s) for s in s_cpu]
              and len(s_gpu) == pages and not p_gpu.stats.errors
              and not p_cpu.stats.errors and p_gpu.ocr._db_detector is not None)
        outside, conf_diff, csv_equal = payload_differences(
            os.path.join(tmp, f"{label}_cuda"), os.path.join(tmp, f"{label}_cpu"))
        return pdf, ok, outside, conf_diff, csv_equal, dict(
            segments=len(s_gpu), errors=[p_gpu.stats.errors, p_cpu.stats.errors],
            db_bound=[p_gpu.ocr._db_detector is not None,
                      p_cpu.ocr._db_detector is not None],
            wall_s_cuda=w_gpu, wall_s_cpu=w_cpu)

    # the scanned book the tier-1 test holds to the JAX pipeline
    # (tests/test_torch_entrypoints.py): the whole JSON under the table
    _, ok, outside, conf_diff, csv_equal, info = scanned_pair(
        SCAN2_PAGES_SEED[0], SCAN2_PAGES_SEED[1], "scan2")
    emit("e2e_scanned_2page", keys_outside_table=len(outside),
         differing_keys=outside[:20], confidence_max_abs_diff=conf_diff,
         allowed=table, csv_equal=csv_equal, **info, **CARD)
    if not ok:
        return fail("2-page scanned book: cuda and cpu segments differ, "
                    "errors, or the DB detector never ran")
    if outside or not csv_equal:
        return fail(f"2-page scanned book: the cuda and cpu JSON payloads "
                    f"differ outside the table: {outside[:5]}, csv equal "
                    f"{csv_equal}")
    # four other scanned pages: every key but the OCR confidences under the
    # table; those are printed, and may pass the table's bound where one
    # frame's greedy choice is a near-tie between blank and a character
    # (the text is the same, the line's mean moves by 2-3 of 100; PERF.md §7)
    scan4, ok, outside, conf_diff, csv_equal, info = scanned_pair(4, SEED, "scan4")
    tail = [k for k in outside if re.fullmatch(CONFIDENCE_PATH, k[0])]
    other = [k for k in outside if k not in tail]
    emit("e2e_scanned_4page", keys_outside_table=len(outside),
         differing_keys=outside[:20], confidences_over_table=len(tail),
         confidence_max_abs_diff=conf_diff, allowed=table,
         csv_equal=csv_equal, **info, **CARD)
    if not ok:
        return fail("4-page scanned book: cuda and cpu segments differ, "
                    "errors, or the DB detector never ran")
    if other or not csv_equal:
        return fail(f"4-page scanned book: the cuda and cpu JSON payloads "
                    f"differ outside the table: {other[:5]}, csv equal "
                    f"{csv_equal}")

    # the scanned path through eval.evaluate_scanned: counters start at 0
    # here and are read right after; its pipeline and DB chunks are recorded
    import synapta_tpu_torch.pipeline as P
    from synapta_tpu_torch import eval as E

    pipes, db_chunks = [], []
    boxes_device = D.boxes_device

    class RecordedPipeline(VisualSegmentationPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pipes.append(self)

    def counted_boxes(model, chunk, thresh):
        db_chunks.append(chunk.shape[0])
        return boxes_device(model, chunk, thresh)

    P.VisualSegmentationPipeline, D.boxes_device = RecordedPipeline, counted_boxes
    connected_components_cuda.launches = 0
    fused_edge_stats_cuda.launches = 0
    del routes_seen[:]
    chunks0 = TIMERS.counts.get("features_dispatch", 0)
    try:
        scanned = E.evaluate_scanned(pages=16, seed=SEED, device="cuda")
    finally:
        P.VisualSegmentationPipeline, D.boxes_device = (VisualSegmentationPipeline,
                                                        boxes_device)
    torch.cuda.synchronize()
    scan_launches = {"cc": connected_components_cuda.launches,
                     "edge_stats": fused_edge_stats_cuda.launches}
    edge_by_path["scanned16"] = edge_launches()
    scan_chunks = TIMERS.counts.get("features_dispatch", 0) - chunks0
    sp = pipes[0]
    sp.close()
    emit("e2e_scanned_16page", pages=sp.stats.pages, segments=sp.stats.segments,
         errors=sp.stats.errors, detected=scanned["scanned_detected"],
         scanned_ocr_cer=scanned["scanned_ocr_cer"], cer_max=SCANNED_CER_MAX,
         analyze_chunks=scan_chunks, db_chunks=len(db_chunks),
         db_views=sum(db_chunks), launches=scan_launches,
         wall_s=sp.stats.wall_s, pages_per_s=sp.stats.pages / sp.stats.wall_s,
         **CARD)
    if (sp.stats.errors or scanned["scanned_detected"] != 16
            or scanned["scanned_ocr_cer"] > SCANNED_CER_MAX):
        return fail(f"16-page scanned book: {sp.stats.errors} errors, "
                    f"{scanned['scanned_detected']} pages detected, CER "
                    f"{scanned['scanned_ocr_cer']}")
    if (not db_chunks or scan_chunks == 0
            or scan_launches["cc"] < 4 * scan_chunks + len(db_chunks)
            or scan_launches["edge_stats"] < scan_chunks
            or edge_by_path["scanned16"] is None):
        return fail(f"scanned kernel launches {scan_launches} too few for "
                    f"{scan_chunks} analyze and {len(db_chunks)} DB chunks")

    # ----------------------------------------------------------- 8. serve
    from synapta_tpu_torch.serve import BookQueue

    serve_root = os.path.join(tmp, "serve")
    events = os.path.join(serve_root, "queue_events.jsonl")

    def queue_run():
        q = BookQueue(output_root=serve_root,
                      config=PipelineConfig(use_vision_llm=False),
                      llm_client=DisabledClient(), device="cuda")
        q.add(book8, book_id="book8")
        q.add(scan4, book_id="scan4")
        return q.run()

    t = time.perf_counter()
    first = queue_run()["books"]
    serve_wall = time.perf_counter() - t
    n_events = len(open(events).readlines())
    second = queue_run()["books"]
    skipped = len(open(events).readlines()) == n_events
    emit("serve", books={k: {f: r[f] for f in ("status", "pages", "segments",
                                               "errors", "error")}
                         for k, r in first.items()},
         second_run_skipped=skipped, wall_s=serve_wall, **CARD)
    if (sorted(first) != ["book8", "scan4"]
            or any(r["status"] != "done" or r["errors"] or not r["segments"]
                   for r in first.values())
            or any(r["status"] != "done" for r in second.values()) or not skipped):
        return fail("serve: a book not done, with errors, or re-run")

    # -------------------------------------------------------- 9. training
    # no kernel of its own: convs and matmuls through cuDNN/cuBLAS, the CTC
    # loss through torch's, as the JAX package leaves them to XLA and optax
    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models import optim
    from synapta_tpu_torch.models import recognizer as R
    from synapta_tpu_torch.models import train as T
    from synapta_tpu_torch.models.synthdata import make_batch

    ensure_synthdata_fonts()
    rec_tree = T.init_params(torch.Generator().manual_seed(SEED))
    det_sd = D.init_params(D.Detector(dtype=torch.float32),
                           torch.Generator().manual_seed(SEED)).state_dict()
    rec_batches = [make_batch(np.random.default_rng(SEED + i), batch=64)
                   for i in range(3)]
    det_batches = [D.make_det_batch(np.random.default_rng(SEED + i), batch=8)
                   for i in range(3)]

    def rec_model(dtype):
        m = T.create_model(dtype)
        m.load_state_dict(R.params_from_flax(rec_tree))
        return m

    def det_model(dtype):
        m = D.Detector(dtype=dtype)
        m.load_state_dict(det_sd)
        return m

    def three_steps(model, make_step, batches, device, **betas):
        """3 updates at warmup 2 of 10 (peak 1e-3: steps 2 and 3 move the
        parameters) -> (losses, parameter deltas on the CPU in float64, the
        mean wall ms of the steps after the first)."""
        model = model.to(device)
        p0 = {k: v.detach().double().cpu() for k, v in model.named_parameters()}
        step = make_step(model, optim.adamw(
            model.parameters(), optim.warmup_cosine_decay_schedule(
                *TRAIN_SCHEDULE), **betas))
        losses, walls = [], []
        for b in batches:
            t = time.perf_counter()
            losses.append(float(step(*b)))  # reading the loss waits for the step
            walls.append(time.perf_counter() - t)
        return losses, {k: v.detach().double().cpu() - p0[k]
                        for k, v in model.named_parameters()}, (
            sum(walls[1:]) / len(walls[1:]) * 1e3)

    def steps_parity(l_got, d_got, l_want, d_want):
        """Losses and parameter deltas of one run of the steps against
        another's, in the measures ``TRAIN_PARITY`` bounds."""
        diff = {k: d_got[k] - d_want[k] for k in d_want}
        n_el = sum(d.numel() for d in diff.values())
        return {
            "loss_rel_err": max(abs(a - b) / abs(b)
                                for a, b in zip(l_got, l_want)),
            "delta_rel_norm_err": math.sqrt(sum(float((d ** 2).sum())
                                                for d in diff.values()))
            / math.sqrt(sum(float((d ** 2).sum()) for d in d_want.values())),
            "param_max_abs_err": max(float(d.abs().max()) for d in diff.values()),
            "param_share_within_1e-6": sum(int((d.abs() <= 1e-6).sum())
                                           for d in diff.values()) / n_el}

    def steps_differ(p):
        return (p["loss_rel_err"] > TRAIN_PARITY["loss_rel"]
                or p["delta_rel_norm_err"] > TRAIN_PARITY["delta_rel_norm"]
                or p["param_max_abs_err"] > TRAIN_PARITY["param_max_abs"])

    def first_loss(model, objective, batch):
        with torch.no_grad():
            return float(objective(model, *batch))

    parity = {}
    for model_name, model_fn, make_step, batches, betas in (
            ("recognizer", rec_model, T.make_train_step, rec_batches,
             {"b2": 0.98}),
            ("detector", det_model, D.make_det_train_step, det_batches, {})):
        l_gpu, d_gpu, ms_gpu = three_steps(model_fn(torch.float32), make_step,
                                           batches, dev, **betas)
        l_cpu, d_cpu, _ = three_steps(model_fn(torch.float32), make_step,
                                      batches, "cpu", **betas)
        if model_name == "recognizer":
            # what the ranks' steps must give, and the wall of one such step
            rec_single, rec_single_step_ms = (l_gpu, d_gpu), ms_gpu
        # the first step's loss in bf16 on the card against float32 on the CPU
        if model_name == "recognizer":
            x, y, n = rec_batches[0]
            args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y),
                    torch.from_numpy(n))
            objective = T.ctc_objective
        else:
            x, *tgt = det_batches[0]
            args = (torch.from_numpy(x).permute(0, 3, 1, 2),
                    *(torch.from_numpy(a) for a in tgt))
            objective = D.db_loss
        bf16 = first_loss(model_fn(torch.bfloat16).to(dev), objective,
                          [a.to(dev) for a in args])
        f32 = first_loss(model_fn(torch.float32), objective, args)
        parity[model_name] = {
            "losses_cuda": l_gpu, "losses_cpu": l_cpu,
            **steps_parity(l_gpu, d_gpu, l_cpu, d_cpu),
            "bf16_cuda_loss": bf16, "f32_cpu_loss": f32,
            "bf16_loss_rel_err": abs(bf16 - f32) / abs(f32)}
    emit("train_step_parity", **parity, bars=TRAIN_PARITY, **CARD)
    for model_name, p in parity.items():
        if steps_differ(p) or p["bf16_loss_rel_err"] > TRAIN_PARITY["bf16_loss_rel"]:
            return fail(f"{model_name} training steps: cuda and cpu differ: {p}")

    def loss_drop(losses):
        """Mean loss of the last tenth of the steps over the first tenth's."""
        n = max(len(losses) // 10, 1)
        return (sum(losses[-n:]) / n) / (sum(losses[:n]) / n)

    def run_row(run, samples):
        return {"steps": run["steps"], "wall_s": run["wall_s"],
                "steps_per_s": run["steps"] / run["wall_s"],
                "samples_per_s": run["steps"] * samples / run["wall_s"],
                "host_data_s": run["data_s"],
                "host_data_share": run["data_s"] / run["wall_s"],
                "host_step_s": run["host_step_s"],
                "device_step_s": run["device_step_s"],
                "first_losses": run["losses"][:3], "last_losses": run["losses"][-3:],
                "loss_drop": loss_drop(run["losses"])}

    rec_out = os.path.join(tmp, "train", "recognizer.msgpack")
    rec_run = T.train(steps=REC_STEPS, batch=64, seed=SEED, out=rec_out,
                      log_every=50, device="cuda")
    # the checkpoint, read back, gives the trained model's own logits
    trained = rec_run["model"]
    reread = T.create_model(trained.dtype)
    reread.load_state_dict(R.params_from_flax(T.load_params(rec_out)))
    reread.to(dev).eval()
    probe = torch.from_numpy(rec_batches[0][0][:16]).to(dev).permute(0, 3, 1, 2)
    with torch.no_grad():
        ckpt_err = float((reread(probe) - trained(probe)).abs().max())
    emit("train_recognizer", **run_row(rec_run, 64), lines_per_step=64,
         cer=rec_run["cer"], checkpoint_logit_max_abs_err=ckpt_err,
         loss_drop_max=REC_LOSS_DROP_MAX, **CARD)
    if loss_drop(rec_run["losses"]) > REC_LOSS_DROP_MAX or ckpt_err != 0.0:
        return fail(f"recognizer training: loss drop "
                    f"{loss_drop(rec_run['losses']):.3f} (bar "
                    f"{REC_LOSS_DROP_MAX}), checkpoint logits off by {ckpt_err}")

    shipped = R.recognizer_from_flax(load_params(), dtype=torch.bfloat16,
                                     device="cuda")
    t = time.perf_counter()
    shipped_cer = T.evaluate(shipped, np.random.default_rng(SEED + 1))
    emit("train_eval_shipped", lines=256, cer=shipped_cer, cer_max=0.05,
         wall_s=time.perf_counter() - t, **CARD)
    if not shipped_cer < 0.05:
        return fail(f"shipped recognizer CER {shipped_cer:.4f} >= 0.05")

    det_out = os.path.join(tmp, "train", "detector.msgpack")
    det_run = D.train_detector(steps=DET_STEPS, batch=8, size=512, seed=SEED,
                               out=det_out, log_every=30, device="cuda")
    reread = D.Detector(dtype=det_run["model"].dtype)
    reread.load_state_dict(D.params_from_flax(D.load_det_params(det_out)))
    reread.to(dev).eval()
    probe = torch.from_numpy(det_batches[0][0][:2]).to(dev).permute(0, 3, 1, 2)
    with torch.no_grad():
        ckpt_err = float((reread(probe) - det_run["model"](probe)).abs().max())
    emit("train_detector", **run_row(det_run, 8), pages_per_step=8,
         checkpoint_logit_max_abs_err=ckpt_err, loss_drop_max=DET_LOSS_DROP_MAX,
         **CARD)
    if loss_drop(det_run["losses"]) > DET_LOSS_DROP_MAX or ckpt_err != 0.0:
        return fail(f"detector training: loss drop "
                    f"{loss_drop(det_run['losses']):.3f} (bar "
                    f"{DET_LOSS_DROP_MAX}), checkpoint logits off by {ckpt_err}")

    # ------------------------------------------------- 10. data mesh (dp)
    # a 2-shard data mesh of the one card: shard i on a stream of its own
    from synapta_tpu_torch.ops.features import device_analyze
    from synapta_tpu_torch.parallel.launch import run_ranks
    from synapta_tpu_torch.parallel.mesh import data_mesh

    mesh2 = data_mesh(2, "cuda", virtual=True)
    if mesh2.shape != {"data": 2} or len(set(mesh2.streams)) != 2:
        return fail(f"virtual data mesh: {mesh2}")
    torch.cuda.synchronize()

    def on_shards(fn, halves):
        """fn(half i) enqueued on shard i's stream, both before any wait ->
        the results (read only after a device-wide synchronise)."""
        out = []
        for i, h in enumerate(halves):
            with mesh2.stream(i):
                out.append(fn(h))
        torch.cuda.synchronize()
        return out

    dp_rows, dp_cc_ms, dp_cc_plain_ms = [], 0.0, 0.0
    for site, (mask, iters, conn) in main_masks.items():
        halves = [h.contiguous() for h in mask.chunk(2)]
        got = on_shards(lambda h: connected_components_cuda(
            h, iters, conn, return_rounds=True), halves)
        for h, (labels, k_rounds) in zip(halves, got):
            want, p_rounds = connected_components_reference(
                h, iters, conn, return_rounds=True)
            if (not torch.equal(labels, want)
                    or k_rounds.cpu().tolist() != p_rounds.tolist()):
                return fail(f"cc kernel != twin on a side stream at {site}")
        ms = forked_ms(mesh2, [lambda h=h: connected_components_cuda(
            h, iters, conn) for h in halves])
        dp_cc_ms += ms
        dp_cc_plain_ms += cuda_ms(lambda: [connected_components_reference(
            h, iters, conn) for h in halves])
        dp_rows.append({"site": site, "shape": list(halves[0].shape),
                        "ms_both_shards": ms})
    gray_halves = [h.contiguous() for h in gray.chunk(2)]
    dp_edge = {}
    for route, up in ROUTES.items():
        got = on_shards(lambda h: fused_edge_stats_cuda(h, use_pallas=up),
                        gray_halves)
        for h, g in zip(gray_halves, got):
            if not torch.equal(g, fused_edge_stats_reference(h, use_pallas=up)):
                return fail(f"edge-stats kernel != twin on a side stream "
                            f"({route} route)")
        dp_edge[route] = {
            "ms": forked_ms(mesh2, [lambda h=h: fused_edge_stats_cuda(
                h, use_pallas=up) for h in gray_halves]),
            "plain_ms": cuda_ms(lambda: [fused_edge_stats_reference(
                h, use_pallas=up) for h in gray_halves])}
    torch.cuda.synchronize()
    emit("dp_kernels", exact=True, shards=2, cc_sites=dp_rows,
         cc_ms_per_chunk=dp_cc_ms, cc_plain_ms_per_chunk=dp_cc_plain_ms,
         cc_unsharded_ms_per_chunk=cc_ms,
         edge_shape=list(gray_halves[0].shape), edge_routes=dp_edge,
         edge_unsharded_ms={r: edge[r]["ms"] for r in edge}, **CARD)

    def analyze_wall(mesh):
        torch.cuda.synchronize()
        t = time.perf_counter()
        packed = device_analyze_dispatch(canvases, sizes=sizes, device=dev,
                                         mesh=mesh).cpu()
        return packed, (time.perf_counter() - t) * 1e3

    for m in (None, mesh2):  # warm both routes
        analyze_wall(m)
    whole, whole_ms = analyze_wall(None)
    parts, parts_ms = analyze_wall(mesh2)
    f2, b2 = device_analyze(canvases, sizes=sizes, device=dev, mesh=mesh2)
    f1, b1 = unpack_analysis(whole.numpy(), canvases.shape[0])
    same = (torch.equal(parts, whole) and np.array_equal(b1, b2)
            and all(np.array_equal(f1[k], f2[k]) for k in f1))
    emit("dp_analyze", chunk=list(canvases.shape), shards=2,
         equals_unsharded=same, packed_shape=list(whole.shape),
         differing=int((parts != whole).sum()),
         wall_ms_unsharded=whole_ms, wall_ms_2_shards=parts_ms, **CARD)
    if not same:
        return fail("device_analyze on 2 shards != the unsharded pass")

    def segments_of(out):
        segs = payload(out)["segments"]
        for seg in segs:
            seg["image_path"] = os.path.basename(seg["image_path"])
        return segs

    # the main path on the 2-shard mesh: counters start at 0 here and are
    # read right after
    connected_components_cuda.launches = 0
    fused_edge_stats_cuda.launches = 0
    del routes_seen[:]
    out64dp = os.path.join(tmp, "o64dp")
    dp_pipe, dp_segs, dp_wall = run(book64, out64dp, "cuda", mesh=mesh2)
    dp_launches = {"cc": connected_components_cuda.launches,
                   "edge_stats": fused_edge_stats_cuda.launches}
    edge_by_path["book64_dp2"] = edge_launches()
    seg1, seg2 = segments_of(out64), segments_of(out64dp)
    differing = [a["segment_id"] for a, b in zip(seg1, seg2) if a != b]
    emit("dp_pipeline", pages=dp_pipe.stats.pages, segments=len(dp_segs),
         errors=dp_pipe.stats.errors, mesh=dp_pipe.mesh.shape,
         ocr_mesh=dp_pipe.ocr.mesh.shape, launches=dp_launches,
         launches_mesh_of_1=launches,
         segments_equal_mesh_of_1=seg1 == seg2, differing_segments=differing[:8],
         wall_s=dp_wall, pages_per_s=dp_pipe.stats.pages / dp_wall,
         pages_per_s_mesh_of_1=book64_pages_per_s, **CARD)
    if dp_pipe.stats.errors or not dp_segs or seg1 != seg2:
        return fail("64-page book on 2 shards: errors, or other segments than "
                    "on the mesh of one")
    if (dp_launches != {k: 2 * v for k, v in launches.items()}
            or edge_by_path["book64_dp2"] is None):
        return fail(f"2-shard launches {dp_launches} are not twice {launches}, "
                    "or an edge-stats launch ran off the default route")

    # ----------------------------------------------- 11. rank meshes (dist)
    # the dp x tp step at full width in spawned ranks against the steps of
    # one process (rec_single: make_train_step, same parameters and batches)
    p0 = {k: v.double() for k, v in R.params_from_flax(rec_tree).items()}

    def ranks_parity(world, backend, model_axis):
        runs = run_ranks(dist_steps, world, backend, model_axis, rec_tree,
                         rec_batches, timeout=300)
        shape, losses, params, timings = runs[0]
        deltas = {k: torch.from_numpy(params[k]) - p0[k] for k in rec_single[1]}
        row = {"mesh": shape, "backend": backend, "losses": losses,
               "losses_single": rec_single[0], **timings,
               "step_ms_single": rec_single_step_ms,
               **steps_parity(losses, deltas, *rec_single),
               "ranks_equal": all(
                   r[1] == losses and all(np.array_equal(r[2][k], params[k])
                                          for k in params) for r in runs[1:])}
        return row, steps_differ(row) or not row["ranks_equal"]

    t = time.perf_counter()
    ws1, bad = ranks_parity(1, "nccl", 1)
    mesh_out = os.path.join(tmp, "train", "recognizer_mesh.msgpack")
    mesh_run = run_ranks(dist_train, 1, 101, SEED, mesh_out, timeout=300)[0]
    emit("dist_nccl_ws1", steps_parity=ws1, bars=TRAIN_PARITY,
         train_use_mesh={"steps": mesh_run["steps"],
                         "steps_per_s": mesh_run["steps"] / mesh_run["wall_s"],
                         "first_losses": mesh_run["losses"][:3],
                         "last_losses": mesh_run["losses"][-3:],
                         "loss_drop": loss_drop(mesh_run["losses"]),
                         "no_mesh_first_losses": rec_run["losses"][:3],
                         "cer": mesh_run["cer"],
                         "checkpoint": os.path.exists(mesh_out)},
         wall_s=time.perf_counter() - t, **CARD)
    if bad:
        return fail(f"one NCCL rank's dp x tp steps differ from make_train_step: {ws1}")
    # the same seed draws the same lines, and the schedules agree over the
    # warmup: the first losses equal the single-process trainer's
    if (mesh_run["group_left"] or not os.path.exists(mesh_out)
            or not all(math.isfinite(v) for v in mesh_run["losses"])
            or any(abs(a - b) > 5e-3 * abs(b) for a, b in zip(
                mesh_run["losses"][:3], rec_run["losses"][:3]))
            or loss_drop(mesh_run["losses"]) > 0.75):
        return fail(f"train(use_mesh=True) on one NCCL rank: {mesh_run['losses'][:3]} "
                    f"... {mesh_run['losses'][-3:]}")

    t = time.perf_counter()
    two = {}
    for label, model_axis in (("dp2", 1), ("tp2", 2)):
        two[label], bad = ranks_parity(2, "gloo", model_axis)
        if bad:
            emit("dist_two_ranks", **two, bars=TRAIN_PARITY, **CARD)
            return fail(f"two gloo ranks ({label}) differ from one process")
    emit("dist_two_ranks", **two, bars=TRAIN_PARITY,
         wall_s=time.perf_counter() - t, **CARD)

    # ------------------------------------------------ 12. dry run and entry
    from synapta_tpu_torch import graft_entry

    t = time.perf_counter()
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        graft_entry.dryrun_multichip(2, "cuda")  # raises unless it exits 0
    ok_lines = [ln for ln in captured.getvalue().splitlines()
                if ln.startswith("dryrun_multichip OK:")]
    emit("dryrun", shards=2, ranks=2, line=ok_lines[-1] if ok_lines else None,
         wall_s=time.perf_counter() - t, **CARD)
    if (len(ok_lines) != 1 or "pipeline mesh={'data': 2}" not in ok_lines[0]
            or "(1dev==2dev)" not in ok_lines[0]):
        return fail(f"dry run printed {captured.getvalue()[-500:]!r}")

    forward, (entry_model, entry_imgs) = graft_entry.entry("cuda")
    logits = forward(entry_model, entry_imgs)
    entry_ms = cuda_ms(lambda: forward(entry_model, entry_imgs))
    emit("entry", input=list(entry_imgs.shape), logits=list(logits.shape),
         dtype=str(logits.dtype), finite=bool(torch.isfinite(logits).all()),
         ms=entry_ms, **CARD)
    if (tuple(logits.shape) != (8, 96, 161) or not logits.is_cuda
            or not bool(torch.isfinite(logits).all())):
        return fail(f"entry(): logits {tuple(logits.shape)} on {logits.device}")

    if "--profile" in sys.argv[1:]:
        # optional: the 64-page book, the 16-page scanned book, one DB chunk
        # (model, then post stage) and one step of each trainer once more
        # under torch.profiler, for the device-busy share and device time by
        # kernel (not the timed runs)
        from synapta_tpu_torch.utils.profiler import torch_trace

        def profiled(label, fn):
            trace_dir = os.path.join(out_dir, f"trace_{label}")
            with torch_trace(trace_dir) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            path, = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
            # device time from the trace's kernel and copy events: the
            # operator rows of key_averages() repeat their kernels' time
            by_name = {}
            with open(path) as f:
                for ev in json.load(f)["traceEvents"]:
                    if ev.get("ph") == "X" and ev.get("cat") in (
                            "kernel", "gpu_memcpy", "gpu_memset"):
                        us, n = by_name.get(ev["name"], (0.0, 0))
                        by_name[ev["name"]] = (us + ev["dur"], n + 1)
            rows = sorted(((us, k, n) for k, (us, n) in by_name.items()),
                          reverse=True)
            busy_s = sum(r[0] for r in rows) / 1e6
            # beside it, the sum of every key_averages() row's self device
            # time over the same trace (operator rows count their kernels
            # again)
            rows_s = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages()) / 1e6
            emit(f"profile_{label}", wall_s=wall, device_busy_s=busy_s,
                 device_busy_share=busy_s / wall,
                 key_averages_self_device_s=rows_s,
                 top=[{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                      for us, k, n in rows[:15]], **CARD)

        profiled("64page", lambda: run(book64, os.path.join(tmp, "prof64"), "cuda"))
        profiled("64page_dp2", lambda: run(book64, os.path.join(tmp, "prof64dp"),
                                           "cuda", mesh=mesh2))
        profiled("scanned16", lambda: run(scan16, os.path.join(tmp, "prof_s16"),
                                          "cuda"))
        profiled("db_model", lambda: D.db_logits(det.model, db_gray))
        profiled("db_post", lambda: D.mask_boxes(D.closed_mask(
            db_logits_gpu, det.prob_thresh)))

        # one training step of each trainer as it runs in train(): the
        # host's batch, then the enqueued step, then the wait for its loss
        def train_step_of(model, make_step, gen, **betas):
            step = make_step(model, optim.adamw(model.parameters(), 1e-4,
                                                **betas))
            rng = np.random.default_rng(SEED + 7)
            for _ in range(2):  # warm up cuDNN's algorithm choice
                step(*gen(rng))
            return lambda: float(step(*gen(rng)))

        profiled("train_recognizer_step", train_step_of(
            rec_run["model"].train(), T.make_train_step,
            lambda r: make_batch(r, batch=64), b2=0.98))
        profiled("train_detector_step", train_step_of(
            det_run["model"].train(), D.make_det_train_step,
            lambda r: D.make_det_batch(r, batch=8)))

    # launches: the 64-page book's, the 16-page scanned book's and the
    # 2-shard 64-page book's runs; ms, plain_ms and bound_ms per analyze
    # chunk (the CC row's four analyze sites; the DB site per DB chunk under
    # "db_site"; a chunk as two half shards on two streams under "dp2")
    print(json.dumps({"kernels": [
        {"name": "connected_components", "route": "cuda",
         "source": "synapta_tpu_torch/csrc/cc.cu",
         "replaces": "synapta_tpu/ops/pallas_cc.py:100",
         "launches": launches["cc"] + scan_launches["cc"] + dp_launches["cc"],
         "max_abs_err": cc_err,
         "ms": cc_ms, "plain_ms": cc_plain_ms, "bound_ms": cc_bound_ms,
         "bound_by": cc_bound_by, "library_ms": None,
         "sites": len(cc_checked), "site_names": cc_checked,
         "launches_by_path": {"book64": launches["cc"],
                              "scanned16": scan_launches["cc"],
                              "book64_dp2": dp_launches["cc"]},
         "db_native_launches": native_cc_launches,
         "dp2": {"shape": dp_rows[0]["shape"], "ms": dp_cc_ms,
                 "plain_ms": dp_cc_plain_ms},
         "db_site": {"ms": db_row["ms"], "plain_ms": db_row["plain_ms"],
                     "bound_ms": db_row["bound_ms"],
                     "bound_by": db_row["bound_by"]}},
        # ms, plain_ms, max_abs_err and bound_ms are the default route's (the
        # one every path above ran); "routes" has both
        {"name": "fused_edge_stats", "route": "cuda",
         "source": "synapta_tpu_torch/csrc/edge_stats.cu",
         "replaces": "synapta_tpu/ops/pallas_kernels.py:162",
         "launches": (launches["edge_stats"] + scan_launches["edge_stats"]
                      + dp_launches["edge_stats"]),
         "max_abs_err": edge["default"]["max_abs_err"],
         "ms": edge["default"]["ms"], "plain_ms": edge["default"]["plain_ms"],
         "bound_ms": edge["default"]["bound_ms"],
         "bound_by": edge["default"]["bound_by"], "library_ms": None,
         "routes": {r: {k: row[k] for k in ("ms", "plain_ms", "max_abs_err",
                                            "bound_ms", "bound_by")}
                    for r, row in edge.items()},
         "launches_by_path": edge_by_path,
         "dp2": {"shape": list(gray_halves[0].shape), **dp_edge}},
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
