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
  a 16-page one through eval.evaluate_scanned (0 errors, CER <= 0.025);
  ``DBLineDetector.detect_lines`` on a drawn crop that takes the
  native-resolution path (2 x 2 views of 512², ``db_native``);
- serve.BookQueue(device="cuda") over a test book and a scanned book: both
  done with 0 errors, and a second run skips both;
- ``python -m synapta_tpu_torch.bench`` at 64 pages and 2 reps in a process
  of its own (its last line, no errors, the two reps' JSON the same under
  the table, ``bench_small``); the vision LLM on, the 8-page book with a
  fake client that answers after 0.2 s (every analysis patched in late), the
  GPU against the CPU under the table, beside the GPU's LLM-off wall
  (``llm_on``); the pixels handed to the client unchanged while 12 pages in
  batches of 2 recycle the loader's canvas ring (``llm_ring``); resume from
  the JSONL checkpoint, the second and third runs writing no segment
  (``resume``); Pillow's image-per-page book (whole-page rasters through the
  DB detector) and a /Rotate 90 scan, the GPU against the CPU under the
  table (``foreign_books``; the matplotlib and fontTools books run in the
  tier-1 tests only);
- the chunk shapes of scripts/torch_sweep.py (the JAX package's batch-shape
  sweep): both kernels against their twins at B = 32 and 64, timed beside
  their bounds, ``device_analyze`` on 32 crops against two 16-crop calls,
  the recognizer's 256-tile batch on the GPU against the CPU, and the
  64-page book at each of the six configurations, each one's JSON held to
  ``base``'s under the table (``sweep_shapes``); scripts/torch_real_corpus.py's
  ``build_book`` on 16 crops the 64-page run wrote (a JPEG image a page),
  the GPU against the CPU, every page an ``embedded_image`` segment
  (``crop_book``);
- ``make_diverse_book(seed=5)`` (two-column pages, a rotated axis label, a
  CMYK JPEG, two scanned-page rasters through the DB detector, a
  three-visual page), the book tests/test_torch_diverse.py holds to the JAX
  pipeline, on the GPU and on the CPU, each run under ``OCRRecorder``, its
  recognizer tiles and DB views evaluated again in bf16 and in float32 on
  its own device, and the GPU held to the CPU by the OCR yardstick
  (``ocr_yardstick``, ``db_yardstick``, ``judge_keys``): float32 logits
  within ``F32_LOGIT_BOUND``, the GPU's bf16 no farther from the CPU's than
  the CPU's bf16 from its own float32, and every key outside the table
  explained by a line that this excused (``e2e_diverse``);
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
16-page scanned, the LLM-on 8-page, the two foreign books', the six sweep
configurations', the crop book's, the diverse book's and the 2-shard
64-page runs and read
just after, with the route of every edge-stats launch
(all must be the default route's). Every
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
# the seed of make_diverse_book that tests/test_torch_diverse.py holds to the
# JAX pipeline
DIVERSE_SEED = 5
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
# python -m synapta_tpu_torch.bench at (pages, reps), and its last line's keys
BENCH_SMALL = (64, 2)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "runs", "spread"}
# seconds a call of the delayed fake vision LLM (the 8-page book's eight
# segments are built in ~0.05 s, so every analysis lands as a late patch)
LLM_DELAY_S = 0.2


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


def payload(out: str, book_id: str = "smoke") -> dict:
    """A run's ``{book_id}_visual_segments.json``, read back from disk."""
    with open(os.path.join(out, f"{book_id}_visual_segments.json")) as f:
        return json.load(f)


def payload_differences(out_a: str, out_b: str, book_id: str = "smoke"):
    """The keys of two runs' segment JSON outside ALLOWED_DIFFERENCES, the
    largest confidence differences (a text line's, 0..100, and a segment's
    mean, 0..1) and whether the summary CSVs are equal."""
    conf = {"block": 0.0, "mean": 0.0}
    outside = []
    for path, a, b in json_differences(payload(out_a, book_id),
                                       payload(out_b, book_id)):
        if (path.endswith(".confidence") and ".ocr_result." in path
                and isinstance(a, float) and isinstance(b, float)):
            kind = "block" if ".blocks[" in path else "mean"
            conf[kind] = max(conf[kind], abs(a - b))
        if allowed_difference(path, a, b) is None:
            outside.append([path, a, b])
    csvs = []
    for out in (out_a, out_b):
        with open(os.path.join(out, f"{book_id}_visual_summary.csv")) as f:
            csvs.append(f.read())
    return outside, conf, csvs[0] == csvs[1]


class OCRRecorder:
    """Records what one pipeline run hands its recognizer and its DB line
    detector. For every ``group_dispatch``: the tiles, owners, line boxes and
    parts that ``collect_tiles`` cut for each item, the crops whose boxes the
    DB detector drew, and the OCRResults that ``group_sync`` returned. For
    every ``_build_segment``: the id of the segment an OCRResult went into.
    For every DB chunk: the arguments of the detector module's boxes
    function (model or params, the (16, S, S) uint8 views, the threshold).
    Either package fits (the port's ``TorchOCR``, pipeline class and
    ``boxes_device``, the JAX package's ``TPUOCR``, pipeline class and
    ``_boxes_device``): the same method names, patched while the recorder
    is entered. Nothing here imports either package."""

    def __init__(self, ocr_cls, pipe_cls, det_module, boxes_fn: str):
        self.targets = [(ocr_cls, n) for n in
                        ("collect_tiles", "group_dispatch", "group_sync")]
        self.targets += [(pipe_cls, "_build_segment"), (det_module, boxes_fn)]
        self.groups, self.db_chunks, self.segment_of, self._cut = [], [], {}, []

    def __enter__(self):
        self.saved = [(obj, n, getattr(obj, n)) for obj, n in self.targets]
        collect, dispatch, sync, build, boxes = (fn for _, _, fn in self.saved)
        rec = self

        def collect_tiles(ocr, *a, **kw):
            out = collect(ocr, *a, **kw)
            rec._cut.append(out)
            return out

        def group_dispatch(ocr, items, submit=None):
            del rec._cut[:]
            state = dispatch(ocr, items, submit)
            rec.groups.append({"ocr": ocr, "state": state, "cut": rec._cut[:],
                               "db": [set(it.get("db_override") or ()) for it in items],
                               "results": None})
            return state

        def group_sync(ocr, state):
            out = sync(ocr, state)
            for g in rec.groups:
                if g["state"] is state:
                    g["results"], g["state"] = out, None
            return out

        def build_segment(pipe, region, f, ocr, *a, **kw):
            seg = build(pipe, region, f, ocr, *a, **kw)
            if seg is not None:
                rec.segment_of[id(ocr)] = seg.segment_id
            return seg

        def boxes_fn(model, chunk, thresh):
            import numpy as np

            rec.db_chunks.append({"model": model, "views": np.array(chunk),
                                  "prob_thresh": float(thresh)})
            return boxes(model, chunk, thresh)

        for (obj, n), fn in zip(self.targets, (collect_tiles, group_dispatch,
                                               group_sync, build_segment, boxes_fn)):
            setattr(obj, n, fn)
        return self

    def __exit__(self, *exc):
        for obj, n, fn in self.saved:
            setattr(obj, n, fn)

    def batches(self):
        """One dict a recognizer dispatch: its stacked (N, 32, W) uint8
        tiles as the pipeline stacked them, the OCR object that ran them, a
        key a tile that names it alike in any run of the same book
        (dispatch, item, crop, line box, the box's occurrence, part) and a
        label a tile (the segment id of its crop, or None for a crop the
        pipeline kept no segment of, its line box, and whether the DB
        detector drew that box)."""
        import numpy as np

        out = []
        for g, group in enumerate(self.groups):
            tiles, keys, labels = [], [], []
            for it, (item_tiles, owners, boxes, parts) in enumerate(group["cut"]):
                tiles.extend(item_tiles)
                seen = {}
                results = group["results"][it]
                for owner, box, (n, _) in zip(owners, boxes, parts):
                    box = [int(v) for v in box]
                    line = (g, it, int(owner), tuple(box))
                    seen[line] = seen.get(line, 0) + 1
                    for part in range(n):
                        keys.append(line + (seen[line], part))
                        labels.append({"segment": self.segment_of.get(id(results[owner])),
                                       "box": box, "db": owner in group["db"][it]})
            if len(tiles) != len(keys):
                raise RuntimeError(f"dispatch {g}: {len(tiles)} tiles, "
                                   f"{len(keys)} line parts")
            if tiles:
                out.append({"ocr": group["ocr"], "tiles": np.stack(tiles),
                            "keys": keys, "labels": labels})
        return out


# The OCR yardstick: how a candidate run's OCR may differ from a reference
# run's on the same book (the port on the CPU against the JAX pipeline in
# tests/test_torch_diverse.py, the card against the CPU in the e2e_diverse
# phase). Both packages' models run in bf16 in the pipeline and also in
# float32 here, on the tiles and DB views each run recorded (OCRRecorder).
# (a) In float32 the two runs compute the same function. (b) In bf16 the
# candidate stands no farther from the reference than the reference stands
# from its own float32 answer. (c) A key of the segment JSON outside
# ALLOWED_DIFFERENCES, or a cell of the CSV, may differ only where it reads
# a line whose bf16 greedy paths differ (or whose DB box differs, under (b)
# of the DB maps); a line whose paths agree keeps the table's confidence
# bound unless the reference's own bf16 confidence of that line differs
# from its float32 one by at least as much. Its only two constants:
#
# (a) the largest |logit difference| between the two runs' float32 models,
# on a recognizer tile and on a DB map; a frame's float32 greedy choice, and
# a DB pixel's side of the threshold, may differ only within it of a tie
# (measured 2.9e-5 between the port's and the JAX recognizer on the diverse
# book, CPU)
F32_LOGIT_BOUND = 1e-3
# (b) the candidate's |bf16 - float32| logit error (the largest of a tile)
# over the reference's, at most, at each of ERROR_QUANTILES of the tiles
# (measured 0.97-0.995, port against JAX on the diverse book, CPU)
ERROR_RATIO_MAX = 1.10
ERROR_QUANTILES = (50, 90, 99, 100)
# (c) the keys that read a segment's OCR lines (the path after
# "segments[i]."): its lines' keys, judged line by line ...
OCR_LINE_KEYS = r"ocr_result\.blocks(\[\d+\].*)?"
# ... and the segment's own OCR keys and the text leaves derived from its
# lines' texts (node texts, axis labels, tick labels, legend items,
# structured text), excused where one of its lines is; a node's box and id,
# the counts and ranges stay exact
OCR_SEGMENT_KEYS = (
    r"ocr_result\.(raw_text|confidence|node_texts(\[\d+\])?"
    r"|legend_items(\[\d+\])?|tick_labels\.[xy]_axis(\[\d+\])?"
    r"|axis_labels\.[xy])"
    r"|chart_data\.(tick_labels\.[xy]_axis(\[\d+\])?|legend_items(\[\d+\])?"
    r"|axes_info\.[xy]_axis\.label)"
    r"|chart_details\.(tick_labels\.[xy]_axis(\[\d+\])?|legend(\[\d+\])?"
    r"|axes\.[xy]_axis\.label)"
    r"|diagram_(data|details)\.nodes\[\d+\]\.text"
    r"|extracted_text_structured(\.[^.\[]+(\[\d+\])?)?")
OCR_CSV_COLUMNS = ("ocr_text",)  # the summary CSV's cell of raw_text


def port_tile_logits(model, tiles, line_batch: int):
    """(N, 32, W) uint8 tiles -> (N, W/4, C) float32 logits of the port's
    recognizer ``model`` on its device, in chunks of ``line_batch`` padded
    with white tiles as ``recognize_dispatch`` pads them, normalised as
    ``_decode`` normalises them."""
    import numpy as np
    import torch

    dev = next(model.parameters()).device
    out = []
    with torch.inference_mode():
        for start in range(0, tiles.shape[0], line_batch):
            chunk = tiles[start:start + line_batch]
            pad = np.full((line_batch - chunk.shape[0],) + chunk.shape[1:], 255,
                          np.uint8)
            x = torch.from_numpy(np.concatenate([chunk, pad])).to(dev)
            logits = model(x.to(torch.float32)[:, None] / 255.0)
            out.append(logits[:chunk.shape[0]].float().cpu().numpy())
    return np.concatenate(out)


def port_evaluation(rec: OCRRecorder, f32_model, f32_det):
    """The port run's recorded batches, each with its bf16 logits (the
    run's own model), float32 logits (``f32_model``) and bf16 greedy
    paths; and its DB chunks, each with the run's bf16 logits and
    ``f32_det``'s float32 logits."""
    from synapta_tpu_torch.models.detector import db_logits

    batches = rec.batches()
    for b in batches:
        lb = b["ocr"].cfg.line_batch
        b["bf16"] = port_tile_logits(b["ocr"].model, b["tiles"], lb)
        b["f32"] = port_tile_logits(f32_model, b["tiles"], lb)
        b["paths"] = b["bf16"].argmax(-1)  # as _decode takes them
    db = [{"views": c["views"], "prob_thresh": c["prob_thresh"],
           "bf16": db_logits(c["model"], c["views"]).float().cpu().numpy(),
           "f32": db_logits(f32_det, c["views"]).float().cpu().numpy()}
          for c in rec.db_chunks]
    return batches, db


def db_yardstick(ref, cand):
    """(a) and (b) on the DB maps of two runs' DB chunks (each a dict:
    ``views`` (B, S, S) uint8, ``prob_thresh``, ``bf16`` and ``f32``
    (B, S/2, S/2) logits). Views are paired in order and must be equal;
    the padding views (all white) are left out. A mask is the pipeline's
    ``sigmoid(logit) > prob_thresh``; the closing after it is exact, so
    only the threshold lets a float difference through."""
    import numpy as np
    import torch

    rep = {"chunks": [len(ref), len(cand)], "views": 0, "inputs_equal": True,
           "f32_max_abs_logit_diff": 0.0, "f32_flipped_pixels": 0,
           "f32_flips_off_the_threshold": 0, "bf16_flipped_pixels": 0,
           "bf16_views_flipped": 0, "ref_bf16_vs_f32_flipped_pixels": 0,
           "cand_bf16_vs_f32_flipped_pixels": 0, "bf16_max_abs_logit_diff": 0.0}
    if len(ref) != len(cand):
        rep.update(ok_a=False, ok_b=False)
        return rep
    for r, c in zip(ref, cand):
        if not np.array_equal(r["views"], c["views"]):
            rep["inputs_equal"] = False
            continue
        p = r["prob_thresh"]
        real = (r["views"] != 255).reshape(len(r["views"]), -1).any(1)
        rep["views"] += int(real.sum())
        lg = {"r16": r["bf16"][real], "r32": r["f32"][real],
              "c16": c["bf16"][real], "c32": c["f32"][real]}
        m = {k: (torch.sigmoid(torch.from_numpy(np.ascontiguousarray(v))) > p)
             .numpy() for k, v in lg.items()}
        thr = math.log(p / (1.0 - p))
        near = ((np.abs(lg["r32"] - thr) <= F32_LOGIT_BOUND)
                | (np.abs(lg["c32"] - thr) <= F32_LOGIT_BOUND))
        flips32 = m["r32"] != m["c32"]
        flips16 = m["r16"] != m["c16"]
        rep["f32_max_abs_logit_diff"] = max(rep["f32_max_abs_logit_diff"], float(
            np.abs(lg["r32"] - lg["c32"]).max(initial=0.0)))
        rep["bf16_max_abs_logit_diff"] = max(rep["bf16_max_abs_logit_diff"], float(
            np.abs(lg["r16"] - lg["c16"]).max(initial=0.0)))
        rep["f32_flipped_pixels"] += int(flips32.sum())
        rep["f32_flips_off_the_threshold"] += int((flips32 & ~near).sum())
        rep["bf16_flipped_pixels"] += int(flips16.sum())
        rep["bf16_views_flipped"] += int(flips16.reshape(len(flips16), -1)
                                         .any(1).sum())
        rep["ref_bf16_vs_f32_flipped_pixels"] += int((m["r16"] != m["r32"]).sum())
        rep["cand_bf16_vs_f32_flipped_pixels"] += int((m["c16"] != m["c32"]).sum())
    rep["ok_a"] = (rep["inputs_equal"]
                   and rep["f32_max_abs_logit_diff"] <= F32_LOGIT_BOUND
                   and rep["f32_flips_off_the_threshold"] == 0)
    rep["ok_b"] = rep["bf16_flipped_pixels"] <= rep["ref_bf16_vs_f32_flipped_pixels"]
    return rep


def ocr_yardstick(ref, cand, db=None) -> dict:
    """(a) and (b) on the recognizer, over two runs' recorded batches (each
    a dict as ``OCRRecorder.batches`` makes it, with ``bf16`` and ``f32``
    logits and the bf16 greedy ``paths``), and on the DB maps (``db``, the
    report of ``db_yardstick``, or None where no DB chunk ran). Tiles are
    paired by key and must be equal. A tile of one run without a partner in
    the other (its DB line box differs) is excused only where the DB
    detector drew its box and the DB maps meet (a) and (b); ``unpaired``
    lists each such line once. Returns the
    report: the counts and quantiles, every excused tile (its segment, box,
    both texts and the frames that differ, with each model's two most likely
    characters and its logit gap between them), ``excused_lines`` and
    ``confidence_lines`` (segment, box and the reference's own bf16 against
    float32 confidence difference of each line whose paths agree but whose
    confidence passes the table's bound and no farther than that) for
    ``judge_keys``, and ``ok``."""
    import numpy as np

    from synapta_tpu_torch.models.charset import BLANK, decode_greedy_batch

    def flat(batches):
        keys = [k for b in batches for k in b["keys"]]
        run = {n: np.concatenate([b[n] for b in batches])
               for n in ("tiles", "bf16", "f32", "paths")}
        run["labels"] = [lab for b in batches for lab in b["labels"]]
        run["index"] = {k: i for i, k in enumerate(keys)}
        run["keys"] = keys
        return run

    R, C = flat(ref), flat(cand)
    ri = np.array([R["index"][k] for k in R["keys"] if k in C["index"]], np.int64)
    ci = np.array([C["index"][k] for k in R["keys"] if k in C["index"]], np.int64)
    unpaired = []  # a line a run, with its count of tiles
    for name, run, other in (("ref", R, C), ("cand", C, R)):
        for k, i in run["index"].items():
            if k not in other["index"]:
                line = dict(run["labels"][i], run=name, tiles=1)
                if unpaired and {**unpaired[-1], "tiles": 1} == line:
                    unpaired[-1]["tiles"] += 1
                else:
                    unpaired.append(line)
    tiles_differ = [R["labels"][i] for i, j in zip(ri, ci)
                    if not np.array_equal(R["tiles"][i], C["tiles"][j])]

    def gap(logits):  # top-1 minus top-2 logit a frame
        top = np.sort(logits, axis=-1)[..., -2:]
        return top[..., 1] - top[..., 0]

    def char(c):
        return "blank" if c == BLANK else decode_greedy_batch(np.array([[c]]))[0]

    def top2(logits):
        a, b = np.argsort(-logits)[:2]
        return [char(a), char(b)], float(logits[a] - logits[b])

    # (a) float32: the same function
    r32, c32 = R["f32"][ri], C["f32"][ci]
    f32_diff = np.abs(r32 - c32).max(axis=(1, 2), initial=0.0)
    r32p, c32p = r32.argmax(-1), c32.argmax(-1)
    differ = r32p != c32p
    tie = np.minimum(gap(r32), gap(c32)) <= F32_LOGIT_BOUND
    a = {"tiles": len(ri), "max_abs_logit_diff": float(f32_diff.max(initial=0.0)),
         "paths_differ": int(differ.any(-1).sum()),
         "frames_differ": int(differ.sum()),
         "frames_differ_at_a_tie": int((differ & tie).sum())}
    a["ok"] = (not tiles_differ and a["max_abs_logit_diff"] <= F32_LOGIT_BOUND
               and a["frames_differ"] == a["frames_differ_at_a_tie"])
    del r32, c32

    # (b) bf16: no farther from the reference than it is from itself
    rp, cp = R["paths"][ri], C["paths"][ci]
    rt, ct = decode_greedy_batch(rp), decode_greedy_batch(cp)
    rt32, ct32 = decode_greedy_batch(r32p), decode_greedy_batch(c32p)
    path_differs = (rp != cp).any(-1)
    r_err = np.abs(R["bf16"][ri] - R["f32"][ri]).max(axis=(1, 2), initial=0.0)
    c_err = np.abs(C["bf16"][ci] - C["f32"][ci]).max(axis=(1, 2), initial=0.0)
    q_r = np.percentile(r_err, ERROR_QUANTILES) if len(ri) else np.zeros(4)
    q_c = np.percentile(c_err, ERROR_QUANTILES) if len(ci) else np.zeros(4)
    ratio = [float(x / y) if y > 0 else (math.inf if x > 0 else 1.0)
             for x, y in zip(q_c, q_r)]
    b = {"text_differs": sum(x != y for x, y in zip(ct, rt)),
         "paths_differ": int(path_differs.sum()),
         "ref_bf16_vs_f32_text_differs": sum(x != y for x, y in zip(rt, rt32)),
         "ref_bf16_vs_f32_paths_differ": int((rp != r32p).any(-1).sum()),
         "cand_bf16_vs_f32_text_differs": sum(x != y for x, y in zip(ct, ct32)),
         "cand_bf16_vs_f32_paths_differ": int((cp != c32p).any(-1).sum()),
         "error_quantiles": {"q": list(ERROR_QUANTILES),
                             "ref": [float(x) for x in q_r],
                             "cand": [float(x) for x in q_c], "ratio": ratio}}
    b["ok"] = (b["text_differs"] <= b["ref_bf16_vs_f32_text_differs"]
               and all(x <= ERROR_RATIO_MAX for x in ratio))

    def confidence(logits, paths):  # a tile's line confidence, 0..100
        z = logits - logits.max(-1, keepdims=True)
        p = np.take_along_axis(np.exp(z), paths[..., None], -1)[..., 0] / np.exp(
            z).sum(-1)
        nonblank = paths != BLANK
        return 100.0 * np.where(nonblank, p, 0.0).sum(-1) / np.maximum(
            nonblank.sum(-1), 1)

    excused, lines = [], set()
    for n in np.nonzero(path_differs)[0]:
        i, j = ri[n], ci[n]
        lab = R["labels"][i]
        frames = []
        for f in np.nonzero(R["paths"][i] != C["paths"][j])[0]:
            (r_top, r_gap), (c_top, c_gap) = top2(R["bf16"][i, f]), top2(C["bf16"][j, f])
            frames.append({"frame": int(f), "ref": r_top, "ref_logit_gap": r_gap,
                           "cand": c_top, "cand_logit_gap": c_gap})
        excused.append({"segment": lab["segment"], "box": lab["box"],
                        "texts": [rt[n], ct[n]], "f32_texts": [rt32[n], ct32[n]],
                        "frames": frames})
        lines.add((lab["segment"], tuple(lab["box"])))
    db_ok = db is not None and db["ok_a"] and db["ok_b"]
    unpaired_ok = not unpaired or (db_ok and all(u["db"] for u in unpaired))
    for u in unpaired:
        lines.add((u["segment"], tuple(u["box"])))

    # (c) a line's confidence where the greedy paths of all its parts agree,
    # as merge_parts folds its parts' (the mean of those with text): the
    # candidate's against the reference's, and the reference's bf16 against
    # its own float32 answer on the same line. A line farther apart than the
    # table's block bound is listed, and excused where the reference's own
    # difference is at least as large.
    conf = {"ref": (confidence(R["bf16"][ri], rp), rt),
            "cand": (confidence(C["bf16"][ci], cp), ct),
            "ref_f32": (confidence(R["f32"][ri], r32p), rt32)}
    parts = {}
    for n, i in enumerate(ri):
        parts.setdefault(R["keys"][i][:5], []).append(n)
    over, largest = [], 0.0
    for ns in parts.values():
        lab = R["labels"][ri[ns[0]]]
        if path_differs[ns].any() or (lab["segment"], tuple(lab["box"])) in lines:
            continue
        v = {}
        for k, (c, texts) in conf.items():
            kept = [float(c[n]) for n in ns if texts[n].strip()]
            v[k] = float(np.mean(kept)) if kept else 0.0
        largest = max(largest, abs(v["cand"] - v["ref"]))
        if allowed_difference("segments[0].ocr_result.blocks[0].confidence",
                              v["ref"], v["cand"]) is None:
            over.append({"segment": lab["segment"], "box": lab["box"], **v,
                         "excused": abs(v["cand"] - v["ref"])
                         <= abs(v["ref"] - v["ref_f32"])})
    b["confidence"] = {"max_abs_diff": largest, "lines_over_table": over}
    report = {"tiles": [len(R["keys"]), len(C["keys"])], "paired": len(ri),
              "tiles_differ": tiles_differ, "unpaired": unpaired,
              "float32": a, "bf16": b, "db": db, "excused_tiles": excused,
              "excused_lines": sorted(lines, key=str),
              "confidence_lines": [(o["segment"], o["box"],
                                    abs(o["ref"] - o["ref_f32"]))
                                   for o in over if o["excused"]]}
    report["ok"] = bool(a["ok"] and b["ok"] and unpaired_ok
                        and (db is None or db_ok))
    return report


def judge_keys(out_ref: str, out_cand: str, report: dict, book_id: str = "smoke"):
    """(c): every key of the two runs' segment JSON outside
    ALLOWED_DIFFERENCES, and every cell of the CSVs, is equal unless it
    reads a line that ``ocr_yardstick``'s ``report`` excused (its
    ``excused_lines``, pairs of segment id and line box). A segment's blocks
    are compared with the excused lines' blocks left out of both lists
    (under the table); its OCR_SEGMENT_KEYS and its OCR_CSV_COLUMNS cell may
    differ where it has an excused line. A line of the report's
    ``confidence_lines`` may pass the table's confidence bound by as much as
    the reference's own bf16 confidence of that line differs from its float32
    one; its segment's mean is held to the table with that line's
    difference taken out. -> {"faults": [[path, ref, cand]], "excused_keys":
    n, "excused_segments": {index: lines}}"""
    import csv

    P, Q = payload(out_ref, book_id), payload(out_cand, book_id)
    index = {s["segment_id"]: i for i, s in enumerate(P.get("segments", []))}
    boxes, own = {}, {}
    for sid, box in report["excused_lines"]:
        if sid in index:
            boxes.setdefault(index[sid], set()).add(tuple(box))
    for sid, box, d in report["confidence_lines"]:
        if sid in index:
            lines = own.setdefault(index[sid], {})
            lines[tuple(box)] = min(d, lines.get(tuple(box), d))

    def blocks(seg):
        return seg["ocr_result"]["blocks"] if seg.get("ocr_result") else []

    shift = {}  # a segment's mean confidence: what its own-excused lines moved
    for s, lines in own.items():
        a, b = blocks(P["segments"][s]), blocks(Q["segments"][s])
        if len(a) == len(b) and a:
            shift[s] = sum(y["confidence"] - x["confidence"] for x, y in zip(a, b)
                           if tuple(x["bbox"]) in lines) / (100.0 * len(a))

    def tolerated(path, a, b, listed=None):
        if allowed_difference(path, a, b) is not None:
            return True
        if not (isinstance(a, float) and isinstance(b, float)):
            return False
        m = re.fullmatch(r"segments\[(\d+)\]\.ocr_result\.(blocks\[(\d+)\]\.)?"
                         r"confidence", path)
        if not m or int(m.group(1)) not in own:
            return False
        s = int(m.group(1))
        if m.group(2) is None:
            return s in shift and allowed_difference(path, a, b - shift[s]) is not None
        block = (listed or blocks(P["segments"][s]))[int(m.group(3))]
        d = own[s].get(tuple(block["bbox"]))
        return d is not None and abs(a - b) <= d

    faults, excused = [], 0
    for path, a, b in json_differences(P, Q):
        if tolerated(path, a, b):
            excused += allowed_difference(path, a, b) is None
            continue
        m = re.fullmatch(r"segments\[(\d+)\]\.(.*)", path)
        if m and int(m.group(1)) in boxes and (
                re.fullmatch(OCR_LINE_KEYS, m.group(2))
                or re.fullmatch(OCR_SEGMENT_KEYS, m.group(2))):
            excused += not re.fullmatch(OCR_LINE_KEYS, m.group(2))
            continue
        faults.append([path, a, b])
    for s, lines in boxes.items():
        kept = [[blk for blk in seg["segments"][s]["ocr_result"]["blocks"]
                 if tuple(blk["bbox"]) not in lines] for seg in (P, Q)]
        n_left = sum(len(seg["segments"][s]["ocr_result"]["blocks"]) - len(k)
                     for seg, k in zip((P, Q), kept))
        excused += n_left
        for path, a, b in json_differences(
                *kept, f"segments[{s}].ocr_result.blocks"):
            if not tolerated(path, a, b, kept[0]):
                faults.append([path + " (excused lines left out)", a, b])
    rows = []
    for out in (out_ref, out_cand):
        with open(os.path.join(out, f"{book_id}_visual_summary.csv"),
                  newline="") as f:
            rows.append(list(csv.reader(f)))
    if len(rows[0]) != len(rows[1]) or not rows[0]:
        faults.append(["csv rows", len(rows[0]), len(rows[1])])
    else:
        header = rows[0][0]
        for r, (x, y) in enumerate(zip(*rows)):
            if len(x) != len(y):
                faults.append([f"csv[{r}]", x, y])
            for c, (u, v) in enumerate(zip(x, y)):
                if u == v:
                    continue
                if r >= 1 and r - 1 in boxes and header[c] in OCR_CSV_COLUMNS:
                    excused += 1
                else:
                    faults.append([f"csv[{r}][{header[c]}]", u, v])
    return {"faults": faults, "excused_keys": excused,
            "excused_segments": {s: sorted(v) for s, v in sorted(boxes.items())}}


def helper_module(name: str, folder: str = "tests"):
    """A jax-free helper module of the repo's tests/ (or scripts/), loaded
    from its file: the directory is no package, and a ``tests`` package
    installed on the machine would take its place under
    ``import tests.<name>``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_{folder}_{name}", os.path.join(HERE, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rotated_scan_pdf(path: str) -> None:
    """The rotated scan of tests/test_pipeline.py::
    test_rotated_scanned_page_end_to_end: a 100 x 140 RGB image stored
    landscape and drawn sideways on a 792 x 612 page with /Rotate 90, so it
    displays portrait as an upright 300 x 400 region at (156, 196, 456, 596)
    of 612 x 792."""
    import zlib

    import numpy as np

    _pdf = helper_module("fontfixtures")._pdf

    H, W = 140, 100
    img = np.full((H, W, 3), 235, np.uint8)
    img[10:60, 10:90] = [40, 80, 160]
    rng = np.random.RandomState(7)
    img[10:60, 10:90] += rng.randint(0, 60, (50, 80, 3)).astype(np.uint8)
    img[80:130, 20:80] = 30
    raw = zlib.compress(img.tobytes())
    content = b"q 0 -300 400 0 196 456 cm /Im1 Do Q"
    pdf = _pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 792 612] "
        b"/Rotate 90 /Contents 4 0 R /Resources "
        b"<< /XObject << /Im1 5 0 R >> >> >>",
        b"<< /Length " + str(len(content)).encode() +
        b" >>\nstream\n" + content + b"\nendstream",
        b"<< /Type /XObject /Subtype /Image /Width " + str(W).encode() +
        b" /Height " + str(H).encode() +
        b" /ColorSpace /DeviceRGB /BitsPerComponent 8 "
        b"/Filter /FlateDecode /Length " + str(len(raw)).encode() +
        b" >>\nstream\n" + raw + b"\nendstream",
    ])
    with open(path, "wb") as f:
        f.write(pdf)


def modules_found(*names) -> dict:
    """Whether each Python module can be imported here (none is imported)."""
    import importlib.util

    return {name: importlib.util.find_spec(name) is not None for name in names}


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
    from synapta_tpu_torch.bench import card_line

    smi_line = card_line(torch.device("cuda"))
    device_name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    CARD.update(card=smi_line)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=device_name, capability=list(cap), count=torch.cuda.device_count(),
         python=sys.version.split()[0],
         headers=headers_found("jpeglib.h", "zlib.h"),
         modules=modules_found("matplotlib", "fontTools"), **CARD)
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
    def site_masks(gray, rgb_q):
        """The four main-path CC call sites of an analyze chunk:
        {site: (mask, cap, connectivity)}."""
        with torch.inference_mode():
            feats = _core_features(gray, rgb_q)
            ink, vink, bg = feats["_ink"], feats["_vink"], feats["_bg"]
            return {
                "ink_blobs": (downsample2(ink), 6, 8),
                "vink_bars": (downsample2_min(vink), 4, 8),
                "enclosed_bg": (downsample2(_enclosed_mask(1.0 - bg)), 6, 4),
                "text_lines": (downsample2(fuse_text_mask(ink)), 10, 8),
            }

    main_masks = site_masks(gray_u8, rgb_q)
    gen = np.random.default_rng(SEED)
    rand = torch.from_numpy(
        (gen.random((16, 256, 256)) < 0.45).astype(np.float32)).to(dev)

    def cc_site(site, mask, iters, conn, rand=rand):
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
        if len(tiles) >= 256:  # 128 here, 256 for the sweep's lb256 batch
            break
    tiles256 = np.stack(tiles[:256])
    tiles = tiles256[:128]
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

    def run(pdf, out, device, mesh=None, config=None, llm_client=None,
            use_mermaid=False, resume=False):
        pipe = VisualSegmentationPipeline(
            book_id="smoke", pdf_path=pdf, output_dir=out,
            use_mermaid=use_mermaid,
            config=config or PipelineConfig(use_vision_llm=False),
            llm_client=llm_client or DisabledClient(), resume=resume,
            device=device,
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

    # ------------------------------------------------ 8b. bench, LLM, books
    # python -m synapta_tpu_torch.bench at 64 pages and 2 reps, in a process
    # of its own (it loads the library built above): its contract line, no
    # errors, and the two reps' segment JSON the same under the table
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "synapta_tpu_torch.bench", "--device", "cuda"],
        cwd=HERE, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, SYNAPTA_BENCH_PAGES=str(BENCH_SMALL[0]),
                 SYNAPTA_BENCH_RUNS=str(BENCH_SMALL[1])))
    lines = res.stdout.strip().splitlines()
    reps = [json.loads(ln) for ln in lines if ln.startswith('{"rep"')]
    try:
        summary = json.loads(lines[-1])
    except (IndexError, ValueError):
        summary = None
    outside, conf_diff, csv_equal = ([], {}, False) if len(reps) < 2 else (
        payload_differences(reps[0]["out"], reps[-1]["out"], "textbook_001"))
    emit("bench_small", rc=res.returncode, pages=BENCH_SMALL[0],
         card_line=lines[0] if lines else None, summary=summary,
         reps=[{k: r[k] for k in ("pages_per_s", "wall_s", "segments", "errors")}
               for r in reps],
         keys_outside_table=len(outside), differing_keys=outside[:20],
         confidence_max_abs_diff=conf_diff, csv_equal=csv_equal,
         stderr_tail=res.stderr[-2000:] if res.returncode else "",
         wall_s=time.perf_counter() - t, **CARD)
    if (res.returncode or summary is None or set(summary) != BENCH_KEYS
            or summary["unit"] != "pages/s" or len(reps) != BENCH_SMALL[1]):
        return fail(f"bench: rc {res.returncode}, last line {summary}, "
                    f"{len(reps)} rep lines")
    if outside or not csv_equal:
        return fail(f"bench: the two reps' JSON differ outside the table: "
                    f"{outside[:5]}, csv equal {csv_equal}")

    # the vision LLM on: the 8-page book with a delayed fake client (every
    # analysis lands late, through writer.update()), the card against the CPU;
    # counters start at 0 before the card's LLM-on run and are read after it
    from synapta_tpu_torch.bench import DelayedFakeClient
    from synapta_tpu_torch.llm.fake import FakePixtralClient

    t = time.perf_counter()
    _, _, w_off = run(book8, os.path.join(tmp, "llm_off"), "cuda", use_mermaid=True)
    llm = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            connected_components_cuda.launches = 0
            fused_edge_stats_cuda.launches = 0
            del routes_seen[:]
        client = DelayedFakeClient(LLM_DELAY_S, workers=16)
        p_llm, s_llm, w_llm = run(book8, os.path.join(tmp, f"llm_{device}"), device,
                                  llm_client=client, use_mermaid=True)
        client.shutdown()
        if device == "cuda":
            llm_launches = {"cc": connected_components_cuda.launches,
                            "edge_stats": fused_edge_stats_cuda.launches}
            edge_by_path["book8_llm_on"] = edge_launches()
        methods = {s["classification_method"] for s in payload(
            os.path.join(tmp, f"llm_{device}"))["segments"]}
        llm[device] = {"segments": len(s_llm), "errors": p_llm.stats.errors,
                       "llm_patches": p_llm.stats.llm_patches,
                       "llm_unpatched": p_llm.stats.llm_unpatched,
                       "llm_drain_wait_s": p_llm.stats.llm_drain_wait_s,
                       "calls": len(client.calls), "methods": sorted(methods),
                       "wall_s": w_llm}
    outside, conf_diff, csv_equal = payload_differences(
        os.path.join(tmp, "llm_cuda"), os.path.join(tmp, "llm_cpu"))
    emit("llm_on", delay_s=LLM_DELAY_S, runs=llm, wall_s_cuda_llm_off=w_off,
         wall_s_cuda_llm_on=llm["cuda"]["wall_s"], launches=llm_launches,
         keys_outside_table=len(outside), differing_keys=outside[:20],
         confidence_max_abs_diff=conf_diff, csv_equal=csv_equal,
         elapsed_phase_s=time.perf_counter() - t, **CARD)
    if any(r["errors"] or r["llm_unpatched"] or r["segments"] != 8
           or r["llm_patches"] != r["segments"]
           or r["methods"] != ["mistral_vision_comprehensive"] for r in llm.values()):
        return fail(f"LLM on: errors, unpatched or missing patches: {llm}")
    if outside or not csv_equal or edge_by_path["book8_llm_on"] is None:
        return fail(f"LLM on: the cuda and cpu JSON payloads differ outside the "
                    f"table: {outside[:5]}, csv equal {csv_equal}, edge-stats "
                    f"routes {edge_by_path['book8_llm_on']}")

    # pixels handed to the LLM client never change after the submit, while
    # 12 pages in batches of 2 wrap the loader's canvas ring
    import zlib

    class RecordingClient(FakePixtralClient):
        def __init__(self):
            super().__init__()
            self.records = []  # (crc at submit, the submitted array)

        def submit_comprehensive(self, pixels, ocr):
            self.records.append((zlib.crc32(np.ascontiguousarray(pixels)), pixels))
            return super().submit_comprehensive(pixels, ocr)

    ring_pdf = os.path.join(tmp, "ring12.pdf")
    make_test_book(ring_pdf, pages=12, seed=13)
    recorder = RecordingClient()
    p_ring, _, w_ring = run(ring_pdf, os.path.join(tmp, "ring"), "cuda",
                            config=PipelineConfig(use_vision_llm=False,
                                                  pages_per_batch=2),
                            llm_client=recorder)
    changed = [i for i, (crc, arr) in enumerate(recorder.records)
               if zlib.crc32(np.ascontiguousarray(arr)) != crc]
    emit("llm_ring", pages=12, pages_per_batch=2,
         submissions=len(recorder.records), changed_after_submit=changed,
         errors=p_ring.stats.errors, wall_s=w_ring, **CARD)
    if len(recorder.records) < 10 or changed or p_ring.stats.errors:
        return fail(f"LLM ring: {len(recorder.records)} submissions, changed "
                    f"{changed}, {p_ring.stats.errors} errors")

    # resume from the JSONL checkpoint: the second and third runs write no
    # segment, the third with the PNG encoder swapped (ids hash raw pixels)
    import unittest.mock as mock

    t = time.perf_counter()
    resume_out = os.path.join(tmp, "resume")
    resumed = [run(book8, resume_out, "cuda", use_mermaid=True, resume=True)[0]]
    resumed.append(run(book8, resume_out, "cuda", use_mermaid=True, resume=True)[0])
    with mock.patch("synapta_tpu_torch.io.ingest.png_encode",
                    side_effect=RuntimeError("encoder swapped")):
        resumed.append(run(book8, resume_out, "cuda", use_mermaid=True,
                           resume=True)[0])
    written = [p.stats.segments for p in resumed]
    total = payload(resume_out)["total_segments"]
    emit("resume", segments_written=written, total_segments=total,
         errors=[p.stats.errors for p in resumed], wall_s=time.perf_counter() - t,
         **CARD)
    if written[0] == 0 or written[1:] != [0, 0] or total != written[0] or any(
            p.stats.errors for p in resumed):
        return fail(f"resume: segments written {written}, total {total}")

    # books from foreign toolchains on the card against the CPU: Pillow's
    # image-per-page book (whole-page rasters: the DB detector and the CC
    # kernel's fifth call site) and the /Rotate 90 scan; counters start at 0
    # before each card run and are read after it
    make_pil_book = helper_module("corpus").make_pil_book

    t = time.perf_counter()
    pil_pdf = os.path.join(tmp, "pilbook.pdf")
    make_pil_book(pil_pdf, pages=4)
    rot_pdf = os.path.join(tmp, "rotscan.pdf")
    rotated_scan_pdf(rot_pdf)
    books = {}
    for label, pdf, kw in (
            ("pilbook", pil_pdf, {"config": PipelineConfig(
                use_vision_llm=False, pages_per_batch=4), "use_mermaid": True}),
            ("rotscan", rot_pdf, {})):
        connected_components_cuda.launches = 0
        fused_edge_stats_cuda.launches = 0
        del routes_seen[:], db_chunks[:]
        chunks0 = TIMERS.counts.get("features_dispatch", 0)
        D.boxes_device = counted_boxes
        try:
            p_gpu, s_gpu, w_gpu = run(pdf, os.path.join(tmp, f"{label}_cuda"),
                                      "cuda", **kw)
        finally:
            D.boxes_device = boxes_device
        row = {"segments": len(s_gpu),
               "analyze_chunks": TIMERS.counts.get("features_dispatch", 0) - chunks0,
               "db_chunks": len(db_chunks), "db_views": sum(db_chunks),
               "launches": {"cc": connected_components_cuda.launches,
                            "edge_stats": fused_edge_stats_cuda.launches},
               "edge_stats_route": edge_launches(), "wall_s_cuda": w_gpu}
        p_cpu, s_cpu, _ = run(pdf, os.path.join(tmp, f"{label}_cpu"), "cpu", **kw)
        outside, conf_diff, csv_equal = payload_differences(
            os.path.join(tmp, f"{label}_cuda"), os.path.join(tmp, f"{label}_cpu"))
        b = s_gpu[0].bbox if s_gpu else None
        row.update(errors=[p_gpu.stats.errors, p_cpu.stats.errors],
                   cuda_equals_cpu=[key(s) for s in s_gpu] == [key(s) for s in s_cpu],
                   keys_outside_table=len(outside), differing_keys=outside[:20],
                   confidence_max_abs_diff=conf_diff, csv_equal=csv_equal,
                   first_bbox=b and [b.x0, b.y0, b.x1, b.y1, b.page_width,
                                     b.page_height])
        books[label] = row
        edge_by_path[f"foreign_{label}"] = row["edge_stats_route"]
    # tests/test_torch_corpus.py runs the other two producers' books: the
    # card machine has neither matplotlib nor fontTools (the env line)
    emit("foreign_books", books=books, tier1_only={
        "matplotlib Type3 and TrueType books": "needs matplotlib",
        "fontTools xref-stream CID book": "needs fontTools"},
        elapsed_phase_s=time.perf_counter() - t, **CARD)
    for label, row in books.items():
        if (any(row["errors"]) or not row["cuda_equals_cpu"] or row["keys_outside_table"]
                or not row["csv_equal"] or row["edge_stats_route"] is None
                or row["analyze_chunks"] == 0 or row["launches"]["cc"]
                < 4 * row["analyze_chunks"] + row["db_chunks"]):
            return fail(f"{label}: cuda against cpu: {row}")
    if (books["pilbook"]["segments"] < 3 or books["pilbook"]["db_chunks"] == 0
            or books["rotscan"]["segments"] != 1 or [round(v) for v in books[
                "rotscan"]["first_bbox"]] != [156, 196, 456, 596, 612, 792]):
        return fail(f"foreign books: {books}")

    # ------------------------------------------------ 8c. sweep shapes
    # scripts/torch_sweep.py's chunk shapes (the JAX package's batch-shape
    # sweep): both kernels against their twins at B = 32 and 64, timed, and
    # the analyze pass on 32 crops against two 16-crop calls; the 64-page
    # book at every configuration, its whole JSON held to base's, with the
    # launches of each run (counters at 0 before it, read after it); the
    # recognizer's 256-tile batch, the card against the CPU
    t = time.perf_counter()
    sweep = helper_module("torch_sweep", "scripts")
    wide, wide_sizes, _ = rendered_crops(book64, range(0, 64), n=64)
    gen_wide = np.random.default_rng(SEED + 1)
    at_batch = {}
    for B in (32, 64):
        g_np, q_np = gray_quarter_host(wide[:B])
        g_b = torch.from_numpy(g_np).to(dev)
        masks_b = site_masks(g_b, torch.from_numpy(
            np.ascontiguousarray(q_np[:, ::2, ::2])).to(dev))
        rand_b = torch.from_numpy(
            (gen_wide.random((B, 256, 256)) < 0.45).astype(np.float32)).to(dev)
        row = {"cc": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
                      "ops": 0.0, "max_abs_err": 0, "rounds_max": {}}}
        for site, (mask, iters, conn) in masks_b.items():
            site_row, err_msg = cc_site(site, mask, iters, conn, rand=rand_b)
            if err_msg:
                return fail(f"{err_msg} at B = {B}")
            for k in ("ms", "plain_ms", "bound_ms", "bytes", "ops"):
                row["cc"][k] += site_row[k]
            row["cc"]["max_abs_err"] = max(row["cc"]["max_abs_err"],
                                           site_row["max_abs_err"])
            row["cc"]["rounds_max"][site] = max(site_row["rounds"])
        row["cc"]["bound_by"] = bound(row["cc"]["bytes"], row["cc"]["ops"])[1]
        gray_b = g_b.to(torch.float32).contiguous()
        noise_b = torch.from_numpy(gen_wide.integers(0, 256, (B, 512, 512)).astype(
            np.float32)).to(dev)
        e_err = 0.0
        for g in (gray_b, noise_b):
            got = fused_edge_stats_cuda(g)
            torch.cuda.synchronize()
            want = fused_edge_stats_reference(g)
            if got.shape != want.shape or not torch.equal(got, want):
                return fail(f"edge-stats kernel != twin at B = {B}")
            e_err = max(e_err, float((got - want).abs().max()))
        e_bytes = gray_b.numel() * 4 + got.numel() * 4
        e_bound, e_by = bound(e_bytes, 60.0 * gray_b.numel())
        row["edge_stats"] = {
            "ms": cuda_ms(lambda: fused_edge_stats_cuda(gray_b)),
            "plain_ms": cuda_ms(lambda: fused_edge_stats_reference(gray_b)),
            "bound_ms": e_bound, "bound_by": e_by, "bytes": e_bytes,
            "max_abs_err": e_err}
        at_batch[B] = row
    # the analyze pass is per crop: 32 crops in one call = two 16-crop calls
    from synapta_tpu_torch.ops.features import device_analyze

    f32, b32 = device_analyze(wide[:32], sizes=wide_sizes[:32], device=dev)
    halves = [device_analyze(wide[i:i + 16], sizes=wide_sizes[i:i + 16], device=dev)
              for i in (0, 16)]
    invariant = (np.array_equal(b32, np.concatenate([h[1] for h in halves]))
                 and all(np.array_equal(f32[k], np.concatenate([h[0][k] for h in halves]))
                         for k in f32))
    # the recognizer at the lb256 batch, bf16 on the card against float32 on
    # the CPU
    ocr256 = TorchOCR(OCRConfig(line_batch=256), device="cuda")
    ocr256_cpu = TorchOCR(OCRConfig(line_batch=256), device="cpu")
    ocr256_cpu.model = ocr_cpu.model
    rec256 = [o.recognize_tiles(tiles256) for o in (ocr256, ocr256_cpu)]
    agree256 = sum(a["text"] == b["text"] for a, b in zip(*rec256)) / len(tiles256)
    tiles256_dev = torch.from_numpy(tiles256).to(dev)
    rec256_ms = cuda_ms(lambda: ocr256._decode(tiles256_dev), runs=10)
    # the 64-page book at each configuration, in the JAX script's order
    sweep_runs = {}
    for name in sweep.CFGS:
        connected_components_cuda.launches = 0
        fused_edge_stats_cuda.launches = 0
        del routes_seen[:]
        chunks0 = TIMERS.counts.get("features_dispatch", 0)
        p_sw, s_sw, w_sw = run(book64, os.path.join(tmp, f"sweep_{name}"), "cuda",
                               config=sweep.sweep_config(name))
        sweep_runs[name] = {
            "segments": len(s_sw), "errors": p_sw.stats.errors,
            "chunks": TIMERS.counts.get("features_dispatch", 0) - chunks0,
            "launches": {"cc": connected_components_cuda.launches,
                         "edge_stats": fused_edge_stats_cuda.launches},
            "edge_stats_route": edge_launches(), "wall_s": w_sw,
            "pages_per_s": p_sw.stats.pages / w_sw}
        edge_by_path[f"sweep_{name}"] = sweep_runs[name]["edge_stats_route"]
    for name, row in sweep_runs.items():
        outside, conf_diff, csv_equal = payload_differences(
            os.path.join(tmp, f"sweep_{name}"), os.path.join(tmp, "sweep_base"))
        row.update(keys_outside_table=len(outside), differing_keys=outside[:20],
                   confidence_max_abs_diff=conf_diff, csv_equal=csv_equal)
    emit("sweep_shapes", configs=sweep.CFGS, runs=sweep_runs,
         kernels_at_batch={B: {k: {f: v for f, v in r.items() if f not in ("bytes", "ops")}
                               for k, r in row.items()} for B, row in at_batch.items()},
         analyze_32_equals_two_16=invariant,
         recognizer_256={"tiles": int(tiles256.shape[0]),
                         "bf16_gpu_vs_f32_cpu_equal_share": agree256,
                         "ms_per_256_tiles": rec256_ms, "ms_per_128_tiles": rec_ms},
         elapsed_phase_s=time.perf_counter() - t, **CARD)
    if not invariant:
        return fail("device_analyze on 32 crops != two 16-crop calls")
    if tiles256.shape[0] != 256 or agree256 < 0.95:
        return fail(f"recognizer at 256 tiles: {tiles256.shape[0]} tiles, "
                    f"agreement {agree256:.3f}")
    for name, row in sweep_runs.items():
        if (row["errors"] or row["segments"] != len(segs) or row["keys_outside_table"]
                or not row["csv_equal"] or row["edge_stats_route"] is None
                or row["chunks"] == 0 or row["launches"] != {
                    "cc": 4 * row["chunks"], "edge_stats": row["chunks"]}):
            return fail(f"sweep {name}: {row}")

    # ----------------------------------------------------- 8d. crop book
    # scripts/torch_real_corpus.py's book on 16 crops that the 64-page run
    # wrote: one DCT/JPEG image a page at its 150-DPI size, through the
    # embedded-image path; the card against the CPU, counters at 0 before the
    # card's run and read after it
    import shutil

    t = time.perf_counter()
    real_corpus = helper_module("torch_real_corpus", "scripts")
    crop_dir = os.path.join(tmp, "crops16")
    os.makedirs(crop_dir)
    for seg in payload(out64)["segments"][:16]:
        shutil.copy(seg["image_path"], crop_dir)
    real_corpus.CORPUS = crop_dir
    crop_pdf = os.path.join(tmp, "cropbook.pdf")
    n_crop_pages = real_corpus.build_book(crop_pdf)
    crop = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            connected_components_cuda.launches = 0
            fused_edge_stats_cuda.launches = 0
            del routes_seen[:]
            chunks0 = TIMERS.counts.get("features_dispatch", 0)
        res = real_corpus.run(crop_pdf, os.path.join(tmp, f"crop_{device}"),
                              n_crop_pages, device=device)
        if device == "cuda":
            res.update(chunks=TIMERS.counts.get("features_dispatch", 0) - chunks0,
                       launches={"cc": connected_components_cuda.launches,
                                 "edge_stats": fused_edge_stats_cuda.launches},
                       edge_stats_route=edge_launches())
            crop_launches = res["launches"]
            edge_by_path["crop_book"] = res["edge_stats_route"]
        crop[device] = res
    outside, conf_diff, csv_equal = payload_differences(
        os.path.join(tmp, "crop_cuda"), os.path.join(tmp, "crop_cpu"),
        "investments_real")
    emit("crop_book", pages=n_crop_pages, runs=crop,
         keys_outside_table=len(outside), differing_keys=outside[:20],
         confidence_max_abs_diff=conf_diff, csv_equal=csv_equal,
         elapsed_phase_s=time.perf_counter() - t, **CARD)
    if (n_crop_pages != 16 or outside or not csv_equal
            or any(r["pages_with_embedded_segment"] != 16 or r["swallowed_errors"]
                   for r in crop.values())
            or crop["cuda"]["edge_stats_route"] is None or crop["cuda"]["chunks"] == 0
            or crop_launches["cc"] < 4 * crop["cuda"]["chunks"]):
        return fail(f"crop book: cuda against cpu: {crop}, outside {outside[:5]}, "
                    f"csv equal {csv_equal}")

    # ------------------------------------------------- 8e. diverse book
    # make_diverse_book(seed=5), the book tests/test_torch_diverse.py holds
    # to the JAX pipeline: the card against the CPU under the OCR yardstick,
    # the CPU's bf16 run the reference, each run recorded and its tiles and
    # DB views evaluated again by the bf16 and the float32 models on its own
    # device; counters at 0 before the card's run and read after it
    from synapta_tpu_torch.io.pdf_writer import make_diverse_book
    from synapta_tpu_torch.models.msgpack_io import load_params
    from synapta_tpu_torch.models.recognizer import recognizer_from_flax
    from synapta_tpu_torch.ocr.processor import TorchOCR

    t = time.perf_counter()
    div_pdf = os.path.join(tmp, "diverse.pdf")
    make_diverse_book(div_pdf, seed=DIVERSE_SEED)
    div = {}
    for device in ("cuda", "cpu"):
        rec = OCRRecorder(TorchOCR, VisualSegmentationPipeline, D, "boxes_device")
        if device == "cuda":
            connected_components_cuda.launches = 0
            fused_edge_stats_cuda.launches = 0
            del routes_seen[:]
            chunks0 = TIMERS.counts.get("features_dispatch", 0)
        with rec:
            pipe, segs, wall = run(div_pdf, os.path.join(tmp, f"div_{device}"), device)
        row = {"segments": len(segs), "errors": pipe.stats.errors, "wall_s": wall,
               "db_chunks": len(rec.db_chunks)}
        if device == "cuda":
            row.update(analyze_chunks=TIMERS.counts.get("features_dispatch", 0) - chunks0,
                       launches={"cc": connected_components_cuda.launches,
                                 "edge_stats": fused_edge_stats_cuda.launches},
                       edge_stats_route=edge_launches())
            div_launches = row["launches"]
            edge_by_path["diverse10"] = row["edge_stats_route"]
        te = time.perf_counter()
        batches, db = port_evaluation(
            rec, recognizer_from_flax(load_params(), dtype=torch.float32,
                                      device=device),
            D.detector_from_flax(D.load_det_params(), dtype=torch.float32,
                                 device=device))
        row["evaluation_s"] = time.perf_counter() - te
        div[device] = {"row": row, "segments": segs, "batches": batches, "db": db}
    div_db = (db_yardstick(div["cpu"]["db"], div["cuda"]["db"])
              if div["cpu"]["db"] or div["cuda"]["db"] else None)
    div_report = ocr_yardstick(div["cpu"]["batches"], div["cuda"]["batches"], div_db)
    div_keys = judge_keys(os.path.join(tmp, "div_cpu"), os.path.join(tmp, "div_cuda"),
                          div_report)
    div_same = ([key(s) for s in div["cuda"]["segments"]]
                == [key(s) for s in div["cpu"]["segments"]])
    emit("e2e_diverse", seed=DIVERSE_SEED,
         runs={d: v["row"] for d, v in div.items()}, cuda_equals_cpu=div_same,
         yardstick={k: v for k, v in div_report.items() if k != "excused_lines"},
         bounds={"f32_logit": F32_LOGIT_BOUND, "error_ratio_max": ERROR_RATIO_MAX},
         key_faults=div_keys["faults"][:20], excused_keys=div_keys["excused_keys"],
         excused_segments=div_keys["excused_segments"],
         elapsed_phase_s=time.perf_counter() - t, **CARD)
    cuda_row = div["cuda"]["row"]
    if (not div_same or cuda_row["errors"] or div["cpu"]["row"]["errors"]
            or not div_report["ok"] or div_keys["faults"]
            or cuda_row["edge_stats_route"] is None or cuda_row["analyze_chunks"] == 0
            or cuda_row["db_chunks"] == 0
            or div_launches["cc"] < 4 * cuda_row["analyze_chunks"] + cuda_row["db_chunks"]
            or div_launches["edge_stats"] != cuda_row["analyze_chunks"]):
        return fail(f"diverse book: cuda against cpu: {cuda_row}, yardstick ok "
                    f"{div_report['ok']}, key faults {div_keys['faults'][:5]}")
    del div, div_report

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

    # launches: the 64-page book's, the 16-page scanned book's, the 2-shard
    # 64-page book's, the LLM-on 8-page book's, the two foreign books', the
    # six sweep configurations', the crop book's and the diverse book's
    # runs; ms, plain_ms and bound_ms per analyze chunk of 16 crops (the CC
    # row's four analyze
    # sites; the DB site per DB chunk under "db_site"; a chunk as two half
    # shards on two streams under "dp2"; chunks of 32 and 64 crops under
    # "at_batch")
    sweep_cc = {f"sweep_{k}": r["launches"]["cc"] for k, r in sweep_runs.items()}
    sweep_edge = {f"sweep_{k}": r["launches"]["edge_stats"]
                  for k, r in sweep_runs.items()}

    def batch_rows(kernel):
        return {B: {k: v for k, v in row[kernel].items() if k not in ("bytes", "ops")}
                for B, row in at_batch.items()}

    print(json.dumps({"kernels": [
        {"name": "connected_components", "route": "cuda",
         "source": "synapta_tpu_torch/csrc/cc.cu",
         "replaces": "synapta_tpu/ops/pallas_cc.py:100",
         "launches": (launches["cc"] + scan_launches["cc"] + dp_launches["cc"]
                      + llm_launches["cc"] + sum(
                          b["launches"]["cc"] for b in books.values())
                      + sum(sweep_cc.values()) + crop_launches["cc"]
                      + div_launches["cc"]),
         "max_abs_err": cc_err,
         "ms": cc_ms, "plain_ms": cc_plain_ms, "bound_ms": cc_bound_ms,
         "bound_by": cc_bound_by, "library_ms": None,
         "sites": len(cc_checked), "site_names": cc_checked,
         "launches_by_path": {"book64": launches["cc"],
                              "scanned16": scan_launches["cc"],
                              "book64_dp2": dp_launches["cc"],
                              "book8_llm_on": llm_launches["cc"],
                              **{f"foreign_{k}": b["launches"]["cc"]
                                 for k, b in books.items()},
                              **sweep_cc, "crop_book": crop_launches["cc"],
                              "diverse10": div_launches["cc"]},
         "db_native_launches": native_cc_launches,
         "dp2": {"shape": dp_rows[0]["shape"], "ms": dp_cc_ms,
                 "plain_ms": dp_cc_plain_ms},
         "db_site": {"ms": db_row["ms"], "plain_ms": db_row["plain_ms"],
                     "bound_ms": db_row["bound_ms"],
                     "bound_by": db_row["bound_by"]},
         "at_batch": batch_rows("cc")},
        # ms, plain_ms, max_abs_err and bound_ms are the default route's (the
        # one every path above ran); "routes" has both
        {"name": "fused_edge_stats", "route": "cuda",
         "source": "synapta_tpu_torch/csrc/edge_stats.cu",
         "replaces": "synapta_tpu/ops/pallas_kernels.py:162",
         "launches": (launches["edge_stats"] + scan_launches["edge_stats"]
                      + dp_launches["edge_stats"] + llm_launches["edge_stats"]
                      + sum(b["launches"]["edge_stats"] for b in books.values())
                      + sum(sweep_edge.values()) + crop_launches["edge_stats"]
                      + div_launches["edge_stats"]),
         "max_abs_err": edge["default"]["max_abs_err"],
         "ms": edge["default"]["ms"], "plain_ms": edge["default"]["plain_ms"],
         "bound_ms": edge["default"]["bound_ms"],
         "bound_by": edge["default"]["bound_by"], "library_ms": None,
         "routes": {r: {k: row[k] for k in ("ms", "plain_ms", "max_abs_err",
                                            "bound_ms", "bound_by")}
                    for r, row in edge.items()},
         "launches_by_path": edge_by_path,
         "dp2": {"shape": list(gray_halves[0].shape), **dp_edge},
         "at_batch": batch_rows("edge_stats")},
    ]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
