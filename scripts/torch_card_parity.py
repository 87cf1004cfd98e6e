#!/usr/bin/env python3
"""The port on the GPU against the port on the CPU, book by book and op by op.

    python3 scripts/torch_card_parity.py [--tree DIR] [--ops] [--out PATH]

Needs one CUDA GPU. Runs the package of the checkout at ``--tree`` (default:
the checkout this script is in; a parent commit unpacked with ``git
archive`` runs the same way, so that two trees can be compared in one call):

- four books through ``VisualSegmentationPipeline`` on ``cuda`` and on
  ``cpu``: ``make_test_book(8, seed=11)``, ``make_test_book(4, seed=42)``,
  ``make_scanned_book(2, seed=2)``, ``make_scanned_book(4, seed=42)``; for
  each, the keys of the segment JSON outside this checkout's
  ``chip_smoke.ALLOWED_DIFFERENCES``, the largest confidence differences
  and whether the summary CSVs are equal;
- the DB detector on the 16 scanned views of ``make_scanned_book(16,
  seed=42)``: line boxes equal cuda against cpu, probability pixels on the
  other side of the threshold;
- CUDA-event times (median of 10) of the DB model on those 16 views and of
  the recognizer on 128 tiles;
- ``--ops``: the recognizer op by op, each cuda op fed the cpu op's inputs
  (the 4-page scanned book's first 128 tiles), with cuBLAS's bf16
  reduced-precision reductions allowed and not.

Prints one JSON line a part and the card's name and power limit; ``--out``
writes all of it as one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table():
    """This checkout's ALLOWED_DIFFERENCES matcher (chip_smoke.py imports
    nothing but the standard library at the top)."""
    spec = importlib.util.spec_from_file_location(
        "_smoke_table", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def books(tmp: str) -> dict:
    import csv

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book, make_test_book
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    smoke = _table()
    out = {}
    for name, make in (
            ("book8_s11", lambda f: make_test_book(f, pages=8, seed=11)),
            ("book4_s42", lambda f: make_test_book(f, pages=4, seed=42)),
            ("scan2_s2", lambda f: make_scanned_book(f, pages=2, seed=2)),
            ("scan4_s42", lambda f: make_scanned_book(f, pages=4, seed=42))):
        pdf = os.path.join(tmp, name + ".pdf")
        make(pdf)
        payload, rows = {}, {}
        for dev in ("cuda", "cpu"):
            d = os.path.join(tmp, f"{name}_{dev}")
            pipe = VisualSegmentationPipeline(
                "x", pdf, output_dir=d, use_mermaid=False,
                config=PipelineConfig(use_vision_llm=False),
                llm_client=DisabledClient(), resume=False, device=dev)
            pipe.process()
            pipe.close()
            with open(os.path.join(d, "x_visual_segments.json")) as f:
                payload[dev] = json.load(f)
            with open(os.path.join(d, "x_visual_summary.csv"), newline="") as f:
                rows[dev] = list(csv.reader(f))
        outside, conf = [], {"block": 0.0, "mean": 0.0}
        for path, a, b in smoke.json_differences(payload["cuda"], payload["cpu"]):
            if (path.endswith(".confidence") and ".ocr_result." in path
                    and isinstance(a, float) and isinstance(b, float)):
                kind = "block" if ".blocks[" in path else "mean"
                conf[kind] = max(conf[kind], abs(a - b))
            if smoke.allowed_difference(path, a, b) is None:
                outside.append([path, str(a)[:80], str(b)[:80]])
        out[name] = {"segments": payload["cuda"]["total_segments"],
                     "keys_outside_table": len(outside),
                     "outside": outside[:12], "confidence_max_abs_diff": conf,
                     "csv_equal": rows["cuda"] == rows["cpu"]}
        print(json.dumps({name: out[name]}), flush=True)
    return out


def cuda_ms(fn, runs: int = 10) -> float:
    import numpy as np
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def detector_and_times(tmp: str) -> dict:
    import numpy as np
    import torch

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.ingest import open_pdf
    from synapta_tpu_torch.io.loader import prepare_batch
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book
    from synapta_tpu_torch.models import detector as D
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.vision.detect import DetectionEngine

    pdf = os.path.join(tmp, "scan16.pdf")
    make_scanned_book(pdf, pages=16, seed=42)
    cfg = PipelineConfig()
    doc = open_pdf(pdf)
    engine = DetectionEngine(open_pdf(pdf), cfg.detection, pixels_doc=doc)
    prep = prepare_batch(engine, doc, cfg.detection.render_dpi,
                         cfg.ocr.crop_size, range(16))
    canvases, ctxs = np.array(prep[1]), list(prep[5])
    on_gpu, on_cpu = D.DBLineDetector(device="cuda"), D.DBLineDetector(device="cpu")
    got, want = (det.detect_lines(canvases, hires=ctxs) for det in (on_gpu, on_cpu))
    gray = torch.from_numpy(D.DBLineDetector._luma(canvases))
    with torch.inference_mode():
        lg = D.db_logits(on_gpu.model, gray.cuda()).float().cpu()
        lc = D.db_logits(on_cpu.model, gray).float()
        thresh = float(np.log(0.3 / 0.7))
        g = gray.cuda()
        ms_db = cuda_ms(lambda: D.db_logits(on_gpu.model, g))
        ocr = TorchOCR(cfg.ocr, device="cuda")
        tiles = torch.randint(0, 256, (128, 32, 384), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(0)).cuda()
        ms_rec = cuda_ms(lambda: ocr._decode(tiles))
    out = {
        "db16": {"boxes": sum(len(w) for w in want),
                 "boxes_equal": sum(a == b for w, g in zip(want, got)
                                    for a, b in zip(w, g)),
                 "lines_per_view_equal": [len(w) for w in want] == [len(g) for g in got],
                 "prob_side_flips": int(((lg > thresh) != (lc > thresh)).sum()),
                 "max_abs_logit_diff": float((lg - lc).abs().max())},
        "ms_db_model_16_views": ms_db, "ms_recognizer_128_tiles": ms_rec}
    print(json.dumps(out), flush=True)
    return out


def recognizer_steps(m, x):
    """The recognizer's forward as [(name, fn(model, *args), args, out)],
    each op computed by the port's own functions."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from synapta_tpu_torch.models import recognizer as R

    steps = []

    def op(name, fn, *args):
        out = fn(m, *args)
        steps.append((name, fn, args, out))
        return out

    def conv(i):
        def f(m, x):
            sh, sw = m.strides[i]
            ph, pw = R._same_pad(x.shape[2], sh), R._same_pad(x.shape[3], sw)
            return F.relu(R._conv(m.convs[i], F.pad(x, (*pw, *ph))))
        return f

    x = x.to(m.dtype)
    for i in range(len(m.convs)):
        x = op(f"conv{i} + bias + relu", conv(i), x)
    s = op("height mean + pos_embed", lambda m, x: m.collapse(x), x)
    for j in range(len(m.blocks)):
        B, T, D = s.shape
        hd = D // m.blocks[j].heads
        h = op(f"block{j}.ln0", lambda m, s, j=j: R._layer_norm(
            m.blocks[j].ln0, s, m.dtype), s)
        qkv = [op(f"block{j}.{n}", lambda m, h, j=j, n=n: R._dense(
            getattr(m.blocks[j], n), h).view(B, T, -1, hd).transpose(1, 2), h)
            for n in ("query", "key", "value")]
        a = op(f"block{j}.attention", lambda m, q, k, v: R.attention_core(
            q, k, v, torch.tensor(float(np.sqrt(hd)), dtype=q.dtype,
                                  device=q.device)), *qkv)
        a = op(f"block{j}.out", lambda m, a, j=j: R._dense(
            m.blocks[j].out, a.transpose(1, 2).reshape(B, T, D)), a)
        x1 = op(f"block{j}.residual1", lambda m, s, a: R._wide(
            s.to(m.dtype)) + R._wide(a), s, a)
        h = op(f"block{j}.ln1", lambda m, x, j=j: R._layer_norm(
            m.blocks[j].ln1, x, m.dtype), x1)
        h = op(f"block{j}.fc0", lambda m, h, j=j: R._dense(m.blocks[j].fc0, h), h)
        h = op(f"block{j}.gelu", lambda m, h: R.gelu_tanh(h), h)
        h = op(f"block{j}.fc1", lambda m, h, j=j: R._dense(m.blocks[j].fc1, h), h)
        s = op(f"block{j}.residual2", lambda m, x, h: R._wide(
            x.to(m.dtype)) + R._wide(h), x1, h)
    h = op("norm", lambda m, s: R._layer_norm(m.norm, s, m.dtype), s)
    op("head (f32)", lambda m, h: R._dense(m.head, h.float()), h)
    return steps


def recognizer_ops(tmp: str) -> dict:
    import numpy as np
    import torch

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.models import recognizer as R
    from synapta_tpu_torch.models.msgpack_io import load_params
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    cut = []
    dispatch = TorchOCR.recognize_dispatch

    def recording(self, tiles):
        pending = dispatch(self, tiles)
        cut.append(np.asarray(tiles))
        return pending

    pdf = os.path.join(tmp, "scan4_ops.pdf")
    make_scanned_book(pdf, pages=4, seed=42)
    TorchOCR.recognize_dispatch = recording
    try:
        pipe = VisualSegmentationPipeline(
            "x", pdf, output_dir=os.path.join(tmp, "ops"), use_mermaid=False,
            config=PipelineConfig(use_vision_llm=False),
            llm_client=DisabledClient(), resume=False, device="cpu")
        pipe.process()
        pipe.close()
    finally:
        TorchOCR.recognize_dispatch = dispatch
    tiles = np.concatenate(cut)[:128]
    tree = load_params()
    on_cpu = R.recognizer_from_flax(tree, dtype=torch.bfloat16, device="cpu")
    on_gpu = R.recognizer_from_flax(tree, dtype=torch.bfloat16, device="cuda")
    x = torch.from_numpy(tiles).float()[:, None] / 255.0
    with torch.no_grad():
        steps = recognizer_steps(on_cpu, x)
    out = {"tiles": int(tiles.shape[0])}
    before = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for allow in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow
        rows = []
        with torch.no_grad():
            for name, fn, args, want in steps:
                got = fn(on_gpu, *[a.cuda() for a in args]).cpu().float()
                rows.append({"op": name, "n": want.numel(),
                             "differ": int((got != want.float()).sum()),
                             "max_abs_diff": float((got - want.float()).abs().max())})
        out[f"reduced_precision_reduction_{allow}"] = rows
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = before
    print(json.dumps({"recognizer_ops": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    ensure_fixture_fonts()
    from synapta_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="card_parity_")
    result = {"tree": tree, "card": card, "books": books(tmp)}
    result.update(detector_and_times(tmp))
    if args.ops:
        result["recognizer_ops"] = recognizer_ops(tmp)
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
