"""Accuracy evaluation harness of the PyTorch port — counterpart of
synapta_tpu/eval.py.

The harness measures against the synthetic ground truth that the fixture
generator emits (detection recall/IoU, classification accuracy, OCR CER),
and, where the reference project's sample run output is at hand, against
its recorded PaddleOCR output on the golden crop.

    python -m synapta_tpu_torch.eval [--device cuda] [--pages 16] [--seed 3] \
        [--scanned [--scanned-pages N]] [--golden [--golden-route db]]

Prints one JSON line. ``--device`` defaults to ``cuda`` (which fails
without a GPU); ``cpu`` runs the kernels' plain PyTorch twins. The scoring
functions are verbatim copies of the original's (a test pins each one);
the evaluations name their device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from typing import Dict, List

import numpy as np


def norm_text(s: str) -> str:
    return re.sub(r"\s+", " ", (s or "").strip().lower())


def cer(ref: str, hyp: str) -> float:
    """Levenshtein character error rate."""
    if not ref:
        return 0.0 if not hyp else 1.0
    m, n = len(ref), len(hyp)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1, dp[j - 1] + 1, prev + (ref[i - 1] != hyp[j - 1])
            )
            prev = cur
    return dp[n] / m


# ------------------------------------------------------------- golden crop
#
# The ONE real-world ground-truth asset: the reference project's sample run
# output (reference/extracted_visuals_excelSS/ under the reference project's
# root, located by SYNAPTA_GOLDEN_DIR) contains a real finance-textbook crop
# PNG (an Excel Black-Scholes screenshot, 694x432) together with the
# reference pipeline's RECORDED PaddleOCR output for it — 103 text blocks
# with pixel bboxes and confidences (mean 0.952) — plus its classification
# ("image") and structured-text split.
GOLDEN_DIR = os.environ.get(
    "SYNAPTA_GOLDEN_DIR", os.path.join("reference", "extracted_visuals_excelSS")
)


def _prep_standalone(img: np.ndarray, crop_size: int):
    """Standalone image -> (canvas, (oh, ow), render_ctx) exactly as
    io/loader.prepare_batch fits oversized region renders: coverage-exact
    box downscale onto the square analysis canvas, with the original kept
    as the hires OCR-tile source (loader.prepare_batch fitted-DPI path)."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = np.ascontiguousarray(img[..., :3])
    h, w = img.shape[:2]
    ctx = None
    if max(h, w) > crop_size:
        from synapta_tpu_torch.io.ingest import box_downscale

        scale = crop_size / float(max(h, w))
        oh = max(1, int(h * scale + 0.5))
        ow = max(1, int(w * scale + 0.5))
        arr = box_downscale(img, oh, ow)
        ctx = (img, 1.0 / scale)
    else:
        arr, oh, ow = img, h, w
    canvas = np.full((crop_size, crop_size, 3), 255, np.uint8)
    canvas[:oh, :ow] = arr
    return canvas, (oh, ow), ctx


def _box_iou(a, b) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


def _box_containment(gold, pred) -> float:
    """|gold ∩ pred| / |gold| — how much of a golden block a predicted box
    covers. Our detector emits LINES; PaddleOCR emits per-snippet boxes
    (one table cell each), so a full-row line legitimately covers several
    golden blocks at low pairwise IoU. Containment measures coverage
    without penalizing that granularity difference."""
    ix0, iy0 = max(gold[0], pred[0]), max(gold[1], pred[1])
    ix1, iy1 = min(gold[2], pred[2]), min(gold[3], pred[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    g_area = max(0.0, gold[2] - gold[0]) * max(0.0, gold[3] - gold[1])
    return inter / max(g_area, 1e-9)


def _best_window_cer(ref: str, hyp: str, cer_fn) -> float:
    """Alignment-free per-block CER: min CER of ref against any
    len(ref)-sized window of hyp (ordering-insensitive; same scheme as
    evaluate_book's per-text scoring)."""
    if not ref:
        return 0.0
    if ref in hyp:
        return 0.0
    best = 1.0
    step = max(1, len(ref) // 4)
    for st in range(0, max(1, len(hyp) - len(ref) + 1), step):
        best = min(best, cer_fn(ref, hyp[st : st + len(ref) + 2]))
        if best == 0.0:
            break
    return best


def evaluate_golden_crop(route: str = "production",
                         device="cuda") -> Dict:
    """Feed the reference's golden crop PNG through TorchOCR + the classify
    path; score against the RECORDED PaddleOCR blocks + classification.

    route: "production" = exactly what the pipeline would do for this
    region (heuristic line detector — the crop is 13% of page area, below
    the scanned_area_frac DB routing bar); "db" = force the trainable DB
    detector (the PaddleOCR-DBNet parity path).
    """
    import json as _json

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.ops.features import (
        device_analyze_dispatch,
        unpack_analysis,
    )
    from synapta_tpu_torch.vision import classify as C
    from synapta_tpu_torch.vision import local_analysis as LA
    from PIL import Image

    with open(os.path.join(GOLDEN_DIR, "textbook_001_visual_segments.json")) as f:
        gseg = _json.load(f)["segments"][0]
    png_path = os.path.join(GOLDEN_DIR, gseg["segment_id"] + ".png")
    img = np.asarray(Image.open(png_path).convert("RGB"))

    cfg = PipelineConfig()
    canvas, (oh, ow), ctx = _prep_standalone(img, cfg.ocr.crop_size)
    batch = canvas[None]
    feats, boxes = unpack_analysis(device_analyze_dispatch(
        batch, sizes=np.array([(oh, ow)], np.int32), device=device
    ).cpu().numpy(), 1)
    f = C.CropFeatures(feats, 0, oh, ow)
    arrows = C.count_arrows(f, cfg.heuristics)

    ocr = TorchOCR(cfg.ocr, device=device)
    res = ocr.process_batch(
        batch,
        arrows=[arrows],
        sizes=[(oh, ow)],
        render_ctx=[ctx],
        line_boxes=None if route == "db" else boxes,
        db_mask=[True] if route == "db" else None,
    )[0]

    # ---- OCR text parity vs the recorded PaddleOCR output
    g_raw = gseg["ocr_result"]["raw_text"]
    g_blocks = gseg["ocr_result"]["blocks"]
    hyp = norm_text(res.raw_text.replace("\n", " "))
    ref = norm_text(g_raw.replace("\n", " "))
    strict_cer = cer(ref, hyp)
    wer = cer(ref.split(), hyp.split())
    block_cers = [
        _best_window_cer(norm_text(b["text"]), hyp, cer)
        for b in g_blocks
        if norm_text(b["text"])
    ]

    # ---- block detection vs the recorded PaddleOCR pixel bboxes
    ratio = ctx[1] if ctx is not None else 1.0
    pred_boxes = [
        [v * ratio for v in b["bbox"]] for b in res.blocks
    ]
    iou_hits = cont_hits = 0
    for b in g_blocks:
        gb = [float(v) for v in b["bbox"]]
        if pred_boxes:
            if max(_box_iou(gb, p) for p in pred_boxes) >= 0.5:
                iou_hits += 1
            if max(_box_containment(gb, p) for p in pred_boxes) >= 0.5:
                cont_hits += 1

    # ---- classification vs the recorded segment_type
    vtype, conf = LA.classify_heuristic(f, res, cfg.heuristics)

    return {
        "route": route,
        "cer_vs_paddle": round(float(strict_cer), 4),
        "wer_vs_paddle": round(float(wer), 4),
        "block_cer_mean": round(float(np.mean(block_cers)), 4),
        "block_cer_le_0.2_frac": round(
            float(np.mean([c <= 0.2 for c in block_cers])), 4
        ),
        "det_recall_iou@0.5": round(iou_hits / max(len(g_blocks), 1), 4),
        "det_recall_containment@0.5": round(
            cont_hits / max(len(g_blocks), 1), 4
        ),
        "n_golden_blocks": len(g_blocks),
        "n_pred_blocks": len(res.blocks),
        "classification": vtype.value,
        "classification_matches_golden": vtype.value == gseg["segment_type"],
        "mean_block_confidence": round(float(res.confidence), 4),
        "golden_mean_block_confidence": round(
            float(gseg["ocr_result"]["confidence"]), 4
        ),
    }


def evaluate_book(pages: int = 16, seed: int = 3, use_llm: bool = False,
                  device="cuda") -> Dict:
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_test_book
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline
    from synapta_tpu_torch.schema import BoundingBox, VisualType

    tmp = tempfile.mkdtemp(prefix="synapta_eval_")
    pdf = os.path.join(tmp, "book.pdf")
    truths = make_test_book(pdf, pages=pages, seed=seed)
    pipe = VisualSegmentationPipeline(
        book_id="eval",
        pdf_path=pdf,
        output_dir=os.path.join(tmp, "out"),
        use_mermaid=False,
        config=PipelineConfig(use_vision_llm=use_llm),
        llm_client=None if use_llm else DisabledClient(),
        resume=False,
        device=device,
    )
    segs = pipe.process()
    by_page: Dict[int, List] = {}
    for s in segs:
        by_page.setdefault(s.page_no - 1, []).append(s)

    expected_type = {
        "chart_bar": VisualType.CHART,
        "chart_line": VisualType.CHART,
        "chart_pie": VisualType.CHART,
        "flowchart": VisualType.FLOWCHART,
        "image": VisualType.IMAGE,
        "table_image": VisualType.IMAGE,
    }

    det_tp = det_total = 0
    ious: List[float] = []
    cls_hits = cls_total = 0
    cers: List[float] = []
    for p, t in enumerate(truths):
        page_segs = by_page.get(p, [])
        for v in t.visuals:
            det_total += 1
            vb = BoundingBox(*v.bbox, 612, 792)
            best_iou, best_seg = 0.0, None
            for s in page_segs:
                i = s.bbox.iou(vb)
                if i > best_iou:
                    best_iou, best_seg = i, s
            ious.append(best_iou)
            if best_iou > 0.5:
                det_tp += 1
            if best_seg is None:
                continue
            want = expected_type.get(v.kind)
            if want is not None:
                cls_total += 1
                if best_seg.segment_type == want:
                    cls_hits += 1
            # OCR CER over the texts drawn inside the visual (+ caption)
            if v.texts and best_seg.ocr_result:
                hyp = norm_text(best_seg.ocr_result.raw_text.replace("\n", " "))
                for truth_text in v.texts:
                    ref = norm_text(truth_text)
                    if not ref:
                        continue
                    # best matching window: min CER against any hyp substring
                    # alignment: use whole-hyp CER bounded by substring search
                    if ref in hyp:
                        cers.append(0.0)
                    else:
                        # align by sliding a window of len(ref) over hyp
                        best_c = 1.0
                        step = max(1, len(ref) // 2)
                        for st in range(0, max(1, len(hyp) - len(ref) + 1), step):
                            best_c = min(best_c, cer(ref, hyp[st : st + len(ref) + 2]))
                            if best_c == 0.0:
                                break
                        cers.append(best_c)
    return {
        "pages": pages,
        "detection_recall@0.5": round(det_tp / max(det_total, 1), 4),
        "mean_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "classification_accuracy": round(cls_hits / max(cls_total, 1), 4),
        "ocr_cer": round(float(np.mean(cers)) if cers else 1.0, 4),
        "n_truth_visuals": det_total,
        "n_detected": sum(len(v) for v in by_page.values()),
        "wall_s": round(pipe.stats.wall_s, 2),
    }


def evaluate_scanned(pages: int = 2, seed: int = 1,
                     device="cuda") -> Dict:
    """Scanned-page OCR: full-page noisy rasters of REAL text (PIL-rendered
    glyphs, grey background, sensor noise, skew) through the whole
    pipeline; CER against the exact drawn text. The content class the
    reference's PaddleOCR covered (ref :1791-1810)."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    tmp = tempfile.mkdtemp(prefix="synapta_scan_")
    pdf = os.path.join(tmp, "scan.pdf")
    truths, expected = make_scanned_book(pdf, pages=pages, seed=seed)
    pipe = VisualSegmentationPipeline(
        book_id="scan",
        pdf_path=pdf,
        output_dir=os.path.join(tmp, "out"),
        use_mermaid=False,
        config=PipelineConfig(use_vision_llm=False),
        llm_client=DisabledClient(),
        resume=False,
        device=device,
    )
    segs = pipe.process()
    by_page = {s.page_no - 1: s for s in segs}
    cers = []
    detected = 0
    for p, want in enumerate(expected):
        seg = by_page.get(p)
        if seg is None or not seg.ocr_result:
            cers.append(1.0)
            continue
        detected += 1
        hyp = norm_text(seg.ocr_result.raw_text.replace("\n", " "))
        ref = norm_text(want.replace("\n", " "))
        cers.append(cer(ref, hyp))
    wall = pipe.stats.wall_s
    return {
        "scanned_pages": pages,
        "scanned_detected": detected,
        "scanned_ocr_cer": round(float(np.mean(cers)), 4),
        "scanned_wall_s": round(wall, 2),
        "scanned_pages_per_s": round(pages / wall, 3) if wall else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--scanned", action="store_true",
                    help="also run the scanned-page OCR fixture")
    ap.add_argument("--scanned-pages", type=int, default=None,
                    help="page count for the scanned fixture "
                    "(default: min(--pages, 4))")
    ap.add_argument("--golden", action="store_true",
                    help="score OCR+classify against the reference's "
                    "recorded PaddleOCR output on its real golden crop")
    ap.add_argument("--golden-route", default="production",
                    choices=["production", "db"])
    args = ap.parse_args(argv)
    os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    if argv is None:
        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's
        # copy where the system has none
        ensure_native_engine(["-m", "synapta_tpu_torch.eval", *sys.argv[1:]])
    ensure_fixture_fonts()
    if args.golden:
        print(json.dumps(evaluate_golden_crop(args.golden_route, args.device)))
        return 0
    out = evaluate_book(args.pages, args.seed, device=args.device)
    if args.scanned:
        # scanned keys are all "scanned_"-prefixed so the merged JSON line
        # stays self-consistent (the clean run's "pages" is not clobbered)
        n = args.scanned_pages if args.scanned_pages else min(args.pages, 4)
        out.update(evaluate_scanned(pages=n, device=args.device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
