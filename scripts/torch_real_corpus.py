"""A book of real textbook crops, one JPEG image a page, through the
PyTorch port.

    python scripts/torch_real_corpus.py [--limit N] [--out DIR]
        [--device cuda|cpu]

The counterpart of scripts/real_corpus_r5.py (which drives the JAX
package), with its book, arguments and output line. ``build_book`` (a
verbatim copy) reads every PNG crop of ``CORPUS`` in name order and puts
each on a page of its own, embedded as a DCT (JPEG) image XObject at its
native 150-DPI size, shrunk only where it would cross the margins; ``run``
processes that book with the LLM off and reports what the crops support
without ground truth: pages with an ``embedded_image`` segment, pipeline
errors, pages/s, the classification histogram, the mean OCR confidence,
OCR blocks and the finance terms found in the OCR text.

``CORPUS`` is the reference project's ``investments_segmented`` folder of
591 crops, named from the reference project's root (the current directory);
a caller may set the module's ``CORPUS`` to any folder of PNG crops before
calling ``build_book``. Prints the book's size on stderr and one JSON line.
``--device cuda`` (the default) raises without CUDA; ``--device cpu`` runs
the kernels' plain PyTorch twins.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CORPUS = "reference/investments_segmented"
MARGIN = 36.0
PAGE_W, PAGE_H = 612.0, 792.0

# finance terms a Bodie/Kane/Marcus *Investments* figure corpus must
# surface in OCR text (same vocabulary family as the golden taxonomy)
FINANCE_TERMS = [
    "return", "risk", "portfolio", "stock", "bond", "price", "rate",
    "market", "yield", "option", "asset", "equity", "index", "value",
    "capital", "interest", "fund", "investment", "beta", "volatility",
]


def build_book(pdf_path: str, limit: int | None = None) -> int:
    from PIL import Image

    from synapta_tpu_torch.io.pdf_writer import SyntheticBook

    paths = sorted(glob.glob(os.path.join(CORPUS, "*.png")))
    if limit:
        paths = paths[:limit]
    book = SyntheticBook(PAGE_W, PAGE_H)
    for p in paths:
        arr = np.asarray(Image.open(p).convert("RGB"))
        h, w = arr.shape[:2]
        # native placement: crops were rendered at 150 DPI, so natural
        # size is px * 72/150; shrink only when that overflows margins
        w_pt, h_pt = w * 72.0 / 150.0, h * 72.0 / 150.0
        s = min(1.0, (PAGE_W - 2 * MARGIN) / w_pt,
                (PAGE_H - 2 * MARGIN) / h_pt)
        w_pt, h_pt = w_pt * s, h_pt * s
        x0 = (PAGE_W - w_pt) / 2.0
        y0 = (PAGE_H - h_pt) / 2.0
        c = book.new_page()
        c.image(arr, x0, y0, x0 + w_pt, y0 + h_pt, mode="jpeg")
    book.save(pdf_path)
    return len(paths)


def run(pdf_path: str, out_dir: str, n_pages: int, device="cuda") -> dict:
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    pipe = VisualSegmentationPipeline(
        book_id="investments_real",
        pdf_path=pdf_path,
        output_dir=out_dir,
        use_mermaid=False,
        config=PipelineConfig(use_vision_llm=False),
        llm_client=DisabledClient(),
        resume=False,
        device=device,
    )
    t0 = time.time()
    segs = pipe.process()
    wall = time.time() - t0

    pages_with_embedded = {
        s.page_no for s in segs if s.extraction_method == "embedded_image"
    }
    hist = collections.Counter(s.segment_type.value for s in segs)
    confs = [s.ocr_result.confidence for s in segs
             if s.ocr_result and s.ocr_result.blocks]
    blocks = sum(len(s.ocr_result.blocks) for s in segs if s.ocr_result)
    all_text = " ".join(
        s.ocr_result.raw_text.lower() for s in segs if s.ocr_result
    )
    words = set(re.findall(r"[a-z]+", all_text))
    terms_found = sorted(t for t in FINANCE_TERMS if t in words)
    pipe.close()
    return {
        "pages": n_pages,
        "segments": len(segs),
        "pages_with_embedded_segment": len(pages_with_embedded),
        "swallowed_errors": pipe.stats.errors,
        "wall_s": round(wall, 2),
        "pages_per_s": round(n_pages / wall, 2),
        "classification_histogram": dict(sorted(hist.items())),
        "mean_ocr_confidence": round(float(np.mean(confs)), 4) if confs else 0.0,
        "segments_with_text": len(confs),
        "ocr_blocks": blocks,
        "finance_terms_found": len(terms_found),
        "finance_terms": terms_found,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")
    from synapta_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA
    from synapta_tpu_torch.hostlibs import ensure_native_engine

    if argv is None:
        ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    tmp = args.out or tempfile.mkdtemp(prefix="synapta_real_")
    os.makedirs(tmp, exist_ok=True)
    pdf = os.path.join(tmp, "investments_real.pdf")
    t0 = time.time()
    n = build_book(pdf, args.limit)
    print(f"book built: {n} pages, {os.path.getsize(pdf)/1e6:.1f} MB, "
          f"{time.time()-t0:.1f}s", file=sys.stderr)
    res = run(pdf, os.path.join(tmp, "out"), n, device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
