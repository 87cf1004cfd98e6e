"""Batch-shape sweep of the PyTorch port: pages/s at six chunk shapes.

    python scripts/torch_sweep.py [reps] [cfg ...] [--device cuda|cpu]

The counterpart of scripts/sweep_r3.py (which drives the JAX package): the
same configurations (``CFGS``: ``base``, ``ppb32``, ``cb32``, ``lb256``,
``cb32lb256``, ``cb64lb256``; default ``base cb32 cb32lb256``), run in
interleaved reps over one book with the LLM off. ``crop_batch`` is the
analyze chunk (the CC and edge-stats kernels' B), ``line_batch`` the
recognizer's tile batch, ``pages_per_batch`` the host super-batch.

The book is the port bench's cached ``make_test_book(pages, 42)``
(``synapta_tpu_torch.bench.cached_book``; ``SYNAPTA_SWEEP_PAGES``, default
1000, generated on first use) or the PDF that ``SYNAPTA_SWEEP_PDF`` names,
whose page count ``SYNAPTA_SWEEP_PAGES`` then gives.

Output, one line each: the card's name and power limit (nvidia-smi; ``cpu``
on the CPU); one ``{"cfg", "rep", "wall_s", "pages_per_s", "key"}`` per run
(``key``: that run's seconds in the host stages the JAX script reports,
from ``utils.profiler.TIMERS``); last, ``{"best": {cfg: pages/s}}``, the
best run of each configuration. ``--device cuda`` (the default) raises
without CUDA; ``--device cpu`` runs the kernels' plain PyTorch twins.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")

CFGS = {
    "base": {},
    "ppb32": {"pages_per_batch": 32},
    "cb32": {"crop_batch": 32},
    "lb256": {"line_batch": 256},
    "cb32lb256": {"crop_batch": 32, "line_batch": 256},
    "cb64lb256": {"crop_batch": 64, "line_batch": 256},
}
KEY_STAGES = ("prepare_body", "features", "features_dispatch", "ocr_recognize",
              "ocr_dispatch", "ocr_tile_prep")


def sweep_config(name: str):
    """The pipeline configuration of one ``CFGS`` entry, LLM off."""
    from synapta_tpu_torch.config import OCRConfig, PipelineConfig

    ov = CFGS[name]
    ocr_kw = {k: v for k, v in ov.items() if k in ("crop_batch", "line_batch")}
    return PipelineConfig(
        use_vision_llm=False,
        pages_per_batch=ov.get("pages_per_batch", 64),
        ocr=OCRConfig(**ocr_kw),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("reps", nargs="?", type=int, default=2)
    ap.add_argument("cfg", nargs="*",
                    help=f"of {', '.join(CFGS)} (default: base cb32 cb32lb256)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = args.cfg or ["base", "cb32", "cb32lb256"]
    unknown = [n for n in names if n not in CFGS]
    if unknown:
        ap.error(f"unknown configurations {unknown}")

    from synapta_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    if argv is None:
        ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    ensure_fixture_fonts()
    from synapta_tpu_torch.bench import cached_book, card_line
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline
    from synapta_tpu_torch.utils.profiler import TIMERS

    print(card_line(device), flush=True)
    n_pages = int(os.environ.get("SYNAPTA_SWEEP_PAGES", "1000"))
    pdf = os.environ.get("SYNAPTA_SWEEP_PDF") or cached_book(n_pages)[0]
    if not os.path.exists(pdf):
        raise SystemExit(f"sweep book {pdf} missing")
    tmp = tempfile.mkdtemp(prefix="synapta_sweep_")

    best: dict = {}
    run_id = 0
    for rep in range(args.reps):
        for name in names:
            TIMERS.totals.clear()
            TIMERS.counts.clear()
            pipe = VisualSegmentationPipeline(
                book_id=f"sw_{name}_{run_id}", pdf_path=pdf,
                taxonomy_path=None,
                output_dir=os.path.join(tmp, f"{name}_{run_id}"),
                use_mermaid=False, config=sweep_config(name), resume=False,
                device=device)
            run_id += 1
            t0 = time.time()
            pipe.process()
            wall = time.time() - t0
            pipe.close()
            r = TIMERS.report()
            rec = {
                "cfg": name, "rep": rep, "wall_s": round(wall, 1),
                "pages_per_s": round(n_pages / wall, 2),
                "key": {k: round(r[k]["total_s"], 1) for k in KEY_STAGES
                        if k in r},
            }
            print(json.dumps(rec), flush=True)
            if name not in best or wall < best[name]:
                best[name] = wall
    print(json.dumps({"best": {k: round(n_pages / v, 2)
                               for k, v in best.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
