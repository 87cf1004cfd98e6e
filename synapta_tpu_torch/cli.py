"""Command-line entry point of the PyTorch port:

    python -m synapta_tpu_torch.cli --pdf book.pdf --book-id textbook_001 \
        [--device cuda] [--taxonomy taxonomy.xlsx] \
        [--output-dir extracted_visuals] [--no-mermaid] [--no-llm] \
        [--no-resume] [--pages-per-batch 32]

The flags are synapta_tpu.cli's plus ``--device`` (default ``cuda``, which
fails without a GPU; ``cpu`` runs the kernels' plain PyTorch twins).
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="synapta_tpu_torch",
        description="Textbook visual segmentation pipeline (PyTorch/CUDA port)",
    )
    ap.add_argument("--pdf", required=True, help="input PDF path")
    ap.add_argument("--book-id", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--taxonomy", default=None,
                    help="concept taxonomy (.xlsx or .csv)")
    ap.add_argument("--output-dir", default="extracted_visuals")
    ap.add_argument("--no-mermaid", action="store_true")
    ap.add_argument("--no-llm", action="store_true",
                    help="skip the vision LLM (local heuristics only)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--pages-per-batch", type=int, default=None,
                    help="pages per super-batch (default: config's value)")
    ap.add_argument("--password", default="",
                    help="PDF user or owner password (RC4/AES-128/AES-256)")
    ap.add_argument("--stats-json", action="store_true",
                    help="print run stats as one JSON line at the end")
    args = ap.parse_args(argv)

    if argv is None:
        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's
        # copy where the system has none
        from synapta_tpu_torch.hostlibs import ensure_native_engine

        ensure_native_engine(["-m", "synapta_tpu_torch.cli", *sys.argv[1:]])

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    cfg = PipelineConfig(
        use_vision_llm=not args.no_llm,
        **({"pages_per_batch": args.pages_per_batch}
           if args.pages_per_batch else {}),
        pdf_password=args.password,
    )
    pipe = VisualSegmentationPipeline(
        book_id=args.book_id,
        pdf_path=args.pdf,
        taxonomy_path=args.taxonomy,
        output_dir=args.output_dir,
        use_mermaid=not args.no_mermaid,
        config=cfg,
        resume=not args.no_resume,
        device=args.device,
    )
    pipe.process()
    if args.stats_json:
        from synapta_tpu_torch.utils.profiler import TIMERS

        stats = pipe.stats.as_dict()
        stats["prepare_workers"] = pipe.prepare_workers
        stats["stage_s"] = {
            k: v["total_s"] for k, v in TIMERS.report().items()
        }
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
