"""Which recognizer frames make a text line differ between the PyTorch port
and the JAX pipeline, and how close each one is to a tie (CPU).

    JAX_PLATFORMS=cpu python scripts/near_tie_frames.py BOOK.pdf
        [--book-id ID] [--config '{"pages_per_batch": 4}'] [--save-views PATH]

Runs the port (``device="cpu"``) and the JAX pipeline (one data device) on
the book with the LLM off and applies the OCR yardstick of chip_smoke.py
to them (tests/torchparity.py, the JAX run the reference). It prints one
JSON line for every tile whose bf16 greedy paths differ (its segment, line
box, the two bf16 texts and the two float32 texts, and for each frame that
differs each model's two most likely characters and the logit gap between
them), one for every line that only one run cut (its DB box differs), then
the yardstick's counts and verdicts (its ``float64`` part: (a0) and each
float32's distance to JAX's float64) and the keys (c) found outside what
it excused. ``--save-views`` writes the non-white DB views that the port's
run handed its DB detector to an .npy (the input of
``scripts/bf16_op_parity.py --views``). Needs the JAX package, so it is no
script of the port's own (scripts/torch_*.py).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pdf")
    ap.add_argument("--book-id", default="tie")
    ap.add_argument("--config", default="{}",
                    help="PipelineConfig keywords as JSON, for both pipelines")
    ap.add_argument("--save-views", help="write the port run's DB views here")
    args = ap.parse_args(argv)

    from chip_smoke import helper_module, real_views

    sys.path.insert(0, os.path.join(HERE, "tests"))  # torchparity's imports
    parity = helper_module("torchparity")
    run = parity.evaluated(parity.runs(
        args.pdf, tempfile.mkdtemp(prefix="synapta_ties_"), args.book_id,
        **json.loads(args.config)))
    report, keys = parity.yardstick(run["jax"], run["port"], args.book_id)
    if args.save_views:
        import numpy as np

        views = np.concatenate([c["views"] for c in run["port"]["db"]])
        np.save(args.save_views, views[real_views(views)])
    for tile in report.pop("excused_tiles"):
        print(json.dumps(tile, ensure_ascii=False), flush=True)
    for line in report.pop("unpaired"):
        print(json.dumps({"unpaired": line}, ensure_ascii=False), flush=True)
    report.pop("excused_lines")
    print(json.dumps({**report, "key_faults": keys["faults"],
                      "errors": [run[s]["pipe"].stats.errors
                                 for s in ("port", "jax")]},
                     ensure_ascii=False, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
