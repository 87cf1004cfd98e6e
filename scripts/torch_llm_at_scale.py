"""LLM-on against LLM-off at book scale, on the PyTorch port.

    python scripts/torch_llm_at_scale.py [--pages 1000] [--delay 2.0]
        [--workers 64] [--device cuda]

The counterpart of scripts/llm_at_scale.py (which drives the JAX package):
the bench's cached book (``synapta_tpu_torch.bench.cached_book``), one
shared ``TorchOCR`` over both runs, the 8-page warmup, then two runs of the
book: the vision LLM off, then ``bench.DelayedFakeClient`` (the port's fake
client with ``--delay`` seconds a call on a pool of ``--workers`` threads)
with the late patches it lands through ``writer.update()``.

Output, one line each: the card's name and power limit (nvidia-smi); the
LLM run's client calls (``calls``: comprehensive, Mermaid and calculation
calls; ``calls_per_page``) beside both runs' pages/s, from which a pool can
be sized by Little's law (calls/page x pages/s x delay); last, the JAX
script's keys (``wall_off_s``, ``wall_on_s``, ``overhead_pct``,
``segments_off/on``, ``llm_patches``, ``llm_unpatched``,
``llm_drain_wait_s``, ``errors_off/on``). The JAX script's criterion: the
LLM-on wall within 5% of the LLM-off wall, every patch landed
(``llm_unpatched`` 0).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=1000)
    ap.add_argument("--delay", type=float, default=2.0)
    ap.add_argument("--workers", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from synapta_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    if argv is None:
        ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])
    ensure_fixture_fonts()
    from synapta_tpu_torch.bench import (
        DelayedFakeClient,
        cached_book,
        card_line,
        warmup_book,
    )
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    print(card_line(device), flush=True)
    pdf_path, gen_s = cached_book(args.pages)
    tmp = tempfile.mkdtemp(prefix="synapta_llmscale_")
    ocr = TorchOCR(device=device)  # one recognizer over both runs

    def run(tag: str, pdf: str, client):
        pipe = VisualSegmentationPipeline(
            book_id=f"llmscale_{tag}", pdf_path=pdf,
            output_dir=os.path.join(tmp, tag), use_mermaid=client is not None,
            config=PipelineConfig(use_vision_llm=False), llm_client=client,
            ocr=ocr, resume=False, device=device,
        )
        t0 = time.perf_counter()
        pipe.process()
        wall = time.perf_counter() - t0
        pipe.close()
        return wall, pipe.stats, len(pipe.writer.segments)

    run("warm", warmup_book(tmp), None)
    base_wall, base_stats, base_segs = run("off", pdf_path, None)
    client = DelayedFakeClient(args.delay, workers=args.workers)
    llm_wall, llm_stats, llm_segs = run("on", pdf_path, client)
    client.shutdown()
    calls = len(client.calls)
    print(json.dumps({
        "pages": args.pages, "book_gen_s": gen_s, "calls": calls,
        "calls_per_page": calls / args.pages,
        "pages_per_s_off": args.pages / base_wall,
        "pages_per_s_on": args.pages / llm_wall,
        "llm_analyses": llm_stats.llm_analyses,
    }), flush=True)
    print(json.dumps({
        "pages": args.pages,
        "delay_s": args.delay,
        "workers": args.workers,
        "wall_off_s": round(base_wall, 2),
        "wall_on_s": round(llm_wall, 2),
        "overhead_pct": round(100 * (llm_wall - base_wall) / base_wall, 2),
        "segments_off": base_segs,
        "segments_on": llm_segs,
        "llm_patches": llm_stats.llm_patches,
        "llm_unpatched": llm_stats.llm_unpatched,
        "llm_drain_wait_s": llm_stats.llm_drain_wait_s,
        "errors_off": base_stats.errors,
        "errors_on": llm_stats.errors,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
