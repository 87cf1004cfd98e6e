"""End-to-end benchmark of the PyTorch port: pages/s on the synthetic
textbook_001.

    python -m synapta_tpu_torch.bench [--device cuda|cpu]

The counterpart of the repo's root ``bench.py``, which drives the JAX
package: the same synthetic book (``make_test_book(pages, seed=42)``, cached
under ``<tmp>/synapta_bench_books`` by pages, seed and an md5 of the
generator file; the port's ``io/pdf_writer.py`` is a verbatim copy, so both
benches share one cached book), the same 8-concept taxonomy, the LLM and
Mermaid off, ``resume=False``, and a warmup on ``make_test_book(8, seed=7)``
that pays the kernels' nvcc build and the CUDA init.
``SYNAPTA_BENCH_PAGES`` (default 1000) and ``SYNAPTA_BENCH_RUNS`` (default
3) set the book and the number of reps. Every rep processes the same book
under the same book id, each into its own output directory, so the reps'
segment JSON can be compared.

Output, one line each:

- the card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` prints them (``cpu`` on the CPU);
- ``{"book", "pages", "cached", "gen_s"}`` and ``{"warmup_s"}``;
- one ``{"rep", "pages", "wall_s", "pages_per_s", "segments", "errors",
  "stage_s", "out"}`` per finished rep (``stage_s``: that rep's host stage
  seconds from ``utils.profiler.TIMERS``; ``out``: its output directory);
- last, the root bench's keys: ``{"metric", "value", "unit", "vs_baseline",
  "runs", "spread"}`` with ``value`` = pages / the shortest wall.
  ``vs_baseline`` is null: the repo's only baseline is a TPU target.

Exits 1 if a rep had pipeline errors or the reps' segment counts differ.
``--device cuda`` (the default) raises without CUDA; ``--device cpu`` runs
the kernels' plain PyTorch twins.

``DelayedFakeClient`` (the fake vision LLM with a real per-call latency) is
the LLM-on harness of ``scripts/torch_llm_at_scale.py`` and of the tests.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from synapta_tpu_torch.llm.fake import FakePixtralClient

METRIC = "pages_per_sec_per_chip_end_to_end_textbook_001"
BOOK_SEED = 42
WARMUP_PAGES_SEED = (8, 7)
TAXONOMY = [
    ("Portfolio Diversification", "risk variance"),
    ("Expected Return", "mean"),
    ("Risk-Free Rate", "treasury"),
    ("Asset Allocation", "weights"),
    ("Utility Maximization", "preference"),
    ("Cumulative Performance", "stocks bonds"),
    ("Quarterly Returns", "periods"),
    ("Investment Decision Process", "screening approval"),
]


class DelayedFakeClient(FakePixtralClient):
    """FakePixtralClient whose futures resolve after a real delay on a
    thread pool of ``workers`` threads: the external vision LLM's per-call
    latency (the harness of the JAX package's tests/test_llm_async.py and
    scripts/llm_at_scale.py)."""

    def __init__(self, delay: float, workers: int = 64, **kw):
        super().__init__(**kw)
        self.delay = delay
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def _delayed(self, fn, *args):
        def work():
            time.sleep(self.delay)
            return fn(*args)

        return self._pool.submit(work)

    def submit_comprehensive(self, pixels, ocr):
        return self._delayed(self.analyze_comprehensive, pixels, ocr)

    def submit_mermaid(self, pixels, visual_type, ocr):
        return self._delayed(self.extract_mermaid, pixels, visual_type, ocr)

    def submit_calculations(self, pixels, ocr, nearby):
        return self._delayed(self.extract_calculations, pixels, ocr, nearby)

    def shutdown(self):
        self._pool.shutdown(wait=True)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu"
    for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "unknown, unknown"


def cached_book(pages: int, seed: int = BOOK_SEED):
    """-> (path, seconds spent generating it or None if it was cached):
    ``make_test_book(pages, seed)`` under ``<tmp>/synapta_bench_books``,
    keyed by pages, seed and the generator file's md5 (the root bench's
    scheme and file name)."""
    import synapta_tpu_torch.io.pdf_writer as pw

    cache_dir = os.path.join(tempfile.gettempdir(), "synapta_bench_books")
    os.makedirs(cache_dir, exist_ok=True)
    with open(pw.__file__, "rb") as f:
        gen_hash = hashlib.md5(f.read()).hexdigest()[:10]
    path = os.path.join(cache_dir, f"textbook_p{pages}_s{seed}_{gen_hash}.pdf")
    if os.path.exists(path):
        return path, None
    t0 = time.perf_counter()
    part = path + ".tmp"
    pw.make_test_book(part, pages=pages, seed=seed)
    os.replace(part, path)
    return path, time.perf_counter() - t0


def warmup_book(tmp: str) -> str:
    """The 8-page warmup book (seed 7) in ``tmp``."""
    from synapta_tpu_torch.io.pdf_writer import make_test_book

    path = os.path.join(tmp, "warm.pdf")
    make_test_book(path, pages=WARMUP_PAGES_SEED[0], seed=WARMUP_PAGES_SEED[1])
    return path


def stage_delta(before: dict) -> dict:
    """Host stage seconds (``TIMERS``) spent since ``before`` was taken,
    largest first."""
    from synapta_tpu_torch.utils.profiler import TIMERS

    delta = {k: v - before.get(k, 0.0) for k, v in TIMERS.totals.items()}
    return dict(sorted(((k, v) for k, v in delta.items() if v > 0),
                       key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="synapta_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")
    from synapta_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts, ensure_native_engine

    if argv is None:
        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's
        # copy where the system has none
        ensure_native_engine(["-m", "synapta_tpu_torch.bench", *sys.argv[1:]])
    ensure_fixture_fonts()
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.xlsx import write_xlsx
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline
    from synapta_tpu_torch.utils.profiler import TIMERS

    print(card_line(device), flush=True)
    pages = int(os.environ.get("SYNAPTA_BENCH_PAGES", "1000"))
    runs = max(int(os.environ.get("SYNAPTA_BENCH_RUNS", "3")), 1)
    pdf_path, gen_s = cached_book(pages)
    print(json.dumps({"book": pdf_path, "pages": pages, "cached": gen_s is None,
                      "gen_s": gen_s}), flush=True)
    tmp = tempfile.mkdtemp(prefix="synapta_bench_")
    tax_path = os.path.join(tmp, "taxonomy.xlsx")
    write_xlsx(tax_path, [["Level", "Concept", "Tag(s)", "Rationale", "Page(s)"]]
               + [["1", c, t, "", ""] for c, t in TAXONOMY])

    def run(book_id: str, pdf: str, out: str):
        pipe = VisualSegmentationPipeline(
            book_id=book_id, pdf_path=pdf, taxonomy_path=tax_path,
            output_dir=out, use_mermaid=False,
            config=PipelineConfig(use_vision_llm=False), resume=False,
            device=device,
        )
        t0 = time.perf_counter()
        pipe.process()
        wall = time.perf_counter() - t0
        pipe.close()
        return wall, pipe

    wall, _ = run("warmup", warmup_book(tmp), os.path.join(tmp, "warmup"))
    print(json.dumps({"warmup_s": wall}), flush=True)

    walls, segments, errors = [], [], []
    for i in range(runs):
        before = dict(TIMERS.totals)
        out = os.path.join(tmp, f"rep{i + 1}")
        wall, pipe = run("textbook_001", pdf_path, out)
        walls.append(wall)
        segments.append(len(pipe.writer.segments))
        errors.append(pipe.stats.errors)
        print(json.dumps({
            "rep": i + 1, "pages": pipe.stats.pages, "wall_s": wall,
            "pages_per_s": pages / wall, "segments": segments[-1],
            "errors": errors[-1], "stage_s": stage_delta(before), "out": out,
        }), flush=True)
    per_run = [round(pages / w, 3) for w in walls]
    print(json.dumps({
        "metric": METRIC,
        "value": round(pages / min(walls), 3),
        "unit": "pages/s",
        "vs_baseline": None,
        "runs": per_run,
        "spread": round((max(per_run) - min(per_run)) / max(per_run), 3),
    }), flush=True)
    if any(errors) or len(set(segments)) != 1:
        print(f"bench: errors {errors}, segments {segments}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
