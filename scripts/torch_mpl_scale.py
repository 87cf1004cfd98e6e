"""A book from matplotlib's own PDF writer through the PyTorch port, at scale.

    python scripts/torch_mpl_scale.py [--pages 600] [--fonttype 42]
        [--book <tmp>/mpl_book_r4.pdf] [--out <tmp>/mpl_scale_out]
        [--skip-generate] [--device cuda|cpu]

The counterpart of scripts/mpl_scale_r4.py (which drives the JAX package),
with its book, arguments and output line: ``make_big_mpl_book`` (a verbatim
copy) draws ``--pages`` pages whose kind cycles with ``p % 8``: body text
only, line charts with mathtext legends, bar charts, a pie, a scatter and
two small figures on one page, each captioned; then the whole pipeline runs
on it with the LLM and Mermaid off. Needs matplotlib (``ImportError``
without it). Prints one JSON line: pages, wall, pages/s, segments by type,
OCR lines, pipeline errors and the host stage seconds. ``--device cuda``
(the default) raises without CUDA; ``--device cpu`` runs the kernels' plain
PyTorch twins.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_big_mpl_book(path: str, pages: int = 600, fonttype: int = 42,
                      seed: int = 7) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from matplotlib.backends.backend_pdf import PdfPages

    matplotlib.rcParams["pdf.fonttype"] = fonttype
    body = ("The portfolio return depends on the weighted average of "
            "individual asset returns where weights reflect the fraction "
            "of wealth allocated to each position. Diversification lowers "
            "total variance because asset returns are imperfectly "
            "correlated, so idiosyncratic shocks partially offset.")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    with PdfPages(path) as pdf:
        for p in range(pages):
            kind = p % 8
            fig = plt.figure(figsize=(6.12, 7.92))  # US-Letter-ish
            fig.text(0.12, 0.95, f"Chapter {p // 8 + 1}: Market Dynamics",
                     fontsize=13, fontweight="bold")
            fig.text(0.12, 0.86, body, fontsize=8, wrap=True,
                     va="top", ha="left")
            cap = None
            if kind == 0:
                fig.text(0.12, 0.55, body, fontsize=8, wrap=True, va="top")
                fig.text(0.12, 0.30, body, fontsize=8, wrap=True, va="top")
            elif kind in (1, 5):
                ax = fig.add_axes([0.18, 0.30, 0.64, 0.33])
                x = np.linspace(0, 10, 60)
                ax.plot(x, np.sin(x + p) + 0.1 * rng.normal(size=60),
                        label=r"stocks $\beta=1.2$")
                ax.plot(x, 0.5 * np.cos(x), "--",
                        label=r"bonds $\sigma=4.1\%$")
                ax.legend(fontsize=6)
                ax.set_xlabel("year", fontsize=7)
                ax.set_ylabel("cumulative return", fontsize=7)
                ax.grid(True)
                ax.tick_params(labelsize=6)
                cap = (0.28, f"Figure {p // 8 + 1}.{kind} Cumulative "
                       f"performance, scenario {p}")
            elif kind in (2, 6):
                ax = fig.add_axes([0.18, 0.30, 0.64, 0.33])
                ax.bar(list("ABCDEF"), rng.integers(1, 9, 6),
                       color="steelblue")
                ax.set_ylabel(r"weight $\mu$ (%)", fontsize=7)
                ax.tick_params(labelsize=6)
                cap = (0.28, f"Figure {p // 8 + 1}.{kind} Portfolio "
                       f"weights, draw {p}")
            elif kind == 3:
                ax = fig.add_axes([0.25, 0.28, 0.5, 0.38])
                ax.pie([40, 30, 20, 10],
                       labels=["stocks", "bonds", "cash", "gold"],
                       textprops={"fontsize": 6})
                cap = (0.26, f"Figure {p // 8 + 1}.3 Asset allocation")
            elif kind == 4:
                ax = fig.add_axes([0.18, 0.30, 0.64, 0.33])
                ax.scatter(rng.normal(size=80), rng.normal(size=80), s=8)
                ax.set_xlabel(r"risk $\sigma$", fontsize=7)
                ax.set_ylabel(r"return $E(r)$", fontsize=7)
                ax.tick_params(labelsize=6)
                cap = (0.28, f"Figure {p // 8 + 1}.4 Risk-return scatter")
            else:  # two small figures on one page
                ax1 = fig.add_axes([0.12, 0.32, 0.34, 0.26])
                ax1.bar(list("ABCD"), rng.integers(1, 9, 4),
                        color="darkorange")
                ax1.tick_params(labelsize=6)
                ax2 = fig.add_axes([0.56, 0.32, 0.34, 0.26])
                x = np.linspace(0, 8, 40)
                ax2.plot(x, np.cos(x + p))
                ax2.tick_params(labelsize=6)
                cap = (0.30, f"Figure {p // 8 + 1}.7 Weights and momentum")
            if cap:
                fig.text(0.5, cap[0] - 0.06, cap[1], ha="center",
                         fontsize=8)
            fig.text(0.12, 0.16, body, fontsize=8, wrap=True, va="top")
            fig.text(0.5, 0.04, str(p + 1), ha="center", fontsize=8)
            pdf.savefig(fig)
            plt.close(fig)
            if (p + 1) % 100 == 0:
                print(f"generated {p + 1}/{pages} "
                      f"({time.time() - t0:.0f}s)", flush=True)


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=600)
    ap.add_argument("--fonttype", type=int, default=42, choices=[3, 42])
    ap.add_argument("--book", default=os.path.join(tmp, "mpl_book_r4.pdf"))
    ap.add_argument("--out", default=os.path.join(tmp, "mpl_scale_out"))
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")

    from synapta_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA
    from synapta_tpu_torch.hostlibs import ensure_native_engine

    if argv is None:
        ensure_native_engine([os.path.abspath(__file__), *sys.argv[1:]])

    if not args.skip_generate or not os.path.exists(args.book):
        t0 = time.time()
        make_big_mpl_book(args.book, args.pages, args.fonttype)
        print(f"book generated in {time.time() - t0:.0f}s "
              f"({os.path.getsize(args.book) / 1e6:.1f} MB)", flush=True)

    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline
    from synapta_tpu_torch.utils.profiler import TIMERS

    pipe = VisualSegmentationPipeline(
        book_id="mplbook",
        pdf_path=args.book,
        output_dir=args.out,
        use_mermaid=False,
        config=PipelineConfig(use_vision_llm=False),
        llm_client=DisabledClient(),
        resume=False,
        device=device,
    )
    t0 = time.time()
    segs = pipe.process()
    wall = time.time() - t0
    pipe.close()
    by_type: dict = {}
    for s in segs:
        by_type[s.segment_type.value] = by_type.get(
            s.segment_type.value, 0) + 1
    ocr_lines = sum(len(s.ocr_result.blocks) for s in segs if s.ocr_result)
    print(json.dumps({
        "pages": args.pages,
        "fonttype": args.fonttype,
        "wall_s": round(wall, 1),
        "pages_per_s": round(args.pages / wall, 2),
        "segments": len(segs),
        "by_type": by_type,
        "ocr_lines": ocr_lines,
        "errors": pipe.stats.errors,
        "stage_s": {k: round(v["total_s"], 1)
                    for k, v in sorted(TIMERS.report().items())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
