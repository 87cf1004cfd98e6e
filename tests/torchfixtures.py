"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Rendered crops come from the synthetic book through the host prepare stage
(detect + render into 512x512 canvases), exactly as the pipelines feed
their analyze pass; random inputs come from numpy with fixed seeds.
"""
import functools

import numpy as np
import torch


def pin_threads() -> None:
    """One intra-op torch thread in this test process. The tier-1 run puts
    six pytest-xdist workers on the host's cores; torch's default of a
    thread per core in each of them oversubscribes the host (one 101-step
    CPU training run of the recognizer: 13 s alone, over 900 s six at a
    time; one thread each: 19-22 s six at a time). It also fixes the order
    of the port's float32 CPU sums, which the thread count sets."""
    torch.set_num_threads(1)


pin_threads()


@functools.lru_cache(maxsize=4)
def rendered_canvases(pages: int = 8, seed: int = 2):
    """(N, 512, 512, 3) uint8 region canvases and (N, 2) int32 true
    (h, w) sizes for every visual region of make_test_book(pages, seed)."""
    import tempfile

    from synapta_tpu.config import PipelineConfig
    from synapta_tpu.io.ingest import open_pdf
    from synapta_tpu.io.loader import prepare_batch
    from synapta_tpu.io.pdf_writer import make_test_book
    from synapta_tpu.vision.detect import DetectionEngine

    path = tempfile.mkdtemp(prefix="torchfx_") + "/book.pdf"
    make_test_book(path, pages=pages, seed=seed)
    cfg = PipelineConfig()
    render_doc = open_pdf(path)
    engine = DetectionEngine(open_pdf(path), cfg.detection,
                             pixels_doc=render_doc)
    prepared = prepare_batch(engine, render_doc, cfg.detection.render_dpi,
                             cfg.ocr.crop_size, range(pages))
    canvases = np.array(prepared[1])  # copy out of the loader's ring
    sizes = np.array([tuple(d) for d in prepared[2]], np.int32)
    return canvases, sizes


def crops(n: int, blank_last: bool = False):
    """The first n rendered canvases (optionally with the last one blank)
    plus their sizes."""
    canvases, sizes = rendered_canvases()
    c = canvases[:n].copy()
    s = sizes[:n].copy()
    if blank_last:
        c[-1] = 255
        s[-1] = (1, 1)
    return c, s


def gray_and_color(canvases):
    """Host split of the analyze pass: (gray u8, eighth-res RGB)."""
    from synapta_tpu.ops.color import gray_quarter_host

    gray, rgb_q = gray_quarter_host(canvases)
    return gray, np.ascontiguousarray(rgb_q[:, ::2, ::2])
