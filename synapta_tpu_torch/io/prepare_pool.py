"""Host prepare of one super-batch on a pool of threads.

Each page's detection and region renders are independent of every other
page's, and their costly parts (the native engine's page metadata, image
decodes and renders, ``box_downscale``, ``zlib.crc32``, the PNG encodes)
run in native code that releases the GIL. So ``BookPreparer`` spreads the
pages of a super-batch over host threads:

- phase 1, on the workers: each thread owns a document-handle pair and a
  ``DetectionEngine`` for the book (a native handle carries its own mutex),
  opened on the thread itself at its first page, and takes pages one at a
  time; a page's detection and renders run on one thread and one pair, which
  keeps the pair's document-level decoded-image cache warm
  (``DetectionEngine.pixels_doc``);
- phase 2, on the calling thread: each page's parsed metadata and text
  blocks pass to the pipeline's document, where the serial path leaves them
  for the enrich stage; one canvas batch is leased from the loader's ring,
  as ``loader.prepare_batch`` leases it, and the results are pasted in page
  order, then region order.

Before the first threaded batch of the process, ``load_font_substitutes``
makes the engine's shared substitute faces read-only (see there).

The result equals ``loader.prepare_batch``'s byte for byte (regions and
their digests, canvases, dims, PNG bytes, keep flags, hires renders),
whatever the number of threads; with one thread it is that call, on the
pipeline's own handles.
"""
from __future__ import annotations

import io as _io
import os
import threading
import zlib
from concurrent.futures import wait
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from synapta_tpu_torch.io.ingest import Document, open_pdf
from synapta_tpu_torch.io import loader
from synapta_tpu_torch.io.loader import PreparedBatch, prepare_batch
from synapta_tpu_torch.utils.log import get_logger
from synapta_tpu_torch.utils.profiler import TIMERS, SpanPool
from synapta_tpu_torch.vision.detect import DetectionEngine

log = get_logger("prepare_pool")

# cores left to the threads that run beside a prepare: the main thread
# (waiting here, then pasting) and the device feed; the PNG encoders share
# the rest with the workers
SPARE_CORES = 2


def prepare_threads(n_pages: int) -> int:
    """Worker threads for a span of ``n_pages``: the cores this process may
    run on less ``SPARE_CORES``, at least one and at most one a page."""
    return max(1, min(n_pages, len(os.sched_getaffinity(0)) - SPARE_CORES))


_POOL: Optional[SpanPool] = None
_POOL_LOCK = threading.Lock()


def prepare_pool() -> SpanPool:
    """Module-level thread pool, one thread for each core this process may
    run on, made at first use and kept across books; its tasks run in their
    submitter's span context."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = SpanPool(max_workers=len(os.sched_getaffinity(0)),
                             thread_name_prefix="prepare")
        return _POOL


# The engine draws a font that a document does not embed with one of four
# substitute faces (sans, bold, serif, mono), each loaded once for the whole
# process and shared by every document handle. A face parses a glyph's
# outline at its first use and adds it to a map without a lock, so two
# handles on two threads may write that map at once. The warm-up page below
# sets every glyph id of the four faces once, on one thread: each base font
# is a composite font without widths, so laying out its 65535 two-byte codes
# reads every glyph id from 1 to 65535 through the face; from then on the
# faces' maps are only read.
SUBSTITUTE_FONTS = ("Helvetica", "Helvetica-Bold", "Times-Roman", "Courier")
_SUBSTITUTES_DONE = False
_SUBSTITUTES_LOCK = threading.Lock()


def _substitutes_pdf() -> bytes:
    """One page that shows every two-byte code in each of
    ``SUBSTITUTE_FONTS``, as invisible text."""
    codes = b"<" + b"".join(b"%04X" % c for c in range(1, 1 << 16)) + b">"
    content = b"".join(b"BT /F%d 1 Tf 3 Tr %s Tj ET\n" % (i, codes)
                       for i in range(len(SUBSTITUTE_FONTS)))
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Resources << /Font << "
        + b"".join(b"/F%d %d 0 R " % (i, 5 + i) for i in range(len(SUBSTITUTE_FONTS)))
        + b">> >> /Contents 4 0 R >>",
        b"<< /Length %d >>\nstream\n%s\nendstream" % (len(content), content),
    ] + [b"<< /Type /Font /Subtype /Type0 /BaseFont /%s /Encoding /Identity-H "
         b"/DescendantFonts [<< /Type /Font /Subtype /CIDFontType2 /BaseFont /%s "
         b"/CIDSystemInfo << /Registry (Adobe) /Ordering (Identity) /Supplement 0 >> >>] >>"
         % (f.encode(), f.encode()) for f in SUBSTITUTE_FONTS]
    out = _io.BytesIO()
    out.write(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(out.tell())
        out.write(b"%d 0 obj\n%s\nendobj\n" % (i, body))
    xref = out.tell()
    out.write(b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1))
    out.write(b"".join(b"%010d 00000 n \n" % o for o in offsets))
    out.write(b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
              % (len(objs) + 1, xref))
    return out.getvalue()


def load_font_substitutes() -> None:
    """Set every glyph of the engine's substitute faces, once in this
    process, before two threads use the engine at once."""
    global _SUBSTITUTES_DONE
    with _SUBSTITUTES_LOCK:
        if not _SUBSTITUTES_DONE:
            with Document(data=_substitutes_pdf()) as doc:
                doc.page_spans(0)
            _SUBSTITUTES_DONE = True


def _encode_png(img: np.ndarray) -> bytes:
    """``loader.prepare_batch``'s encoder: the native one, else PIL's."""
    with TIMERS.stage("png_encode"):
        try:
            from synapta_tpu_torch.io.ingest import png_encode

            return png_encode(img)
        except Exception:
            from PIL import Image

            bio = _io.BytesIO()
            Image.fromarray(img).save(bio, format="PNG", compress_level=1)
            return bio.getvalue()


class BookPreparer:
    """Prepares the super-batches of one book on ``prepare_threads`` threads
    (``prepare``); ``close`` closes every worker's handles."""

    def __init__(self, pdf_path: str, password: str, det_cfg, canvas_size: int,
                 engine: DetectionEngine, render_doc: Document, png_pool=None):
        self.pdf_path = pdf_path
        self.password = password
        self.det_cfg = det_cfg
        self.canvas_size = canvas_size
        self.engine = engine  # the pipeline's own pair: the one-thread path
        self.render_doc = render_doc
        self.png_pool = png_pool
        self._handles: Dict[int, Tuple[DetectionEngine, Document]] = {}
        self._lock = threading.Lock()

    def prepare(self, pages: Sequence[int]) -> Tuple[Optional[PreparedBatch], int]:
        """-> (``loader.prepare_batch``'s result for ``pages``, the threads
        that prepared it)."""
        pages = list(pages)
        n = prepare_threads(len(pages))
        if n == 1:
            return prepare_batch(
                self.engine, self.render_doc, self.det_cfg.render_dpi,
                self.canvas_size, pages, png_pool=self.png_pool,
            ), 1
        load_font_substitutes()
        results: List[Any] = [None] * len(pages)
        docs: List[Optional[Document]] = [None] * len(pages)
        next_page = iter(range(len(pages)))
        futs = [prepare_pool().submit(self._work, pages, next_page, results, docs)
                for _ in range(n)]
        wait(futs)
        threads = {f.result() for f in futs} - {None}
        self._adopt_pages(pages, docs)
        return self._paste(results), len(threads)

    def _work(self, pages: List[int], next_page, results: List[Any],
              docs: List[Optional[Document]]) -> Optional[int]:
        """Worker: take pages until none is left, noting the document that
        read each; -> this thread's id, or None if it took none."""
        handles = None
        while True:
            with self._lock:
                k = next(next_page, None)
            if k is None:
                return None if handles is None else threading.get_ident()
            handles = handles or self._thread_handles()
            results[k] = self._page(*handles, pages[k])
            docs[k] = handles[0].doc

    def _adopt_pages(self, pages: List[int], docs: List[Optional[Document]]) -> None:
        """Hand each page's parsed metadata and text blocks from the worker's
        document to the pipeline's, where the serial path leaves them and
        the enrich stage reads them, so that no page is parsed again on the
        calling thread."""
        doc = self.engine.doc
        for p, src in zip(pages, docs):
            if src is None:
                continue
            for cache in ("_meta_cache", "_blocks_cache"):
                got = getattr(src, cache).get(p)
                if got is not None:
                    getattr(doc, cache).setdefault(p, got)

    def _thread_handles(self) -> Tuple[DetectionEngine, Document]:
        """This thread's pair for the book, opened at its first page."""
        me = threading.get_ident()
        handles = self._handles.get(me)
        if handles is None:
            with TIMERS.stage("ingest_open"):
                doc = open_pdf(self.pdf_path, self.password)
                render_doc = open_pdf(self.pdf_path, self.password)
            handles = (DetectionEngine(doc, self.det_cfg, pixels_doc=render_doc),
                       render_doc)
            with self._lock:
                self._handles[me] = handles
        return handles

    def _page(self, engine: DetectionEngine, render_doc: Document, p: int):
        """Detect and render one page, as ``loader.prepare_batch``'s loop
        does: -> [(region, (canvas render, hires context, PNG) or the
        exception its render raised)], or None where detection raised."""
        try:
            with TIMERS.stage("detect"):
                found = engine.detect_page(p)
        except Exception:
            log.exception("detection failed on page %d", p)
            return None
        render_dpi = self.det_cfg.render_dpi
        canvas_size = self.canvas_size
        out = []
        for r in found:
            try:
                w_pt = max(r.bbox.x1 - r.bbox.x0, 1.0)
                h_pt = max(r.bbox.y1 - r.bbox.y0, 1.0)
                dpi = min(render_dpi, 72.0 * canvas_size / max(w_pt, h_pt))
                clip = [r.bbox.x0, r.bbox.y0, r.bbox.x1, r.bbox.y1]
                with TIMERS.stage("render"):
                    if dpi >= render_dpi - 1e-6:
                        arr = render_doc.render(r.page_num, dpi=dpi, clip=clip)
                        hi, ctx_val = arr, None
                    elif getattr(engine.cfg, "single_render", True):
                        from synapta_tpu_torch.io.ingest import box_downscale

                        hi = render_doc.render(r.page_num, dpi=render_dpi, clip=clip)
                        scale = dpi / 72.0
                        oh = max(1, int(h_pt * scale + 0.5))
                        ow = max(1, int(w_pt * scale + 0.5))
                        arr = box_downscale(hi, oh, ow)
                        ctx_val = (hi, render_dpi / dpi)
                    else:
                        arr = render_doc.render(r.page_num, dpi=dpi, clip=clip)
                        hi = render_doc.render(r.page_num, dpi=render_dpi, clip=clip)
                        ctx_val = (hi, render_dpi / dpi)
                png = (self.png_pool.submit(_encode_png, hi)
                       if self.png_pool is not None else _encode_png(hi))
                hi_c = hi if hi.flags["C_CONTIGUOUS"] else np.ascontiguousarray(hi)
                r.content_digest = f"{zlib.crc32(hi_c) & 0xffffffff:08x}"
                out.append((r, (arr, ctx_val, png)))
            except Exception as e:
                out.append((r, e))
        return out

    def _paste(self, results: List[Any]) -> Optional[PreparedBatch]:
        """Phase 2: the pages' results into one leased canvas batch."""
        items = [item for page in results if page is not None for item in page]
        if not items:
            return None
        canvas_size = self.canvas_size
        regions = [r for r, _ in items]
        canvases = loader._lease_canvases(len(regions), canvas_size)
        dims: List[tuple] = []
        pngs: List[Any] = []
        keep: List[bool] = []
        ctxs: List[Any] = []
        for i, (r, item) in enumerate(items):
            try:
                if isinstance(item, Exception):
                    raise item
                arr, ctx_val, png = item
                h = min(arr.shape[0], canvas_size)
                w = min(arr.shape[1], canvas_size)
                canvases[i, :h, :w] = arr[:h, :w]
                if w < canvas_size:
                    canvases[i, :h, w:] = 255
                if h < canvas_size:
                    canvases[i, h:] = 255
                dims.append((h, w))
                ctxs.append(ctx_val)
                pngs.append(png)
                keep.append(True)
            except Exception:
                log.exception("render failed for region on page %d", r.page_num)
                canvases[i] = 255
                dims.append((1, 1))
                pngs.append(b"")
                keep.append(False)
                ctxs.append(None)
        return regions, canvases, dims, pngs, keep, ctxs

    def close(self) -> None:
        """Close every worker thread's handles."""
        with self._lock:
            handles, self._handles = list(self._handles.values()), {}
        for engine, render_doc in handles:
            engine.doc.close()
            render_doc.close()
