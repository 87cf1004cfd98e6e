"""The threaded host prepare, ``io/prepare_pool.py`` (CPU).

- ``BookPreparer.prepare`` equals the serial ``loader.prepare_batch``
  byte for byte (regions with their boxes and digests, canvases, dims, PNG
  bytes, keep flags, hires renders and their ratios) on a scanned book and
  a born-digital one at 1, 2 and 4 threads, on a book whose fonts are not
  embedded, with the one-render route, with the PIL encoder, and where a
  page's detection or a region's render raises.
- The pipeline's document holds every page's parsed metadata after a
  threaded prepare, so the enrich stage parses no page again.
- In a pipeline run, a super-batch takes one lease of the canvas ring, and
  no batch's canvases change between its prepare and its enrich, on a ring
  no larger than the pipeline's own depths ask for.
- Under a CPU profiler, ``prepare_body`` stays on the main thread with its
  ``pages``, ``regions`` and ``workers``; ``detect`` and ``render`` run on
  the worker threads with the book, the batch and ``prepare_body`` as
  parent; every worker's handles are closed when ``process()`` returns.
"""
import dataclasses
import re
import zlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from synapta_tpu_torch.config import OCRConfig, PipelineConfig
from synapta_tpu_torch.io import loader
from synapta_tpu_torch.io import prepare_pool as pp
from synapta_tpu_torch.io.ingest import Document, open_pdf
from synapta_tpu_torch.io.pdf_writer import make_scanned_book, make_test_book
from synapta_tpu_torch.utils.profiler import TIMERS, SpanPool
from synapta_tpu_torch.vision.detect import DetectionEngine

from torchfixtures import pin_threads

pin_threads()


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    d = tmp_path_factory.mktemp("prepare_pool")
    make_scanned_book(str(d / "scan.pdf"), pages=5, seed=4)
    make_test_book(str(d / "test.pdf"), pages=8, seed=5)
    # the born-digital book with no font embedded: Helvetica and Times in
    # the place of the DejaVu faces (same byte lengths, so the offsets hold)
    pdf = (d / "test.pdf").read_bytes()
    pdf = re.sub(rb"/FontFile2 \d+ 0 R", lambda m: b" " * len(m.group()), pdf)
    pdf = pdf.replace(b"/BaseFont /DejaVuSans-Bold", b"/BaseFont /Times-Bold     ")
    pdf = re.sub(rb"/BaseFont /DejaVuSans(?=[^-A-Za-z])", b"/BaseFont /Helvetica ", pdf)
    assert b"/FontFile" not in pdf and b"/BaseFont /DejaVu" not in pdf
    (d / "plain.pdf").write_bytes(pdf)
    return {k: str(d / f"{k}.pdf") for k in ("scan", "test", "plain")}


def _pair(path, cfg):
    render_doc = open_pdf(path)
    return DetectionEngine(open_pdf(path), cfg.detection, pixels_doc=render_doc), render_doc


def _resolved(prepared):
    """A prepared batch with its canvases copied out of the ring and its
    PNGs encoded."""
    regions, canvases, dims, pngs, keep, ctxs = prepared
    return regions, np.array(canvases), dims, loader.resolve_pngs(pngs), keep, ctxs


def _assert_same(got, want):
    regions, canvases, dims, pngs, keep, ctxs = got
    w_regions, w_canvases, w_dims, w_pngs, w_keep, w_ctxs = want
    assert regions == w_regions  # bbox, content_digest and every other field
    assert canvases.dtype == w_canvases.dtype and np.array_equal(canvases, w_canvases)
    assert dims == w_dims
    assert pngs == w_pngs
    assert keep == w_keep
    assert len(ctxs) == len(w_ctxs)
    for c, w in zip(ctxs, w_ctxs):
        if w is None:
            assert c is None
        else:
            assert np.array_equal(c[0], w[0]) and c[1] == w[1]


def _fail_detect(monkeypatch):
    orig = DetectionEngine.detect_page

    def detect_page(self, p):
        if p == 2:
            raise RuntimeError("planted detection fault")
        return orig(self, p)

    monkeypatch.setattr(DetectionEngine, "detect_page", detect_page)


def _fail_render(monkeypatch):
    orig = Document.render

    def render(self, index, *args, **kwargs):
        if index == 3:
            raise RuntimeError("planted render fault")
        return orig(self, index, *args, **kwargs)

    monkeypatch.setattr(Document, "render", render)


def _fail_png(monkeypatch):
    from synapta_tpu_torch.io import ingest

    def png_encode(img):
        raise RuntimeError("planted encoder fault")

    monkeypatch.setattr(ingest, "png_encode", png_encode)


@pytest.mark.parametrize("kind,threads,fault", [
    ("scan", 1, None), ("scan", 2, None), ("scan", 4, None),
    ("test", 1, None), ("test", 2, None), ("test", 4, None),
    ("test", 4, "detect"), ("test", 4, "render"),
    ("plain", 4, None), ("scan", 4, "single_render"), ("test", 4, "single_render"),
    ("test", 4, "png"),
])
def test_threaded_prepare_equals_the_serial_loader(monkeypatch, books, kind, threads, fault):
    """``fault``: a planted detection, render or encoder fault, or the
    detection config's one-render route."""
    cfg = PipelineConfig()
    if fault == "single_render":
        cfg = dataclasses.replace(
            cfg, detection=dataclasses.replace(cfg.detection, single_render=True))
    path = books[kind]
    pages = range(open_pdf(path).page_count)
    if fault == "detect":
        _fail_detect(monkeypatch)
    elif fault == "render":
        _fail_render(monkeypatch)
    elif fault == "png":
        _fail_png(monkeypatch)
    want = _resolved(loader.prepare_batch(*_pair(path, cfg), cfg.detection.render_dpi,
                                          cfg.ocr.crop_size, pages))
    monkeypatch.setattr(pp, "prepare_threads", lambda n: min(n, threads))
    png_pool = SpanPool(max_workers=3)
    preparer = pp.BookPreparer(path, "", cfg.detection, cfg.ocr.crop_size,
                               *_pair(path, cfg), png_pool=png_pool)
    try:
        prepared, workers = preparer.prepare(pages)
        got = _resolved(prepared)
    finally:
        preparer.close()
        png_pool.shutdown()
    assert 1 <= workers <= threads
    _assert_same(got, want)
    regions, canvases, dims, pngs, keep = got[:5]
    if kind == "scan":
        assert any(r.extraction_method == "embedded_image" for r in regions)
        assert any(c is not None for c in got[5])  # hires renders reach OCR
    if kind == "plain":
        spans = open_pdf(path).page_spans(0)
        assert spans and {s["font"] for s in spans} <= {"Helvetica", "Times-Bold"}
        assert len({ch for p in pages for s in open_pdf(path).page_spans(p)
                    for ch in s["text"]}) > 40
    if fault == "png":
        assert all(p.startswith(b"\x89PNG") for p, k in zip(pngs, keep) if k)
    if fault == "detect":
        assert 2 not in {r.page_num for r in regions}
        assert {1, 3} <= {r.page_num for r in regions}
    if fault == "render":
        lost = [i for i, r in enumerate(regions) if r.page_num == 3]
        assert lost and all(not keep[i] and dims[i] == (1, 1) and pngs[i] == b""
                            and (canvases[i] == 255).all() for i in lost)
        assert sum(keep) == len(regions) - len(lost) > 0


def _pipeline(tmp_path, pdf, **cfg):
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    config = PipelineConfig(use_vision_llm=False,
                            ocr=OCRConfig(crop_batch=2, line_batch=16), **cfg)
    return VisualSegmentationPipeline("ring", pdf, output_dir=str(tmp_path / "out"),
                                      config=config, llm_client=DisabledClient(),
                                      resume=False, device="cpu")


def test_one_ring_lease_a_batch_and_no_live_batch_overwritten(monkeypatch, tmp_path):
    """A 24-page book in 12 two-page batches through analyze depth 1 and
    recognize depth 1 (four batches alive at once) on a ring of exactly the
    five slots the pipeline asks for: each prepared batch leases once, and
    its canvases read the same checksum from prepare to enrich."""
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=24, seed=7)
    monkeypatch.setattr(loader, "_CANVAS_RING", [None])
    monkeypatch.setattr(loader, "_CANVAS_RING_I", 0)
    monkeypatch.setattr(pp, "prepare_threads", lambda n: min(n, 2))
    leases = []
    lease = loader._lease_canvases

    def counted(n, size):
        leases.append(n)
        return lease(n, size)

    monkeypatch.setattr(loader, "_lease_canvases", counted)
    sums, checked = {}, []
    prepare, enrich = (VisualSegmentationPipeline.__dict__[k]
                       for k in ("_prepare_pages", "_enrich_finish"))

    def prepare_pages(self, preparer, pages):
        prepared = prepare(self, preparer, pages)
        if prepared is not None:
            sums[id(prepared)] = zlib.crc32(np.ascontiguousarray(prepared[1]))
        return prepared

    def enrich_finish(self, state):
        prepared = state[0]
        checked.append(sums.pop(id(prepared)) == zlib.crc32(np.ascontiguousarray(prepared[1])))
        return enrich(self, state)

    monkeypatch.setattr(VisualSegmentationPipeline, "_prepare_pages", prepare_pages)
    monkeypatch.setattr(VisualSegmentationPipeline, "_enrich_finish", enrich_finish)
    pipe = _pipeline(tmp_path, pdf, pages_per_batch=2, analyze_depth=1, recognize_depth=1)
    try:
        pipe.process()
    finally:
        pipe.close()
    assert len(loader._CANVAS_RING) == 1 + 1 + 2 + 1
    assert len(checked) == len(leases) >= 10 and all(checked)
    assert not sums
    assert pipe.prepare_workers == 2 and pipe.stats.errors == 0


def test_worker_spans_and_handles(monkeypatch, tmp_path):
    """One 6-page super-batch on 3 threads under a CPU profiler."""
    import threading

    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=6, seed=8)
    monkeypatch.setattr(pp, "prepare_threads", lambda n: min(n, 3))
    opened = []

    def open_recorded(path, password=""):
        doc = open_pdf(path, password)
        opened.append(doc)
        return doc

    monkeypatch.setattr(pp, "open_pdf", open_recorded)
    pipe = _pipeline(tmp_path, pdf, pages_per_batch=6)
    TIMERS.spans_between(0, 0)  # empty the buffer
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pipe.process()
    finally:
        pipe.close()
    spans = TIMERS.spans_between(0, 1 << 62)
    main = threading.get_native_id()
    prep, = [s for s in spans if s.name == "prepare_body"]
    assert (prep.book, prep.batch, prep.tid) == ("ring", 0, main)
    assert prep.attrs["pages"] == 6 and prep.attrs["regions"] > 0
    assert 1 <= prep.attrs["workers"] <= 3 and prep.attrs["workers"] == pipe.prepare_workers
    for name in ("detect", "render"):
        got = [s for s in spans if s.name == name]
        assert got and all(s.tid != main and s.parent == prep.sid
                           and (s.book, s.batch) == ("ring", 0) for s in got), name
        assert prep.t0 <= min(s.t0 for s in got) and max(s.t1 for s in got) <= prep.t1
    assert len([s for s in spans if s.name == "detect"]) == 6
    workers = {s.tid for s in spans if s.name == "detect"}
    assert len(workers) == prep.attrs["workers"]
    assert len(opened) == 2 * len(workers)
    assert all(d._h is None for d in opened)


def test_every_page_once_under_contention(monkeypatch, books):
    """16 tasks on the pool (more than most hosts have cores) over 64
    pages with the interpreter switching threads every microsecond: each
    page is taken once, each thread opens one pair, and close closes them
    all."""
    import sys
    import threading

    cfg = PipelineConfig()
    taken = []
    monkeypatch.setattr(pp, "prepare_threads", lambda n: min(n, 16))
    monkeypatch.setattr(pp.BookPreparer, "_page",
                        lambda self, engine, render_doc, p: taken.append(p))
    preparer = pp.BookPreparer(books["test"], "", cfg.detection, cfg.ocr.crop_size,
                               *_pair(books["test"], cfg))
    out = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: out.append(preparer.prepare(range(64))))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    (prepared, workers), = out
    assert prepared is None and sorted(taken) == list(range(64))
    handles = list(preparer._handles.values())
    assert 1 <= workers == len(handles) <= 16
    preparer.close()
    assert all(e.doc._h is None and d._h is None for e, d in handles)


def test_thread_count_follows_the_cores(monkeypatch):
    for cores, pages, want in ((8, 32, 8 - pp.SPARE_CORES), (8, 3, 3), (2, 32, 1),
                               (1, 32, 1), (64, 32, 32)):
        monkeypatch.setattr(pp.os, "sched_getaffinity", lambda pid, c=cores: set(range(c)))
        assert pp.prepare_threads(pages) == want


def test_font_substitutes_load_once():
    """The warm-up page lays out every two-byte code in each of the four
    substitutes, with the advances of each one's own glyphs (a font with
    no glyphs would give each code the default width of one em)."""
    pp.load_font_substitutes()
    pp.load_font_substitutes()
    with Document(data=pp._substitutes_pdf()) as doc:
        spans = doc.page_spans(0)
    assert [s["font"] for s in spans] == list(pp.SUBSTITUTE_FONTS)
    assert all(len(s["text"]) == (1 << 16) - 1 for s in spans)
    widths = [s["bbox"][2] - s["bbox"][0] for s in spans]
    assert len({round(w, 3) for w in widths}) == 4
    assert all(w < 0.9 * ((1 << 16) - 1) for w in widths)


def test_enrich_parses_no_page_again(monkeypatch, books, tmp_path):
    """After a threaded prepare the pipeline's document holds each page's
    metadata and text blocks, equal to its own parse; in a pipeline run the
    enrich stage parses no page on the main thread."""
    import threading

    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    cfg = PipelineConfig()
    path = books["test"]
    n = open_pdf(path).page_count
    monkeypatch.setattr(pp, "prepare_threads", lambda k: min(k, 4))
    engine, render_doc = _pair(path, cfg)
    preparer = pp.BookPreparer(path, "", cfg.detection, cfg.ocr.crop_size,
                               engine, render_doc)
    try:
        preparer.prepare(range(n))
    finally:
        preparer.close()
    assert sorted(engine.doc._meta_cache) == list(range(n))
    fresh = open_pdf(path)
    assert all(engine.doc._meta_cache[p] == fresh._metadata(p) for p in range(n))
    assert engine.doc._blocks_cache
    assert all(b == fresh.page_text_blocks(p) for p, b in engine.doc._blocks_cache.items())

    parsed, in_enrich = [], []
    metadata, enrich = Document._metadata, VisualSegmentationPipeline._enrich_finish

    def counted_metadata(self, index):
        if (in_enrich and index not in self._meta_cache
                and threading.current_thread() is threading.main_thread()):
            parsed.append(index)
        return metadata(self, index)

    def marked_enrich(self, state):
        in_enrich.append(True)
        try:
            return enrich(self, state)
        finally:
            in_enrich.pop()

    monkeypatch.setattr(Document, "_metadata", counted_metadata)
    monkeypatch.setattr(VisualSegmentationPipeline, "_enrich_finish", marked_enrich)
    pipe = _pipeline(tmp_path, path, pages_per_batch=4)
    try:
        pipe.process()
    finally:
        pipe.close()
    assert pipe.prepare_workers > 1 and pipe.stats.segments > 0
    assert parsed == []


def test_cli_stats_report_the_prepare_threads(capsys, tmp_path):
    import json

    from synapta_tpu_torch.cli import main

    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=4, seed=9)
    assert main(["--pdf", pdf, "--book-id", "cli", "--output-dir", str(tmp_path / "out"),
                 "--device", "cpu", "--no-llm", "--no-resume", "--stats-json"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 1 <= stats["prepare_workers"] <= pp.prepare_threads(4)
    assert stats["stage_s"]["prepare_body"] > 0
