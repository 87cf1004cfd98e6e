"""Books from foreign toolchains and a rotated scan: the port against the
JAX pipeline, on the CPU.

- The four books of tests/corpus.py, run as tests/test_corpus_e2e.py runs
  them (``pages_per_batch=4``, the LLM off): matplotlib's own PDF writer with
  Type3 and with embedded TrueType fonts (6 pages), Pillow's image-per-page
  book (4 whole-page rasters: every crop scanned-like, so through the DB
  line detector and the CC kernel's fifth call site) and the fontTools book
  (PDF 1.5 xref and object streams, a CID TrueType; 4 pages). Each passes
  the JAX test's own checks on the port, and the two runs' segment JSON and
  CSV are equal under ``chip_smoke.ALLOWED_DIFFERENCES`` and the OCR
  yardstick of chip_smoke.py (tests/torchparity.py): on these books it
  excuses one text line of the Type3 book, whose recognizer frame is a
  near-tie.
- The ``/Rotate 90`` scan of tests/test_pipeline.py::
  test_rotated_scanned_page_end_to_end (``chip_smoke.rotated_scan_pdf``):
  one segment, in display space, and the same JSON as the JAX pipeline's.
"""
import csv
import os

import pytest

from chip_smoke import payload_differences, rotated_scan_pdf

import torchparity
from corpus import make_fonttools_book, make_mpl_book, make_pil_book
from test_corpus_e2e import _check_outputs
from torchfixtures import pin_threads

pin_threads()

# book id -> (maker, the JAX test's min_segments)
BOOKS = {
    "mpl3": (lambda p: make_mpl_book(p, fonttype=3, pages=6), 4),
    "mpl42": (lambda p: make_mpl_book(p, fonttype=42, pages=6), 4),
    "pilbook": (lambda p: make_pil_book(p, pages=4), 3),
    "ftbook": (lambda p: make_fonttools_book(p, pages=4), 3),
}
# tests/test_corpus_e2e.py::test_matplotlib_book: all six must be read
MPL_KEYWORDS = ["revenue", "cost", "portfolio weights", "stocks", "bonds", "figure"]

# The one difference left on these books: on the Type3 book, segment 0's
# text line 7 (the y tick "-0.75", box [18, 256, 64, 268] in both runs),
# which the port reads "--0.75" and JAX "-0.75". Its recognizer frame 3
# lies between two "-" frames and is a near-tie between blank and "-" (bf16
# logit gaps 0.0064 in the port, 0.0016 in JAX). The yardstick excuses it:
# in float32 the two recognizers agree on every tile of the book (logits
# within 2.3e-5, equal paths, both "--0.75" here), and JAX's own bf16 text
# differs from its float32 text on 3 tiles of the book, the port's from
# JAX's on this one.


def _runs(pdf, d, book_id, use_mermaid=True, **cfg):
    """The port's and the JAX pipeline's run of one book, LLM off, recorded
    for the yardstick -> (port pipeline, its segments, JAX pipeline, its
    segments, the run)."""
    run = torchparity.runs(pdf, str(d), book_id, use_mermaid=use_mermaid, **cfg)
    t, j = run["port"], run["jax"]
    return t["pipe"], t["segments"], j["pipe"], j["segments"], run


@pytest.fixture(scope="module", params=list(BOOKS))
def foreign(request, tmp_path_factory):
    book_id = request.param
    d = tmp_path_factory.mktemp("torch_" + book_id)
    pdf = str(d / f"{book_id}.pdf")
    BOOKS[book_id][0](pdf)
    return (book_id, d, *_runs(pdf, d, book_id, pages_per_batch=4))


def test_foreign_book_passes_the_jax_tests_checks(foreign):
    book_id, d, tp, t_segs, jp, j_segs, _ = foreign
    _check_outputs(tp, t_segs, str(d / ("t_" + book_id)), book_id,
                   BOOKS[book_id][1])
    if book_id.startswith("mpl"):
        assert len([s for s in t_segs if s.figure_number]) >= 3
        all_text = " ".join((s.ocr_result.raw_text or "").lower() for s in t_segs)
        found = [k for k in MPL_KEYWORDS if k in all_text]
        assert len(found) == 6, (found, all_text[:400])
    if book_id == "ftbook":  # the CID-font captions were read
        assert sum(1 for s in t_segs if s.figure_number) >= 3
    if book_id == "pilbook":  # whole-page rasters: the DB line detector ran
        assert tp.ocr._db_detector is not None


def test_foreign_book_json_and_csv_equal_the_jax_pipelines(foreign):
    book_id, d, tp, t_segs, jp, j_segs, run = foreign
    assert jp.stats.errors == 0 and len(t_segs) == len(j_segs)
    report = torchparity.assert_same_or_excused(run, book_id)
    assert report is None or not report["unpaired"], report
    outs = [str(d / ("t_" + book_id)), str(d / ("j_" + book_id))]
    rows = [list(csv.reader(open(os.path.join(o, f"{book_id}_visual_summary.csv"),
                                 newline=""))) for o in outs]
    assert len(rows[0]) == len(rows[1]) == 1 + len(t_segs)


@pytest.fixture(scope="module")
def rotated(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rotscan")
    pdf = str(d / "rotscan.pdf")
    rotated_scan_pdf(pdf)
    return d, *_runs(pdf, d, "rotscan", use_mermaid=False)[:4]


def test_rotated_scanned_page_in_display_space(rotated):
    _, tp, t_segs, _, _ = rotated
    assert tp.stats.errors == 0
    assert len(t_segs) == 1
    b = t_segs[0].bbox
    assert (b.page_width, b.page_height) == (612.0, 792.0)
    assert (round(b.x0), round(b.y0), round(b.x1), round(b.y1)) == (
        156, 196, 456, 596)


def test_rotated_scan_json_equals_the_jax_pipelines(rotated):
    d, _, _, jp, j_segs = rotated
    assert jp.stats.errors == 0 and len(j_segs) == 1
    outside, _, csv_equal = payload_differences(
        str(d / "t_rotscan"), str(d / "j_rotscan"), "rotscan")
    assert not outside, outside
    assert csv_equal
