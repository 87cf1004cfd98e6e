"""The books of the JAX package's matplotlib scale run and real-corpus run,
through the PyTorch port's scripts and the JAX pipeline, on the CPU; and the
analyze pass's batch invariance at the sweep's 32-crop chunk.

- ``device_analyze`` on 32 rendered crops equals two 16-crop calls exactly:
  every feature column, the counts among them, and every line box.
- scripts/torch_sweep.py's ``main`` on the CPU (2 pages, ``base``): the card
  line, one line a run with the JAX script's keys and stage names, and the
  best-of line.
- scripts/torch_mpl_scale.py: ``make_big_mpl_book(pages=8, fonttype=42,
  seed=7)`` (every ``p % 8`` page kind once) drawn once, the port run by the
  script's ``main`` (its JSON line carries the JAX script's keys) and the JAX
  pipeline on the same file, each recorded: 0 errors, and the two
  ``mplbook_visual_segments.json`` equal key by key and the CSVs cell by
  cell under ``chip_smoke.ALLOWED_DIFFERENCES`` and the OCR yardstick of
  chip_smoke.py (tests/torchparity.py).
- scripts/torch_real_corpus.py: six rendered crops of varied aspect saved
  as PNGs and both scripts' ``CORPUS`` set to their folder. The two
  ``build_book`` make byte-equal PDFs (one DCT/JPEG image XObject a page at
  its 150-DPI size); the port's ``main`` and the JAX script's ``run`` (one
  data device) process that PDF: every page has an ``embedded_image``
  segment, 0 errors, the same JSON and CSV under the table, and the same
  result line but for times and the mean confidence.
- The real corpus (591 textbook crops) as tests/test_real_corpus.py runs it,
  on the port: slow, and skipped where the corpus is absent.
"""
import contextlib
import functools
import hashlib
import io
import json
import os
import tempfile
import unittest.mock as mock

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import helper_module, payload, payload_differences
from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe
from synapta_tpu_torch.ops.features import device_analyze

import torchparity
from torchfixtures import pin_threads, rendered_canvases

pin_threads()

# the JSON line of scripts/mpl_scale_r4.py and of its port
MPL_LINE_KEYS = {"pages", "fonttype", "wall_s", "pages_per_s", "segments",
                 "by_type", "ocr_lines", "errors", "stage_s"}
# the keys of the real-corpus run's line that time the run
TIMED_KEYS = {"wall_s", "pages_per_s"}

# The one difference left on the matplotlib book: the y tick "6 -" of the
# two bar-chart pages (p % 8 = 2 and 6; segments 1 and 5, the same tile,
# box [78, 264, 92, 272] in both runs), which the port reads "s -" and JAX
# "≥ -". Frame 3 of its tile is a near-tie between the two characters (bf16
# logit gaps 0.0043 in the port, 0.0015 in JAX). The yardstick of
# chip_smoke.py excuses it (tests/torchparity.py): in float32 the two
# recognizers agree on every tile of the book (logits within 2.5e-5, equal
# paths, "≥ -" in both), and JAX's own bf16 text differs from its float32
# text on 5 tiles of the book, the port's from JAX's on 3.


def load_script(name):
    """scripts/<name>.py as a module of its own (its top level only)."""
    return helper_module(name, "scripts")


def crops32():
    """32 region canvases of make_test_book(32, seed=2) and their sizes."""
    canvases, sizes = rendered_canvases(32, 2)
    assert canvases.shape[0] >= 32
    return canvases[:32], sizes[:32]


def test_device_analyze_32_crops_equal_two_16_crop_calls():
    canvases, sizes = crops32()
    feats, boxes = device_analyze(canvases, sizes=sizes, device="cpu")
    halves = [device_analyze(canvases[i:i + 16], sizes=sizes[i:i + 16],
                             device="cpu") for i in (0, 16)]
    assert set(feats) == set(halves[0][0])
    for k, v in feats.items():
        np.testing.assert_array_equal(
            v, np.concatenate([h[0][k] for h in halves]), err_msg=k)
    np.testing.assert_array_equal(boxes, np.concatenate([h[1] for h in halves]))
    assert (boxes[..., 4] > 0).sum() > 32  # the crops have text lines


def _jax_run(pdf, out, book_id):
    jp = JaxPipe(book_id, pdf, output_dir=out, use_mermaid=False,
                 config=JaxPipelineConfig(use_vision_llm=False, data_devices=1),
                 llm_client=JaxDisabledClient(), resume=False)
    segs = jp.process()
    jp.close()
    return jp, segs


def _main_line(main, argv):
    """Run a script's main(argv) -> its last stdout line, parsed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _assert_same_payloads(out_a, out_b, book_id):
    """The two runs' JSON and CSV equal under the table."""
    outside, _, csv_equal = payload_differences(out_a, out_b, book_id)
    assert not outside, outside
    assert csv_equal


# ------------------------------------------------------------ the sweep's CLI


def test_sweep_main_on_cpu(tmp_path, monkeypatch):
    pdf = str(tmp_path / "one.pdf")
    make_test_book(pdf, pages=2, seed=3)  # a text page and a bar chart
    monkeypatch.setenv("SYNAPTA_SWEEP_PDF", pdf)
    monkeypatch.setenv("SYNAPTA_SWEEP_PAGES", "2")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sweep = load_script("torch_sweep")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert sweep.main(["1", "base", "--device", "cpu"]) == 0
    lines = out.getvalue().strip().splitlines()
    assert lines[0] == "cpu" and len(lines) == 3
    rec, best = json.loads(lines[1]), json.loads(lines[2])
    assert set(rec) == {"cfg", "rep", "wall_s", "pages_per_s", "key"}
    assert rec["cfg"] == "base" and rec["rep"] == 0
    assert {"prepare_body", "features_dispatch"} <= set(rec["key"]) <= set(
        sweep.KEY_STAGES)
    assert set(best) == {"best"} and set(best["best"]) == {"base"}
    with pytest.raises(SystemExit):
        sweep.main(["1", "cb128", "--device", "cpu"])


# ------------------------------------------------------- the matplotlib book


@pytest.fixture(scope="module")
def mpl_runs(tmp_path_factory):
    """The script's run and the JAX pipeline's, each recorded for the
    yardstick."""
    d = tmp_path_factory.mktemp("torch_mplscale")
    mpl = load_script("torch_mpl_scale")
    pdf = str(d / "mpl8.pdf")
    mpl.make_big_mpl_book(pdf, pages=8, fonttype=42, seed=7)
    runs = {}
    with torchparity.recorder("port") as rec:
        line = _main_line(mpl.main, ["--pages", "8", "--book", pdf, "--out",
                                     str(d / "t"), "--skip-generate", "--device",
                                     "cpu"])
    runs["port"] = {"rec": rec, "out": str(d / "t")}
    with torchparity.recorder("jax") as rec:
        jp, j_segs = _jax_run(pdf, str(d / "j"), "mplbook")
    runs["jax"] = {"rec": rec, "out": str(d / "j")}
    return d, line, jp, j_segs, runs


def test_mpl_book_line_and_segments_equal_the_jax_pipelines(mpl_runs):
    d, line, jp, j_segs, _ = mpl_runs
    assert set(line) == MPL_LINE_KEYS
    assert line["pages"] == 8 and line["fonttype"] == 42
    assert line["errors"] == 0 and jp.stats.errors == 0
    assert line["segments"] == len(j_segs) and line["ocr_lines"] > 0
    j_types = {}
    for s in j_segs:
        j_types[s.segment_type.value] = j_types.get(s.segment_type.value, 0) + 1
    assert line["by_type"] == j_types
    # every page but the text-only first has a figure; the last has two
    pages = [s["page_no"] for s in payload(str(d / "t"), "mplbook")["segments"]]
    assert set(pages) == set(range(2, 9)), pages


def test_mpl_book_json_and_csv_equal_the_jax_pipelines(mpl_runs):
    report = torchparity.assert_same_or_excused(mpl_runs[-1], "mplbook")
    assert report is None or not report["unpaired"], report


# ------------------------------------------------------- the JPEG crop book


@pytest.fixture(scope="module")
def crop_book(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cropbook")
    corpus = d / "crops"
    corpus.mkdir()
    canvases, sizes = crops32()
    for i in range(6):
        h, w = sizes[i]
        Image.fromarray(canvases[i, :h, :w]).save(corpus / f"crop_{i:02d}.png")
    real, t_real = load_script("real_corpus_r5"), load_script("torch_real_corpus")
    real.CORPUS = t_real.CORPUS = str(corpus)
    t_res = _main_line(t_real.main, ["--out", str(d / "t"), "--device", "cpu"])
    pdf = str(d / "t" / "investments_real.pdf")
    j_pdf = str(d / "j.pdf")
    assert real.build_book(j_pdf) == 6
    # the JAX script's run on one data device, as every port parity test
    with mock.patch("synapta_tpu.config.PipelineConfig",
                    functools.partial(JaxPipelineConfig, data_devices=1)):
        j_res = real.run(pdf, str(d / "j"), 6)
    return d, pdf, j_pdf, sizes[:6], t_res, j_res


def test_crop_books_are_byte_equal(crop_book):
    _, pdf, j_pdf, sizes, _, _ = crop_book
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in (pdf, j_pdf)]
    assert digest[0] == digest[1]
    assert len({round(w / h, 2) for h, w in sizes}) >= 4  # varied aspect
    assert open(pdf, "rb").read().count(b"/DCTDecode") == 6


def test_crop_book_every_page_an_embedded_image(crop_book):
    d, _, _, _, t_res, j_res = crop_book
    for res in (t_res, j_res):
        assert res["pages"] == 6 and res["pages_with_embedded_segment"] == 6, res
        assert res["swallowed_errors"] == 0, res
    embedded = {s["page_no"] for s in payload(str(d / "t" / "out"),
                                             "investments_real")["segments"]
                if s["extraction_method"] == "embedded_image"}
    assert embedded == set(range(1, 7))


def test_crop_book_json_and_csv_equal_the_jax_pipelines(crop_book):
    d, _, _, _, t_res, j_res = crop_book
    _assert_same_payloads(str(d / "t" / "out"), str(d / "j"), "investments_real")
    same = set(t_res) - TIMED_KEYS - {"mean_ocr_confidence"}
    assert set(t_res) == set(j_res)
    assert {k: t_res[k] for k in same} == {k: j_res[k] for k in same}
    assert abs(t_res["mean_ocr_confidence"] - j_res["mean_ocr_confidence"]) <= 1e-3


# ------------------------------------------------------------ the real corpus


@pytest.mark.slow
def test_real_corpus_subset_end_to_end(tmp_path):
    """tests/test_real_corpus.py on the port, with its bars."""
    mod = load_script("torch_real_corpus")
    if not os.path.isdir(mod.CORPUS):
        pytest.skip("real corpus not present")
    pdf = str(tmp_path / "real30.pdf")
    n = mod.build_book(pdf, limit=30)
    assert n == 30
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res = mod.run(pdf, str(tmp_path / "out"), n, device=device)

    assert res["pages_with_embedded_segment"] == 30, res
    assert res["segments"] >= 30, res
    assert res["swallowed_errors"] == 0, res
    assert len(res["classification_histogram"]) >= 3, res
    assert res["segments_with_text"] >= 15, res
    assert res["mean_ocr_confidence"] >= 0.6, res
    assert res["ocr_blocks"] >= 150, res
    assert res["finance_terms_found"] >= 2, res
