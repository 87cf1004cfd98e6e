"""The port's scanned-page path and its entry points vs the JAX package, on
the CPU.

- ``make_scanned_book(pages=2, seed=2)`` (the DB detector's route under the
  default ``line_detector="auto"``; the scanned fixture of
  tests/test_torch_detector.py) through the port and through the JAX
  pipeline: identical segment ids, pages, bboxes, types, captions and figure
  numbers; both CERs <= 0.025, the JAX package's bar
  (tests/test_detector.py); and the two runs' ``*_visual_segments.json`` and
  ``*_visual_summary.csv`` equal key by key and cell by cell, apart from the
  entries of ``chip_smoke.ALLOWED_DIFFERENCES`` and from the lines the OCR
  yardstick of chip_smoke.py excuses (tests/torchparity.py): on this book
  one text line, whose box the two DB detectors draw a pixel apart, excused
  by the DB maps' part of it.
- ``eval.evaluate_scanned`` and ``eval.evaluate_book``: the same detection
  counts and the same CERs as JAX (measured here: scanned 0.0037 on both,
  book 0.0 on both), the scanned one within the bar.
- ``serve.BookQueue``: the same manifest statuses and segment counts as
  JAX's over a test book, a scanned book and a broken file (the queue
  survives it); a second run skips the finished books.
- ``python -m synapta_tpu_torch.eval`` and ``.serve`` run with
  ``--device cpu``.
"""
import json
import os

import pytest

from chip_smoke import payload
from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_scanned_book, make_test_book
from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
from synapta_tpu_torch.config import PipelineConfig
from synapta_tpu_torch.eval import cer, norm_text
from synapta_tpu_torch.llm.fake import DisabledClient

import torchparity
from torchfixtures import pin_threads

pin_threads()

CER_BAR = 0.025  # tests/test_detector.py::test_db_routes_scanned_fixture

# The one difference left on this book is the first text line of page 1,
# whose box the port's DB detector ends at y 32 and JAX's at 33 (and the
# text read from that tile: "the  wi" against "the ∑ wi"). The line's lowest
# row of the probability map lies on the threshold. The yardstick holds the
# DB maps to (a) (float32 maps within F32_LOGIT_BOUND, masks equal but at
# the threshold; measured 1.4e-4 and 0 pixels) and (b) (bf16 masks that
# differ in no more pixels than JAX's bf16 mask differs from its float32
# one; measured 9 against 11), and then excuses the lines whose boxes the
# DB detector drew differently.


def _seg_key(s):
    b = s.bbox
    return (s.segment_id, s.page_no, (b.x0, b.y0, b.x1, b.y1),
            str(s.segment_type), s.caption_text, s.figure_number)


@pytest.fixture(scope="module")
def scanned_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scan")
    pdf = str(d / "scan.pdf")
    _, expected = make_scanned_book(pdf, pages=2, seed=2)
    run = torchparity.runs(pdf, str(d), "scan")
    t, j = run["port"], run["jax"]
    return expected, t["pipe"], t["segments"], j["pipe"], j["segments"], run


def test_scanned_segments_identical(scanned_runs):
    _, tp, t_segs, jp, j_segs, _ = scanned_runs
    assert tp.stats.errors == 0 and jp.stats.errors == 0
    assert tp.cfg.ocr.line_detector == "auto"  # the production default
    assert tp.ocr._db_detector is not None, "DB detector never selected"
    assert len(t_segs) == 2
    assert [_seg_key(s) for s in t_segs] == [_seg_key(s) for s in j_segs]


def test_scanned_json_and_csv_equal_the_jax_pipelines(scanned_runs):
    """The whole payloads the two runs wrote, read back from disk, under
    the table and the yardstick."""
    run = scanned_runs[-1]
    t_json, j_json = (payload(run[s]["out"], "scan") for s in ("port", "jax"))
    assert t_json["total_segments"] == j_json["total_segments"] == 2
    assert sum(len(s["ocr_result"]["blocks"]) for s in t_json["segments"]) >= 30
    report = torchparity.assert_same_or_excused(run, "scan")
    # what it excused: lines of the DB detector's crops and nothing else
    for line in (report or {}).get("unpaired", []):
        assert line["db"] and line["segment"] == t_json["segments"][0]["segment_id"]


def test_scanned_cer_both_under_bar(scanned_runs):
    expected, _, t_segs, _, j_segs, _ = scanned_runs
    for page, truth in enumerate(expected):
        ref = norm_text(truth.replace("\n", " "))
        for segs in (t_segs, j_segs):
            hyp = norm_text(segs[page].ocr_result.raw_text.replace("\n", " "))
            assert cer(ref, hyp) <= CER_BAR


def test_evaluate_scanned_matches_jax():
    from synapta_tpu.eval import evaluate_scanned as jax_eval
    from synapta_tpu_torch.eval import evaluate_scanned

    got = evaluate_scanned(pages=1, seed=1, device="cpu")
    want = jax_eval(pages=1, seed=1)
    assert set(got) == set(want)
    assert got["scanned_detected"] == want["scanned_detected"] == 1
    assert got["scanned_ocr_cer"] == want["scanned_ocr_cer"] <= CER_BAR


def test_evaluate_book_matches_jax():
    from synapta_tpu.eval import evaluate_book as jax_eval
    from synapta_tpu_torch.eval import evaluate_book

    got = evaluate_book(pages=2, seed=3, device="cpu")
    want = jax_eval(pages=2, seed=3)
    assert set(got) == set(want)
    for k in ("detection_recall@0.5", "mean_iou", "classification_accuracy",
              "n_truth_visuals", "n_detected"):
        assert got[k] == want[k], k
    assert got["ocr_cer"] == want["ocr_cer"]


def _queue_books(d):
    book = str(d / "book.pdf")
    make_test_book(book, pages=2, seed=3)
    scan = str(d / "scan.pdf")
    make_scanned_book(scan, pages=1, seed=2)
    bad = str(d / "bad.pdf")
    with open(bad, "wb") as f:
        f.write(b"%PDF-1.4\nnot really a pdf")
    return [bad, book, scan]


def _summary(manifest):
    return {k: (r["status"], r["segments"], r["errors"], bool(r["error"]))
            for k, r in manifest["books"].items()}


def test_book_queue_matches_jax(tmp_path):
    from synapta_tpu.serve import BookQueue as JaxQueue
    from synapta_tpu_torch.serve import BookQueue

    books = _queue_books(tmp_path)
    q = BookQueue(output_root=str(tmp_path / "torch"),
                  config=PipelineConfig(use_vision_llm=False, pages_per_batch=4),
                  llm_client=DisabledClient(), device="cpu")
    jq = JaxQueue(output_root=str(tmp_path / "jax"),
                  config=JaxPipelineConfig(use_vision_llm=False,
                                           pages_per_batch=4, data_devices=1),
                  llm_client=JaxDisabledClient())
    for b in books:
        q.add(b)
        jq.add(b)
    got, want = q.run(), jq.run()
    assert _summary(got) == _summary(want)
    assert got["books"]["bad"]["status"] == "failed"
    assert got["books"]["book"]["status"] == got["books"]["scan"]["status"] == "done"
    assert got["books"]["book"]["segments"] > 0 and got["books"]["scan"]["segments"] == 1

    # a second run skips the finished books: no new started events
    events = os.path.join(str(tmp_path / "torch"), "queue_events.jsonl")
    n_events = len(open(events).readlines())
    q2 = BookQueue(output_root=str(tmp_path / "torch"),
                   config=PipelineConfig(use_vision_llm=False, pages_per_batch=4),
                   llm_client=DisabledClient(), device="cpu")
    for b in books[1:]:
        q2.add(b)
    m2 = q2.run()
    assert all(r["status"] == "done" for k, r in m2["books"].items() if k != "bad")
    assert len(open(events).readlines()) == n_events


def test_eval_main_on_cpu(capsys):
    from synapta_tpu_torch.eval import main

    assert main(["--device", "cpu", "--pages", "1", "--scanned",
                 "--scanned-pages", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pages"] == 1 and out["scanned_pages"] == 1
    assert out["scanned_ocr_cer"] <= CER_BAR


def test_serve_main_on_cpu(tmp_path, capsys):
    from synapta_tpu_torch.serve import main

    book = str(tmp_path / "b.pdf")
    make_test_book(book, pages=2, seed=5)
    assert main(["--books", book, "--output-root", str(tmp_path / "out"),
                 "--no-llm", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"books": 1, "done": 1}
