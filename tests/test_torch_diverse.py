"""The diverse book through the port and the JAX pipeline, on the CPU, judged
by the OCR yardstick of chip_smoke.py.

``make_diverse_book(seed=5)`` (two-column pages, a rotated axis label, a
DeviceCMYK JPEG, two scanned-page rasters that go through the DB line
detector, a three-visual page) runs through the port (``device="cpu"``, one
torch thread) and the JAX pipeline (one data device), LLM off, each under a
``chip_smoke.OCRRecorder`` (tests/torchparity.py). Every recorded
recognizer batch and DB chunk is evaluated again by each package's models
in bf16 and in float32, with the same parameters. Then:

- the same 14 segments (ids, pages, boxes, types), 0 errors, the DB
  detector run by both;
- byte-equal tiles in equal batches, and equal DB views;
- (a) float32: the two packages compute the same function (logits within
  ``F32_LOGIT_BOUND``, equal greedy paths; DB maps likewise);
- (b) bf16: the port's text differs from JAX's on no more tiles than JAX's
  bf16 text differs from its own float32 text; its error quantiles at most
  ``ERROR_RATIO_MAX`` of JAX's; the DB maps' flipped pixels likewise;
- (c) every key of the two JSON payloads outside ``ALLOWED_DIFFERENCES``
  that is no OCR key is equal, and an OCR key differs only where it reads
  a line whose bf16 greedy paths differ; a line whose paths agree keeps
  the table's confidence bound unless JAX's own bf16 confidence of that
  line differs from its float32 one by at least as much; the CSVs
  likewise, cell by cell.

No line is named: each excused tile is found by the measurement. The
yardstick's own checks are held here too, on the run's arrays and payloads
with one thing changed.
"""
import csv
import json
import os
import re
import shutil

import numpy as np
import pytest

from chip_smoke import (ERROR_RATIO_MAX, F32_LOGIT_BOUND, OCR_LINE_KEYS,
                        OCR_SEGMENT_KEYS, allowed_difference, db_yardstick,
                        judge_keys, json_differences, ocr_yardstick, payload)
from synapta_tpu.io.pdf_writer import make_diverse_book

import torchparity
from torchfixtures import pin_threads

pin_threads()

BOOK = "diverse"
SEGMENTS = 14  # make_diverse_book(seed=5): what both pipelines find


def _seg_key(s):
    b = s.bbox
    return (s.segment_id, s.page_no, (b.x0, b.y0, b.x1, b.y1), str(s.segment_type))


@pytest.fixture(scope="module")
def diverse(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_diverse")
    pdf = str(d / "diverse.pdf")
    make_diverse_book(pdf, seed=5)
    run = torchparity.evaluated(torchparity.runs(pdf, str(d), BOOK))
    report, keys = torchparity.yardstick(run["jax"], run["port"], BOOK)
    print(json.dumps({"diverse_yardstick": report, "keys": {
        k: v for k, v in keys.items() if k != "faults"},
        "key_faults": keys["faults"][:20]}, ensure_ascii=False, default=str))
    return run, report, keys, d


def test_diverse_segments_identical(diverse):
    run = diverse[0]
    t, j = run["port"], run["jax"]
    assert t["pipe"].stats.errors == 0 and j["pipe"].stats.errors == 0
    assert len(t["segments"]) == len(j["segments"]) == SEGMENTS
    assert [_seg_key(s) for s in t["segments"]] == [_seg_key(s) for s in j["segments"]]
    assert t["db"] and j["db"], "the DB detector never ran"


def test_diverse_tiles_byte_equal_in_equal_batches(diverse):
    run, report = diverse[:2]
    tb, jb = run["port"]["batches"], run["jax"]["batches"]
    assert len(tb) == len(jb) >= 1
    for t, j in zip(tb, jb):
        assert t["keys"] == j["keys"]
        np.testing.assert_array_equal(t["tiles"], j["tiles"])
    assert report["paired"] == report["tiles"][0] == report["tiles"][1] > 300
    assert not report["unpaired"] and not report["tiles_differ"]
    assert len(run["port"]["db"]) == len(run["jax"]["db"])
    for t, j in zip(run["port"]["db"], run["jax"]["db"]):
        np.testing.assert_array_equal(t["views"], j["views"])


def test_float32_the_same_function(diverse):
    """(a): never excused; a failure here is a fault of the port."""
    a, db = diverse[1]["float32"], diverse[1]["db"]
    assert a["ok"], a
    assert a["max_abs_logit_diff"] <= F32_LOGIT_BOUND
    assert a["paths_differ"] == 0, a
    assert db["ok_a"], db
    assert db["f32_max_abs_logit_diff"] <= F32_LOGIT_BOUND


def test_bf16_no_farther_than_the_reference(diverse):
    b, db = diverse[1]["bf16"], diverse[1]["db"]
    assert b["ok"], b
    assert b["text_differs"] <= b["ref_bf16_vs_f32_text_differs"]
    assert all(r <= ERROR_RATIO_MAX for r in b["error_quantiles"]["ratio"])
    assert db["ok_b"], db
    assert db["bf16_flipped_pixels"] <= db["ref_bf16_vs_f32_flipped_pixels"]
    assert diverse[1]["ok"]


def test_non_ocr_keys_exact(diverse):
    """Ids, pages, boxes, types, captions, colours, the edge and CC
    features and classification: equal under the table, excuse or none."""
    run = diverse[0]
    P, Q = (payload(run[s]["out"], BOOK) for s in ("jax", "port"))
    assert P["total_segments"] == Q["total_segments"] == SEGMENTS
    other = []
    for path, a, b in json_differences(P, Q):
        m = re.fullmatch(r"segments\[\d+\]\.(.*)", path)
        if allowed_difference(path, a, b) is None and not (m and (
                re.fullmatch(OCR_LINE_KEYS, m.group(1))
                or re.fullmatch(OCR_SEGMENT_KEYS, m.group(1)))):
            other.append((path, a, b))
    assert not other, other


def test_ocr_keys_differ_only_on_excused_lines(diverse):
    report, keys = diverse[1:3]
    json_faults = [f for f in keys["faults"] if not f[0].startswith("csv")]
    assert not json_faults, json_faults
    # every excused line was found by (b), in a segment of the book
    segments = {s.segment_id for s in diverse[0]["port"]["segments"]}
    assert report["excused_tiles"]
    for tile in report["excused_tiles"]:
        assert tile["segment"] in segments and tile["frames"], tile
    assert {str(s) for s in keys["excused_segments"]} <= {
        str(i) for i in range(SEGMENTS)}


def test_csv_equal_but_for_excused_text_cells(diverse):
    keys = diverse[2]
    csv_faults = [f for f in keys["faults"] if f[0].startswith("csv")]
    assert not csv_faults, csv_faults


# ------------------------------------------- the yardstick's own checks


def _arrays(run):
    """Copies of the two runs' batches (so a test may change them)."""
    return [[{k: (v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in b.items()} for b in run[s]["batches"]]
            for s in ("jax", "port")]


def test_yardstick_flags_a_float32_difference(diverse):
    ref, cand = _arrays(diverse[0])
    cand[0]["f32"][0, 0, 0] += 2 * F32_LOGIT_BOUND
    report = ocr_yardstick(ref, cand, diverse[1]["db"])
    assert not report["float32"]["ok"] and not report["ok"]


def test_yardstick_flags_bf16_farther_than_the_reference(diverse):
    ref, cand = _arrays(diverse[0])
    for b in ref:  # the reference's bf16 equal to its float32: no own noise
        b["bf16"] = b["f32"].copy()
        b["paths"] = b["f32"].argmax(-1)
    report = ocr_yardstick(ref, cand, diverse[1]["db"])
    assert report["bf16"]["ref_bf16_vs_f32_text_differs"] == 0
    assert report["bf16"]["text_differs"] > 0
    assert not report["bf16"]["ok"] and not report["ok"]


@pytest.mark.parametrize("reference", ["measured", "zero_error"])
def test_yardstick_flags_a_larger_bf16_error_alone(diverse, reference):
    """(b)'s quantile ratio fails on its own: the candidate's bf16 logits
    pushed away from its float32 ones off the greedy choice, so that no path
    or text changes; against the reference as measured, and against a
    reference with no bf16 error at all (its bf16 logits its float32 ones)."""
    ref, cand = _arrays(diverse[0])
    if reference == "zero_error":
        for b in ref:
            b["bf16"] = b["f32"].copy()
            b["paths"] = b["f32"].argmax(-1)
        for b in cand:
            b["bf16"] = b["f32"].copy()
    for b in cand:
        top = b["bf16"].argmax(-1)[..., None]
        lowered = b["bf16"] - 1.0
        np.put_along_axis(lowered, top, np.take_along_axis(b["bf16"], top, -1), -1)
        b["bf16"] = lowered
        b["paths"] = top[..., 0]
    report = ocr_yardstick(ref, cand, diverse[1]["db"])
    bf16 = report["bf16"]
    assert bf16["text_differs"] <= bf16["ref_bf16_vs_f32_text_differs"], bf16
    assert max(bf16["error_quantiles"]["ratio"]) > ERROR_RATIO_MAX, bf16
    assert not bf16["ok"] and not report["ok"]


@pytest.mark.parametrize("key,text", [
    ("ocr_result.raw_text", True),
    ("ocr_result.node_texts[2]", True),
    ("chart_data.axes_info.x_axis.label", True),
    ("chart_details.tick_labels.y_axis[0]", True),
    ("diagram_details.nodes[3].text", True),
    ("extracted_text_structured.paragraphs[1]", True),
    ("diagram_data.nodes[3].bbox[0]", False),
    ("diagram_details.nodes[3].id", False),
    ("diagram_data.nodes", False),
    ("diagram_data.node_count", False),
    ("chart_data.value_ranges.min", False),
    ("chart_details.series_count", False),
    ("segment_type", False),
])
def test_ocr_segment_keys_are_text_leaves(key, text):
    """(c) excuses the text leaves that read a segment's OCR lines; a node's
    box and id, the counts, ranges and types stay exact."""
    assert (re.fullmatch(OCR_SEGMENT_KEYS, key) is not None) is text


def test_yardstick_flags_db_maps(diverse):
    run = diverse[0]
    cand = [dict(c, f32=c["f32"].copy()) for c in run["port"]["db"]]
    cand[0]["f32"][0] += 2 * F32_LOGIT_BOUND
    assert not db_yardstick(run["jax"]["db"], cand)["ok_a"]
    ref = [dict(c, bf16=c["f32"]) for c in run["jax"]["db"]]
    assert not db_yardstick(ref, run["port"]["db"])["ok_b"]


@pytest.mark.parametrize("change", ["segment_type", "unexcused_line_text",
                                    "unexcused_line_confidence", "csv_ocr_text"])
def test_judge_keys_flags_a_changed_key(diverse, tmp_path, change):
    """A key that no excused line explains is a fault: a type in a segment
    with excused lines, a line's text or its confidence (past the table's
    bound) in a segment without any, a CSV text cell of a segment without
    any."""
    run, report = diverse[:2]
    out = str(tmp_path / "cand")
    shutil.copytree(run["port"]["out"], out)
    js = os.path.join(out, f"{BOOK}_visual_segments.json")
    data = json.load(open(js))
    excused = {int(s) for s in diverse[2]["excused_segments"]}
    plain = next(i for i, s in enumerate(data["segments"])
                 if i not in excused and s["ocr_result"]["blocks"])
    if change == "segment_type":
        data["segments"][min(excused)]["segment_type"] = "__changed__"
    elif change == "unexcused_line_text":
        data["segments"][plain]["ocr_result"]["blocks"][0]["text"] += "x"
    elif change == "unexcused_line_confidence":
        data["segments"][plain]["ocr_result"]["blocks"][0]["confidence"] += 0.6
    else:
        csv_path = os.path.join(out, f"{BOOK}_visual_summary.csv")
        with open(csv_path, newline="") as f:
            rows = list(csv.reader(f))
        assert rows[plain + 1][0] == data["segments"][plain]["segment_id"]
        rows[plain + 1][rows[0].index("ocr_text")] += "x"
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    json.dump(data, open(js, "w"))
    keys = judge_keys(run["jax"]["out"], out, report, BOOK)
    assert keys["faults"], change


@pytest.mark.parametrize("move,fault", [(0.6, False), (0.8, True)])
def test_judge_keys_holds_a_line_to_its_own_confidence_difference(
        diverse, tmp_path, move, fault):
    """A line of ``confidence_lines`` (its paths agree, JAX's own bf16 and
    float32 confidences of it 0.7 apart) may pass the table's 0.5 by as
    much as that and no more; its segment's mean follows it."""
    run, report = diverse[:2]
    out = str(tmp_path / "cand")
    shutil.copytree(run["port"]["out"], out)
    js = os.path.join(out, f"{BOOK}_visual_segments.json")
    data = json.load(open(js))
    ref = payload(run["jax"]["out"], BOOK)["segments"]
    excused = {int(s) for s in diverse[2]["excused_segments"]}
    s = next(i for i, seg in enumerate(ref)
             if i not in excused and seg["ocr_result"]["blocks"])
    seg = data["segments"][s]["ocr_result"]
    blk = ref[s]["ocr_result"]["blocks"][0]
    seg["blocks"][0]["confidence"] = blk["confidence"] + move
    seg["confidence"] = float(np.mean([b["confidence"] for b in seg["blocks"]])) / 100
    json.dump(data, open(js, "w"))
    listed = dict(report, confidence_lines=[
        (ref[s]["segment_id"], blk["bbox"], 0.7)])
    faults = judge_keys(run["jax"]["out"], out, listed, BOOK)["faults"]
    assert bool(faults) is fault, faults
    assert judge_keys(run["jax"]["out"], out, report, BOOK)["faults"], "unlisted"
