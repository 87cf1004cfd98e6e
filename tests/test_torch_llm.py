"""The port's vision-LLM paths against the JAX pipeline, on the CPU.

Each case runs the book, seed, page count and client of the JAX test it
mirrors, through the port (``device="cpu"``) and, where the JAX test writes
a book's JSON, through the JAX pipeline too (one data device, as every port
parity test runs it); the two ``*_visual_segments.json`` are compared key by
key and the CSVs cell by cell under ``chip_smoke.ALLOWED_DIFFERENCES``.

- ``tests/test_pipeline.py::test_fake_llm_flow``: the immediate fake client
  with ``use_vision_llm=True``; every segment classified by the LLM, the
  calculation follow-up called and patched into the image payloads.
- ``tests/test_llm_async.py::test_llm_latency_off_critical_path``: with a
  1.5 s-a-call client the pipeline's own thread spends less than a quarter
  of a call inside the client's ``submit_*`` calls, the tail after the
  book waits less than two calls and a second, and every late patch lands.
- ``tests/test_llm_async.py::test_llm_followups_patch_in``: every segment a
  flowchart with its Mermaid follow-up patched in.
- ``tests/test_llm_async.py::test_deferred_pixel_reads_survive_canvas_recycling``:
  the pixels handed to the client never change after the submit, while the
  loader's canvas ring is recycled.
- ``tests/test_pipeline.py::test_resume_skips_done_segments``: the second
  and third runs over the JSONL checkpoint write no segment, also with the
  PNG encoder swapped.
"""
import collections
import json
import os
import threading
import time
import unittest.mock as mock
import zlib

import numpy as np
import pytest

from chip_smoke import payload_differences
from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.llm.fake import FakePixtralClient as JaxFakeClient
from synapta_tpu.ocr.processor import TPUOCR
from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe
from synapta_tpu.schema import VisualType as JaxVisualType
from synapta_tpu_torch.bench import DelayedFakeClient
from synapta_tpu_torch.config import PipelineConfig
from synapta_tpu_torch.llm.fake import DisabledClient, FakePixtralClient
from synapta_tpu_torch.ocr.processor import TorchOCR
from synapta_tpu_torch.pipeline import VisualSegmentationPipeline as TorchPipe
from synapta_tpu_torch.schema import VisualType

from test_llm_async import DelayedFakeClient as JaxDelayedClient
from torchfixtures import pin_threads

pin_threads()

POOL = 16  # the JAX tests' client pool (tests/test_llm_async.py)
DELAY = 1.5  # test_llm_latency_off_critical_path
FOLLOWUP_DELAY = 0.3  # test_llm_followups_patch_in


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_llm")
    pdf = str(d / "book.pdf")
    make_test_book(pdf, pages=8, seed=11)
    return pdf, d


@pytest.fixture(scope="module")
def torch_ocr():
    return TorchOCR(device="cpu")


@pytest.fixture(scope="module")
def jax_ocr():
    return TPUOCR()


def _image_hint(vtype):
    """test_fake_llm_flow's hint: every visual a photo."""
    return lambda pixels, ocr: {
        "visual_type": vtype.IMAGE, "confidence": 0.93,
        "metadata": {"image_subtype": "photo", "contains_text": False},
        "summary": "A photo-like visual.", "summary_confidence": 0.9,
        "method": "mistral_vision_comprehensive"}


def _flowchart_hint(vtype):
    """test_llm_followups_patch_in's hint: every visual a flowchart."""
    return lambda pixels, ocr: {
        "visual_type": vtype.FLOWCHART, "confidence": 0.9, "metadata": {},
        "summary": "A flowchart.", "summary_confidence": 0.9,
        "method": "mistral_vision_comprehensive"}


def _assert_same_payloads(t_out, j_out, book_id):
    outside, _, csv_equal = payload_differences(str(t_out), str(j_out), book_id)
    assert not outside, outside
    assert csv_equal


# ---------------------------------------------------- the immediate client


@pytest.fixture(scope="module")
def fake_flow(book):
    """test_fake_llm_flow's runs: its book, its client, use_vision_llm=True."""
    pdf, d = book
    client = FakePixtralClient(hint_fn=_image_hint(VisualType))
    tp = TorchPipe("f", pdf, output_dir=str(d / "t_fake"),
                   config=PipelineConfig(use_vision_llm=True),
                   llm_client=client, resume=False, device="cpu")
    t_segs = tp.process()
    tp.close()
    jp = JaxPipe("f", pdf, output_dir=str(d / "j_fake"),
                 config=JaxPipelineConfig(use_vision_llm=True, data_devices=1),
                 llm_client=JaxFakeClient(hint_fn=_image_hint(JaxVisualType)),
                 resume=False)
    jp.process()
    jp.close()
    return tp, t_segs, client, jp, d


def test_fake_llm_flow_classifies_and_patches(fake_flow):
    tp, segs, client, jp, _ = fake_flow
    assert tp.stats.errors == 0 and jp.stats.errors == 0
    assert len(segs) == 8
    assert all(s.classification_method == "mistral_vision_comprehensive"
               for s in segs)
    assert all(s.segment_type == VisualType.IMAGE for s in segs)
    # IMAGE segments got the calculation second call
    assert any(c[0] == "calculations" for c in client.calls)
    img_segs = [s for s in segs if s.image_data]
    assert img_segs and img_segs[0].image_data.input_variables
    assert tp.stats.llm_analyses == len(segs)


def test_fake_llm_flow_json_equals_the_jax_pipelines(fake_flow):
    d = fake_flow[-1]
    _assert_same_payloads(d / "t_fake", d / "j_fake", "f")


# ----------------------------------------------------- the delayed client


class TimedSubmitClient(DelayedFakeClient):
    """DelayedFakeClient that adds up, by thread, the seconds spent inside
    its ``submit_*`` calls: what the LLM costs the thread that submits."""

    def __init__(self, delay, workers):
        super().__init__(delay, workers=workers)
        self.submit_s = collections.defaultdict(float)  # thread ident -> s
        self.submits = collections.defaultdict(int)  # thread ident -> calls
        self._lock = threading.Lock()

    def _timed(self, submit, *args):
        t0 = time.perf_counter()
        try:
            return submit(*args)
        finally:
            with self._lock:
                self.submit_s[threading.get_ident()] += time.perf_counter() - t0
                self.submits[threading.get_ident()] += 1

    def submit_comprehensive(self, pixels, ocr):
        return self._timed(super().submit_comprehensive, pixels, ocr)

    def submit_mermaid(self, pixels, visual_type, ocr):
        return self._timed(super().submit_mermaid, pixels, visual_type, ocr)

    def submit_calculations(self, pixels, ocr, nearby):
        return self._timed(super().submit_calculations, pixels, ocr, nearby)


@pytest.fixture(scope="module")
def latency_runs(book, torch_ocr, jax_ocr):
    """test_llm_latency_off_critical_path's 1.5 s-a-call runs: the port's,
    with the seconds its own thread spent submitting, and the JAX
    pipeline's."""
    pdf, d = book

    def run(pipe_cls, cfg, client, ocr, out, **kw):
        pipe = pipe_cls("latbook", pdf, output_dir=str(d / out), use_mermaid=True,
                        config=cfg, llm_client=client, ocr=ocr, resume=False, **kw)
        pipe.process()
        pipe.close()
        return pipe

    client = TimedSubmitClient(DELAY, workers=POOL)
    tp = run(TorchPipe, PipelineConfig(use_vision_llm=False), client, torch_ocr,
             "t_lat1", device="cpu")
    client.shutdown()
    me = threading.get_ident()  # process() ran on this thread
    submitted = (client.submits[me], client.submit_s[me])
    jp = run(JaxPipe, JaxPipelineConfig(use_vision_llm=False, data_devices=1),
             JaxDelayedClient(delay=DELAY), jax_ocr, "j_lat1")
    return submitted, tp, jp, d


def test_llm_latency_off_critical_path(latency_runs):
    """The pipeline's thread hands each call to the client and goes on: it
    spends a small share of one call submitting, whatever the host's load
    does to the walls, and waits at the end for the last calls only."""
    (calls, submit_s), tp, _, d = latency_runs
    payload = json.load(open(d / "t_lat1" / "latbook_visual_segments.json"))
    n = payload["total_segments"]
    assert n >= 7
    assert calls >= n, calls  # every analysis was submitted from that thread
    assert submit_s < 0.25 * DELAY, (
        f"LLM latency leaked onto the critical path: {submit_s:.2f}s inside "
        f"submit_* on the pipeline's thread, n={n}")
    assert tp.stats.llm_drain_wait_s < 2 * DELAY + 1.0, tp.stats.llm_drain_wait_s
    for s in payload["segments"]:
        assert s["classification_method"] == "mistral_vision_comprehensive", s[
            "segment_id"]
    # the builds outrun a 1.5 s call: every analysis landed as a late patch
    assert tp.stats.llm_unpatched == 0 and tp.stats.errors == 0
    assert tp.stats.llm_patches == n


def test_delayed_llm_json_equals_the_jax_pipelines(latency_runs):
    _, tp, jp, d = latency_runs
    assert jp.stats.llm_unpatched == 0 and jp.stats.llm_patches == tp.stats.llm_patches
    _assert_same_payloads(d / "t_lat1", d / "j_lat1", "latbook")


@pytest.fixture(scope="module")
def followup_runs(book, torch_ocr, jax_ocr):
    """test_llm_followups_patch_in's runs: every segment called a flowchart,
    so every one takes the Mermaid follow-up."""
    pdf, d = book
    tp = TorchPipe("fupbook", pdf, output_dir=str(d / "t_fup"), use_mermaid=True,
                   config=PipelineConfig(use_vision_llm=False),
                   llm_client=DelayedFakeClient(
                       FOLLOWUP_DELAY, workers=POOL,
                       hint_fn=_flowchart_hint(VisualType)),
                   ocr=torch_ocr, resume=False, device="cpu")
    tp.process()
    tp.close()
    jp = JaxPipe("fupbook", pdf, output_dir=str(d / "j_fup"), use_mermaid=True,
                 config=JaxPipelineConfig(use_vision_llm=False, data_devices=1),
                 llm_client=JaxDelayedClient(delay=FOLLOWUP_DELAY,
                                             hint_fn=_flowchart_hint(JaxVisualType)),
                 ocr=jax_ocr, resume=False)
    jp.process()
    jp.close()
    return tp, jp, d


def test_llm_followups_patch_in(followup_runs):
    tp, _, d = followup_runs
    payload = json.load(open(d / "t_fup" / "fupbook_visual_segments.json"))
    assert payload["total_segments"] >= 7
    for s in payload["segments"]:
        assert s["segment_type"] == "flowchart"
        assert s["mermaid_repr"] is not None
        assert "flowchart" in s["mermaid_repr"]["mermaid_code"]
    assert tp.stats.llm_unpatched == 0 and tp.stats.errors == 0


def test_followup_json_equals_the_jax_pipelines(followup_runs):
    _, _, d = followup_runs
    _assert_same_payloads(d / "t_fup", d / "j_fup", "fupbook")


# ------------------------------------------------------ the canvas ring


class RecordingClient(FakePixtralClient):
    """(crc at submit, the submitted array) for every comprehensive call."""

    def __init__(self):
        super().__init__()
        self.records = []

    def submit_comprehensive(self, pixels, ocr):
        self.records.append((zlib.crc32(np.ascontiguousarray(pixels)), pixels))
        return super().submit_comprehensive(pixels, ocr)


def test_deferred_pixel_reads_survive_canvas_recycling(tmp_path, torch_ocr):
    """12 pages in batches of 2 wrap the loader's ring many times; each
    array the client was handed still has the crc it had at submit."""
    pdf = str(tmp_path / "book.pdf")
    make_test_book(pdf, pages=12, seed=13)
    client = RecordingClient()
    pipe = TorchPipe("ringbook", pdf, output_dir=str(tmp_path / "out"),
                     use_mermaid=False,
                     config=PipelineConfig(use_vision_llm=False, pages_per_batch=2),
                     llm_client=client, ocr=torch_ocr, resume=False, device="cpu")
    pipe.process()
    pipe.close()
    assert pipe.stats.errors == 0
    assert len(client.records) >= 10  # enough batches to wrap the ring
    for i, (crc0, arr) in enumerate(client.records):
        assert zlib.crc32(np.ascontiguousarray(arr)) == crc0, (
            f"submission {i}: pixels mutated after submit")


# ------------------------------------------------------------- resume


def test_resume_skips_done_segments(book):
    pdf, d = book
    out = str(d / "t_resume")

    def mk():
        return TorchPipe("r", pdf, taxonomy_path=None, output_dir=out,
                         config=PipelineConfig(use_vision_llm=False),
                         llm_client=DisabledClient(), resume=True, device="cpu")

    p1 = mk()
    p1.process()
    first = p1.stats.segments
    assert first > 0
    p2 = mk()
    p2.process()
    assert p2.stats.segments == 0  # everything deduped via the checkpoint
    payload = json.load(open(os.path.join(out, "r_visual_segments.json")))
    assert payload["total_segments"] == first
    # ids hash raw pixels, not encoded PNGs: another PNG encoder changes the
    # bytes, not the id
    with mock.patch("synapta_tpu_torch.io.ingest.png_encode",
                    side_effect=RuntimeError("encoder swapped")):
        p3 = mk()
        p3.process()
    assert p3.stats.segments == 0
    payload = json.load(open(os.path.join(out, "r_visual_segments.json")))
    assert payload["total_segments"] == first
    for p in (p1, p2, p3):
        p.close()
