"""The comparison catches a broken timed path: each run drives the rest of
a real run (CPU, the kernels' plain twins, tiny books) with one fault
planted where the program produces an answer, and ``correct`` comes out
false on the number that sees it. A step that leaves its state unchanged
and the exchange between chips are not faults these cells can have: they
train nothing and run on one chip."""
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import bench_with_born_digital

TINY = {
    "digital-volumes": {"generator": "test_book", "pages": [3], "books": 1,
                        "warmup_pages": 1},
    "scanned-chapters": {"generator": "scanned_book", "pages": [1], "books": 1,
                         "warmup_pages": 1},
}


def token(monkeypatch):
    """One served class of the first tile altered where the recognizer
    produces it."""
    from synapta_tpu_torch.ocr.processor import TorchOCR

    orig = TorchOCR._decode

    def decode(self, x):
        out = orig(self, x).clone()
        out[0, 0, 0] = (out[0, 0, 0] + 1) % 161
        return out

    monkeypatch.setattr(TorchOCR, "_decode", decode)


def half_batch(monkeypatch):
    """The analyze pass computes every other crop of a chunk and gives the
    rest the mean of those."""
    import synapta_tpu_torch.ops.features as feat

    orig = feat.analyze

    def analyze(gray, rgb_q, sizes, use_pallas=False):
        out = orig(gray[::2], rgb_q[::2], sizes[::2], use_pallas=use_pallas)
        full = out.mean(dim=0, keepdim=True).repeat(gray.shape[0], 1)
        full[::2] = out
        return full

    monkeypatch.setattr(feat, "analyze", analyze)


def db_logit(monkeypatch):
    """The first view's surest DB logit put across the threshold where the
    model produces it."""
    import math

    import synapta_tpu_torch.models.detector as det

    orig = det.db_logits
    t = math.log(0.3 / 0.7)

    def db_logits(model, gray_u8):
        out = orig(model, gray_u8).clone()
        i = int((out[0] - t).abs().argmax())
        v = out[0].view(-1)
        v[i] = 2 * t - v[i]  # mirrored across the threshold
        return out

    monkeypatch.setattr(det, "db_logits", db_logits)


def db_box(monkeypatch):
    """One DB box of the first view moved a pixel where the post stage
    produces it."""
    import synapta_tpu_torch.models.detector as det

    orig = det.mask_boxes

    def mask_boxes(mask):
        out = orig(mask).clone()
        out[0, 0, 0] += 1.0
        return out

    monkeypatch.setattr(det, "mask_boxes", mask_boxes)


@pytest.mark.parametrize("cell,fault,number", [
    ("digital-volumes", token, "rec_gap"),
    ("digital-volumes", half_batch, "analyze_diff"),
    ("scanned-chapters", db_logit, "db_gap"),
    ("scanned-chapters", db_box, "db_boxes_diff"),
])
def test_fault_is_caught(monkeypatch, cell, fault, number):
    torch.set_num_threads(4)
    fault(monkeypatch)
    bench = bench_with_born_digital()
    out = harness.run_cell(bench, cell, 2 ** 34 + 1, 0.1, False, device="cpu",
                           workers=2, mix=TINY[cell])
    assert out["correct"] is False
    row = out["checks"][number]
    assert row["value"] > row["limit"], out["checks"]
