"""The OCR yardstick's float rule on synthetic logits (CPU, no model).

``chip_smoke.ocr_yardstick`` (recognizer tiles) and ``db_yardstick`` (DB
maps) get two runs' bf16, float32 and float64 logits made from a seed with
numpy. Around one float64 answer the reference's and the candidate's
float32 logits lie ``1.5 * F32_LOGIT_BOUND`` apart:

- ``nearer``: the candidate's float32 is the nearer to the reference's
  float64 (the reference's own float32 is off by the gap): passes;
- ``farther``: the same gap, the candidate's float32 the one off: fails (a);
- ``float64_apart``: equal float32 logits, but the two float64
  evaluations 1e-6 apart: fails (a0), whatever the float32 numbers say.

So the excuse past ``F32_LOGIT_BOUND`` cannot pass a wrong port: it needs
the same function in float64 and a candidate no farther from it than the
reference.
"""
import numpy as np
import pytest

from chip_smoke import F32_LOGIT_BOUND, F64_LOGIT_BOUND, db_yardstick, ocr_yardstick
from synapta_tpu_torch.models.charset import NUM_CLASSES

GAP = 1.5 * F32_LOGIT_BOUND  # the float32 gap between the two runs
NOISE = 1e-5                 # a float32 evaluation's own rounding


def _float_sides(rng, shape, case):
    """(ref64, cand64, ref32, cand32) around one float64 answer."""
    ref64 = rng.normal(0.0, 3.0, shape)
    near = (ref64 + rng.uniform(-NOISE, NOISE, shape)).astype(np.float32)
    off = (ref64 + GAP * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    if case == "nearer":
        return ref64, ref64.copy(), off, near
    if case == "farther":
        return ref64, ref64.copy(), near, off
    return ref64, ref64 + 1e-6, near, near.copy()


def _recognizer_runs(rng, case):
    n, frames = 6, 8
    tiles = rng.integers(0, 256, (n, 32, 4 * frames), dtype=np.uint8)
    ref64, cand64, ref32, cand32 = _float_sides(rng, (n, frames, NUM_CLASSES), case)
    bf16 = (ref64 + rng.normal(0.0, 0.05, ref64.shape)).astype(np.float32)
    keys = [(0, 0, i, (0, 10 * i, 40, 10 * i + 8), 1, 0) for i in range(n)]
    labels = [{"segment": "s0", "box": list(k[3]), "db": False} for k in keys]

    def run(f32, f64):
        return [{"tiles": tiles, "keys": keys, "labels": labels, "bf16": bf16,
                 "f32": f32, "f64": f64, "paths": bf16.argmax(-1)}]

    return run(ref32, ref64), run(cand32, cand64)


def _db_runs(rng, case):
    views = np.full((3, 64, 64), 255, np.uint8)  # the third pads the chunk
    views[:2, 8:24, 4:60] = rng.integers(0, 128, (2, 16, 56), dtype=np.uint8)
    ref64, cand64, ref32, cand32 = _float_sides(rng, (2, 32, 32), case)
    bf16 = (ref64 + rng.normal(0.0, 0.05, ref64.shape)).astype(np.float32)

    def pad(a):
        return np.concatenate([a, np.full((1, 32, 32), -20.0, a.dtype)])

    def run(f32, f64):
        return [{"views": views, "prob_thresh": 0.3, "bf16": pad(bf16),
                 "f32": pad(f32), "f64": f64}]

    return run(ref32, ref64), run(cand32, cand64)


@pytest.mark.parametrize("model", ["recognizer", "db"])
@pytest.mark.parametrize("case", ["nearer", "farther", "float64_apart"])
def test_yardstick_judges_a_float32_gap_by_float64(model, case):
    rng = np.random.default_rng(13)
    assert F32_LOGIT_BOUND == 1e-3 and F64_LOGIT_BOUND == 1e-9
    if model == "recognizer":
        report = ocr_yardstick(*_recognizer_runs(rng, case))
        a0, a, f64 = report["float64"]["ok"], report["float32"]["ok"], report["float64"]
        past = report["float32"]["past_bound"]
        ok = report["ok"]
    else:
        f64 = db_yardstick(*_db_runs(rng, case))
        a0, a, past = f64["ok_a0"], f64["ok_a"], f64["past_f32_bound"]
        ok = a0 and a and f64["ok_b"]
        assert f64["views"] == 2
    if case == "float64_apart":
        assert a and past == 0, f64
        assert not a0 and not ok
        assert 0.9e-6 <= f64["f64_max_abs_diff"] <= 1.1e-6
        return
    assert a0 and f64["f64_max_abs_diff"] == 0.0
    assert past >= 1, f64
    nearer = f64["cand32_to_ref64"] <= f64["ref32_to_ref64"]
    assert nearer is (case == "nearer"), f64
    assert a is nearer and ok is nearer, f64
