"""The port's two bf16 models against flax, op by op (scripts/bf16_op_parity.py).

flax's model runs jitted, as the JAX package runs it, with every module's
input and output captured; each op of the port gets the JAX input of that
op, so that its rounding shows on its own. At a small size, on the CPU:

- the DB detector on two 128² lumas of rendered crops: every op's bf16
  output equals flax's but for at most 1e-3 of its elements (measured: at
  most 29 of 131072, 2.2e-4, GroupNorm after the first conv; the merges,
  the upsamples and the float32 head exactly), which float32 sums taken in another
  order explain (before the port rounded where XLA rounds, on the scanned
  canvas: GroupNorm 7-28% of the elements, the merges 6-12%);
- the recognizer on eight synthetic text lines (models/synthdata.py): the
  same bar for every bf16 op (before: LayerNorm 25%), the float32 head to
  1e-5 of its scale, and the same argmax on every frame.
"""
import os
import sys

import numpy as np

from torchfixtures import pin_threads, rendered_canvases

pin_threads()
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import bf16_op_parity as ops  # noqa: E402

SHARE_MAX = 1e-3


def _assert_rows(rows):
    """Every bf16 op within SHARE_MAX; a float32 op (the head) to float32
    rounding of its sums."""
    assert len(rows) > 20
    for r in rows[:-1]:
        if "f32" in r["op"]:
            assert r["max_abs_diff"] <= 1e-5 * r["max_abs"], r
        else:
            assert r["differ"] <= SHARE_MAX * r["n"], r


def test_detector_ops_round_like_flax():
    from synapta_tpu_torch.models.detector import DBLineDetector

    canvases, _ = rendered_canvases(8, 2)
    gray = np.ascontiguousarray(DBLineDetector._luma(canvases[:2])[:, ::4, ::4])
    rows = ops.detector_ops(gray)
    _assert_rows(rows)
    by_op = {r["op"]: r for r in rows}
    for name in ("p3 = lateral + upsample", "p2 = lateral + upsample",
                 "p1 = lateral + upsample"):
        assert by_op[name]["differ"] == 0, by_op[name]
    assert rows[-1]["op"].startswith("whole")


def test_recognizer_ops_round_like_flax():
    from synapta_tpu_torch.models.synthdata import make_batch

    imgs, _, _ = make_batch(np.random.default_rng(0), batch=8)
    tiles = np.round(imgs[..., 0] * 255.0).astype(np.uint8)
    rows = ops.recognizer_ops(tiles)
    _assert_rows(rows)
    assert rows[-1]["argmax_differ"] == 0, rows[-1]
