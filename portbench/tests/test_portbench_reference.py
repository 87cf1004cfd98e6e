"""The plain reference computes the program's functions: on the CPU, where
the program runs its kernels' plain twins, the analyze pass is equal, and
both models in float32 agree with the port's float32 models to rounding."""
import random

import numpy as np
import pytest
import torch

from portbench.reference import models as M
from portbench.reference.features import reference_analyze
from portbench.reference.text import cer, iou, levenshtein


def test_analyze_equals_the_program_on_the_cpu():
    from synapta_tpu_torch.ops.features import device_analyze_dispatch

    rng = np.random.default_rng(0)
    x = np.full((16, 512, 512, 3), 255, np.uint8)
    x[:4, 100:300:3, 50:400] = 0                                   # text-like rows
    x[4:8, 200:260, 100:400] = rng.integers(0, 255, (4, 60, 300, 3))  # a photo
    x[8:12, 50:450, 50:60] = 0                                     # an axis
    x[8:12, 440:450, 50:450] = 0
    sizes = np.full((16, 2), 512, np.int32)
    sizes[12:] = 1                                                 # padding rows
    want = device_analyze_dispatch(x, sizes=sizes, device="cpu")
    assert torch.equal(reference_analyze(x, sizes, "cpu"), want)


def test_models_agree_with_the_ports_float32_models():
    from synapta_tpu_torch.models import detector as D
    from synapta_tpu_torch.models.msgpack_io import load_params
    from synapta_tpu_torch.models.recognizer import recognizer_from_flax

    rng = np.random.default_rng(1)
    tiles = rng.integers(0, 256, (3, 32, 384)).astype(np.uint8)
    rec = recognizer_from_flax(load_params(), dtype=torch.float32, device="cpu")
    want = rec(torch.from_numpy(tiles).float()[:, None] / 255.0)
    got = M.RecognizerRef(M.read_tree(M.RECOGNIZER_WEIGHTS))(tiles)
    assert (got - want).abs().max() < 1e-4
    views = rng.integers(0, 256, (1, 256, 256)).astype(np.uint8)
    det = D.detector_from_flax(D.load_det_params(), dtype=torch.float32, device="cpu")
    got = M.DetectorRef(M.read_tree(M.DETECTOR_WEIGHTS))(views)
    assert (got - D.db_logits(det, views)).abs().max() < 1e-4


@pytest.mark.parametrize("model", ["recognizer", "detector"])
def test_control_precision_moves_the_logits(model):
    rng = np.random.default_rng(2)
    if model == "recognizer":
        x = rng.integers(0, 256, (2, 32, 384)).astype(np.uint8)
        tree, net = M.read_tree(M.RECOGNIZER_WEIGHTS), M.RecognizerRef
    else:
        x = rng.integers(0, 256, (1, 256, 256)).astype(np.uint8)
        tree, net = M.read_tree(M.DETECTOR_WEIGHTS), M.DetectorRef
    d = (net(tree, fp8=True)(x) - net(tree)(x)).abs()
    assert 1e-2 < float(d.max()) < 1e3


def _dp(a, b):
    d = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev, d[0] = d[0], i
        for j in range(1, len(b) + 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
    return d[-1]


def test_levenshtein_is_the_textbook_distance():
    r = random.Random(0)
    for _ in range(2000):
        a = "".join(r.choice("ab c") for _ in range(r.randint(0, 40)))
        b = "".join(r.choice("abcd") for _ in range(r.randint(0, 40)))
        assert levenshtein(a, b) == _dp(a, b)
    assert cer("abcd", "abxd") == 0.25 and cer("", "") == 0.0
    assert iou([0, 0, 2, 2], [1, 0, 3, 2]) == pytest.approx(1 / 3)
