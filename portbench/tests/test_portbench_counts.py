"""The yardstick's bytes, operations and FLOPs at known shapes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import models as M


def test_kernel_bounds_at_the_kernel_table_shapes():
    # PERF.md's kernel table: a 16-crop analyze chunk's CC call at
    # (16, 256, 256) moves 8.39 MB, 2.5 us at 3.35 TB/s; edge stats on
    # (16, 512, 512) read 16.78 MB and write 384 B, 5.0 us
    assert counts.cc_least_s(16, 256, 256) == pytest.approx(
        (16 * 256 * 256 * 8 + 64) / 3.35e12)
    assert counts.edge_stats_least_s(16, 512, 512) == pytest.approx(
        (16 * 512 * 512 * 4 + 384) / 3.35e12)
    # operations bound a small map read many times over: 60 a pixel
    assert counts.least_s(0, 67e12) == pytest.approx(1.0)


def test_recognizer_flops_match_the_reference_model():
    cfg = {"convs": [[1, 32, 1, 1], [32, 64, 2, 2], [64, 128, 2, 2],
                     [128, 192, 2, 1], [192, 192, 2, 1]],
           "dim": 192, "blocks": 2, "heads": 4, "mlp_ratio": 2,
           "classes": 161, "tile": [32, 384]}
    ref = M.RecognizerRef(M.read_tree(M.RECOGNIZER_WEIGHTS))
    tiles = torch.zeros((2, 32, 384), dtype=torch.uint8).numpy()
    with FlopCounterMode(display=False) as fc:
        ref(tiles)
    assert counts.recognizer_flops(cfg) * 2 == pytest.approx(fc.get_total_flops(), rel=1e-9)


def test_detector_flops_match_the_reference_model():
    ref = M.DetectorRef(M.read_tree(M.DETECTOR_WEIGHTS))
    views = torch.zeros((1, 128, 128), dtype=torch.uint8).numpy()
    with FlopCounterMode(display=False) as fc:
        ref(views)
    f32, bf16 = counts.detector_flops(128)
    assert f32 + bf16 == pytest.approx(fc.get_total_flops(), rel=1e-9)


def test_page_step_seconds():
    cfg = {"convs": [[1, 1, 1, 1]], "dim": 1, "blocks": 0, "heads": 1,
           "mlp_ratio": 1, "classes": 1, "tile": [1, 4]}
    f = counts.recognizer_flops(cfg)
    assert counts.page_step_s(cfg, 128, 10, 0) == pytest.approx(10 * f / 989e12)
