"""PyTorch port vs the Pallas kernel: fused edge statistics.

``fused_edge_stats_reference`` (the CUDA kernel's plain twin) must give
exactly the five counts of ``fused_edge_stats(interpret=True)``: the
kernel's one-sided opens and clamped NMS, not ops/filters.py's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapta_tpu.ops.pallas_kernels import fused_edge_stats
from synapta_tpu_torch.ops import cuda_kernels as ck

from torchfixtures import crops, gray_and_color


@pytest.fixture(scope="module")
def gray_rendered_blank():
    """2 x 512 x 512: one rendered crop and one blank crop."""
    gray, _ = gray_and_color(crops(2, blank_last=True)[0])
    return gray.astype(np.float32)


def _random_gray():
    """Blocky random images (long straight edges, so the opens fire) plus
    uniform noise, at an odd small shape that exercises every border."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 2, (2, 12, 16)).repeat(6, 1).repeat(7, 2)
    noise = rng.integers(0, 256, (2, 72, 112))
    return np.concatenate([blocks * 255.0, noise]).astype(np.float32)


def test_counts_equal_pallas_rendered(gray_rendered_blank):
    want = np.asarray(fused_edge_stats(jnp.asarray(gray_rendered_blank),
                                       interpret=True))
    got = ck.fused_edge_stats(torch.from_numpy(gray_rendered_blank)).numpy()
    assert got.shape == (2, 5) and got.dtype == np.float32
    assert np.array_equal(got, want), (got, want)
    assert got[0, 0] > 0 and got[0, 1:].sum() > 0  # real edges and opens
    assert not got[1].any()  # blank crop: all zeros


@pytest.mark.parametrize("line_k,grid_k,high", [(20, 25, 150.0), (4, 6, 150.0),
                                                (20, 25, 90.0)])
def test_counts_equal_pallas_random(line_k, grid_k, high):
    g = _random_gray()
    want = np.asarray(fused_edge_stats(jnp.asarray(g), line_k, grid_k, high,
                                       interpret=True))
    got = ck.fused_edge_stats_reference(torch.from_numpy(g), line_k, grid_k,
                                        high).numpy()
    assert np.array_equal(got, want), (got, want)


def test_one_sided_open_semantics():
    """E[i] = min(e[i-k//2 .. i-k//2+k-1] within range) for i >= k//2, else
    0; then the same max-window: a run touching the low border is cut by
    k//2, one touching the high border survives."""
    e = torch.zeros((1, 1, 20))
    e[0, 0, 0:8] = 1.0     # touches the low border
    e[0, 0, 14:20] = 1.0   # touches the high border
    opened = ck._open1d(e, 5, 2)[0, 0]
    assert opened[:8].tolist() == [0, 0, 1, 1, 1, 1, 1, 1]
    assert opened[14:].tolist() == [1, 1, 1, 1, 1, 1]


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        ck.fused_edge_stats(torch.zeros((1, 8, 8), device="meta"))

