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



# ---------------------------------------------------------------------------
# The CUDA kernel's opens, modelled in numpy (csrc/edge_stats.cu, es_opens):
# the edge map is bit-packed (bit x % 32 of word x // 32 of a row); a window
# of k rows or bits is built by doubling, A_2p[j] = A_p[j] op A_p[j + p]
# (the last step overlapping to reach k), with funnel shifts across words
# for the horizontal axis and neutral fill past the map; then it is shifted
# by k // 2 and masked to the map's width.

def _pack(e):
    """(H, W) {0,1} -> (H, ceil(W/32)) uint32 words."""
    H, W = e.shape
    nw = -(-W // 32)
    padded = np.zeros((H, nw * 32), np.uint64)
    padded[:, :W] = e
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (padded.reshape(H, nw, 32) * weights).sum(axis=2).astype(np.uint32)


def _unpack(words, W):
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :W]


def _width_mask(nw, W):
    valid = np.clip(W - 32 * np.arange(nw), 0, 32).astype(np.uint64)
    return ((np.uint64(1) << valid) - np.uint64(1)).astype(np.uint32)


def _ahead(a, s, vert, fill):
    """Element j + s along the axis (bits [32w + s, 32w + s + 32) of a row)."""
    H, nw = a.shape
    if vert:
        out = np.full_like(a, fill)
        out[:max(H - s, 0)] = a[s:]
        return out
    q, r = s // 32, s % 32
    ext = np.concatenate([a, np.full((H, q + 2), fill, np.uint32)], axis=1)
    lo = ext[:, q:q + nw].astype(np.uint64)
    hi = ext[:, q + 1:q + 1 + nw].astype(np.uint64)
    return (((hi << np.uint64(32)) | lo) >> np.uint64(r)).astype(np.uint32)


def _window_bits(a, k, vert, erode):
    fill = np.uint32(0xFFFFFFFF if erode else 0)
    op = np.bitwise_and if erode else np.bitwise_or
    p = 1
    while p < k:
        s = p if 2 * p <= k else k - p
        a = op(a, _ahead(a, s, vert, fill))
        p = 2 * p if 2 * p <= k else k
    return a


def _shift_bits(win, h, vert, W):
    H, nw = win.shape
    if vert:
        out = np.zeros_like(win)
        out[h:] = win[:max(H - h, 0)]
    else:
        q, r = h // 32, h % 32
        ext = np.concatenate([np.zeros((H, q + 1), np.uint32), win], axis=1)
        hi = ext[:, 1:1 + nw].astype(np.uint64)
        lo = ext[:, :nw].astype(np.uint64)
        out = (((hi << np.uint64(32)) | lo) << np.uint64(r) >> np.uint64(32)).astype(np.uint32)
    return out & _width_mask(nw, W)


def _open_bits(e, k, vert):
    """The kernel's open of a (H, W) {0,1} map: unpacked (H, W) result."""
    W = e.shape[1]
    words = _pack(e)
    nw = words.shape[1]
    words = words | ~_width_mask(nw, W)  # bits past W: ones for the erode
    eroded = _shift_bits(_window_bits(words, k, vert, True), k // 2, vert, W)
    opened = _shift_bits(_window_bits(eroded, k, vert, False), k // 2, vert, W)
    return _unpack(opened, W)


def _edge_maps():
    rng = np.random.default_rng(9)
    blocks = rng.integers(0, 2, (2, 16, 16)).repeat(8, 1).repeat(32, 2)
    runs = np.zeros((1, 128, 512), np.int64)
    runs[0, 3, 0:45] = 1        # touches the low border: cut by k // 2
    runs[0, 9, 20:90] = 1       # crosses word boundaries
    runs[0, 20, 470:512] = 1    # touches the high border
    runs[0, 30, 31:70] = 1      # exactly 39 long, starting at a word's end
    runs[0, 0:60, 100] = 1      # vertical, from the top border
    runs[0, 70:128, 200] = 1    # vertical, to the bottom border
    runs[0, 40:89, 33] = 1      # vertical, exactly 49 long
    noise = (rng.random((1, 128, 512)) < 0.9).astype(np.int64)
    return np.concatenate([blocks, runs, noise])


@pytest.mark.parametrize("k", [39, 49])
@pytest.mark.parametrize("dim", [1, 2])
def test_bit_packed_opens_equal_twin(k, dim):
    e = _edge_maps()
    want = ck._open1d(torch.from_numpy(e.astype(np.float32)), k, dim) > 0
    for i in range(e.shape[0]):
        got = _open_bits(e[i], k, vert=dim == 1)
        assert np.array_equal(got.astype(bool), want[i].numpy()), i
