"""PyTorch port vs the JAX package: fused edge statistics, both routes.

``fused_edge_stats_reference`` (the CUDA kernel's plain twins) must give
exactly the five counts of the Pallas ``fused_edge_stats(interpret=True)``
with ``use_pallas`` (one-sided opens, clamped NMS) and exactly the six
counts of the JAX default route without it (``sobel_edges``, ``_open_iter2``,
``box_count`` and the union: centred opens, wrapped NMS). The kernel itself
cannot run on the CPU; what it does differently from its twins is held here:
its NMS sectors (ratio tests against the twin's ``atan2`` in degrees, over
every gradient uint8 luma can give) and its opens on bit-packed words
(emulated in numpy, with the pad, the shifts and the union).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapta_tpu.ops import features as jfeat
from synapta_tpu.ops import filters as jfilt
from synapta_tpu.ops.pallas_kernels import fused_edge_stats
from synapta_tpu_torch.ops import cuda_kernels as ck
from synapta_tpu_torch.ops import features as tfeat
from synapta_tpu_torch.ops import filters as tfilt

from torchfixtures import crops, gray_and_color


@pytest.fixture(scope="module")
def gray_rendered_blank():
    """2 x 512 x 512: one rendered crop and one blank crop."""
    gray, _ = gray_and_color(crops(2, blank_last=True)[0])
    return gray.astype(np.float32)


def _random_gray():
    """Blocky random images (long straight edges, so the opens fire) plus
    uniform noise, integer-valued, at an odd small shape that exercises
    every border."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 2, (2, 12, 16)).repeat(6, 1).repeat(7, 2)
    noise = rng.integers(0, 256, (2, 72, 112))
    return np.concatenate([blocks * 255.0, noise]).astype(np.float32)


CASES = [(20, 25, 150.0), (4, 6, 150.0), (20, 25, 90.0)]


def _xla_route(gray, line_k=20, grid_k=25, high=150.0):
    """The six counts of the JAX default route, from the JAX package's own
    functions as ``_core_features(use_pallas=False)`` composes them."""
    edges, _, _ = jfilt.sobel_edges(jnp.asarray(gray), low=high / 3.0, high=high)
    e = edges.astype(jnp.float32)
    v = jfeat._open_iter2(e, line_k, 1) > 0
    h = jfeat._open_iter2(e, 1, line_k) > 0
    masks = [edges, v, h, jfeat._open_iter2(e, 1, grid_k) > 0,
             jfeat._open_iter2(e, grid_k, 1) > 0, v | h]
    return np.stack([np.asarray(jfilt.box_count(m)) for m in masks], axis=1)


def test_counts_equal_xla_rendered(gray_rendered_blank):
    want = _xla_route(gray_rendered_blank)
    got = ck.fused_edge_stats(torch.from_numpy(gray_rendered_blank)).numpy()
    assert got.shape == (2, 6) and got.dtype == np.float32
    assert np.array_equal(got, want), (got, want)
    assert got[0, 0] > 0 and got[0, 1:].sum() > 0  # real edges and opens
    assert max(got[0, 1], got[0, 2]) <= got[0, 5] < got[0, 1] + got[0, 2]
    assert not got[1].any()  # blank crop: all zeros


@pytest.mark.parametrize("line_k,grid_k,high", CASES)
def test_counts_equal_xla_random(line_k, grid_k, high):
    g = _random_gray()
    want = _xla_route(g, line_k, grid_k, high)
    got = ck.fused_edge_stats_reference(torch.from_numpy(g), line_k, grid_k,
                                        high).numpy()
    assert np.array_equal(got, want), (got, want)
    assert (got[:, 1:] > 0).any()
    # blocks touch the borders, where the Pallas route loses the first lanes
    # of every open: the two routes do differ on this input
    pallas = ck.fused_edge_stats_reference(torch.from_numpy(g), line_k, grid_k,
                                           high, use_pallas=True).numpy()
    assert not np.array_equal(pallas, got[:, :5])


def test_counts_equal_pallas_rendered(gray_rendered_blank):
    want = np.asarray(fused_edge_stats(jnp.asarray(gray_rendered_blank),
                                       interpret=True))
    got = ck.fused_edge_stats(torch.from_numpy(gray_rendered_blank),
                              use_pallas=True).numpy()
    assert got.shape == (2, 5) and got.dtype == np.float32
    assert np.array_equal(got, want), (got, want)
    assert got[0, 0] > 0 and got[0, 1:].sum() > 0  # real edges and opens
    assert not got[1].any()  # blank crop: all zeros


@pytest.mark.parametrize("line_k,grid_k,high", CASES)
def test_counts_equal_pallas_random(line_k, grid_k, high):
    g = _random_gray()
    want = np.asarray(fused_edge_stats(jnp.asarray(g), line_k, grid_k, high,
                                       interpret=True))
    got = ck.fused_edge_stats_reference(torch.from_numpy(g), line_k, grid_k,
                                        high, use_pallas=True).numpy()
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


def test_centred_open_semantics():
    """The default route on the same runs: E[i] = min over the lanes of
    [i-k//2, i+k//2] that exist, then the same max-window, so a run of at
    least k//2 + 1 that touches a border survives whole."""
    e = torch.zeros((1, 1, 20))
    e[0, 0, 0:8] = 1.0
    e[0, 0, 14:20] = 1.0
    opened = tfeat._open_iter2(e, 1, 3)[0, 0]  # one open with 2*3 - 1 = 5
    assert opened.tolist() == e[0, 0].tolist()
    e[0, 0, 10:12] = 1.0  # an inner run shorter than 5 goes
    assert tfeat._open_iter2(e, 1, 3)[0, 0, 8:14].tolist() == [0] * 6


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wrapper_rejects_other_devices(use_pallas):
    with pytest.raises(ValueError):
        ck.fused_edge_stats(torch.zeros((1, 8, 8), device="meta"),
                            use_pallas=use_pallas)
    with pytest.raises(ValueError):  # the launcher takes CUDA tensors only
        ck.fused_edge_stats_cuda(torch.zeros((1, 8, 8)), use_pallas=use_pallas)


# ---------------------------------------------------------------------------
# The kernel's NMS sectors. Gray is uint8 luma, so the Sobel sums gx, gy are
# integers in [-1020, 1020]. The kernel sorts a gradient into its sector
# with two ratio tests (ck._ratio_sectors, shared with the Pallas twin); the
# default route's twin and the JAX package take atan2 in degrees. Over all
# 2041^2 gradients the four sectors must agree everywhere but at (0, 0),
# whose magnitude is 0 and is no edge under any positive threshold. The
# closest calls are (+-985, +-408) and (+-408, +-985), 1.8e-5 degrees from a
# boundary: (-408, 985) is the pair that decided how the twin writes its
# remainder (ops/filters.py::_degree_sectors).

def _all_gradients():
    v = np.arange(-1020, 1021, dtype=np.float32)
    return np.meshgrid(v, v, indexing="ij")  # gx[i, j] = v[i], gy[i, j] = v[j]


def _four(is_h, is_d1, is_v):
    """The sector index as the NMS' nested where picks it."""
    is_h, is_d1, is_v = (np.asarray(a) for a in (is_h, is_d1, is_v))
    return np.where(is_h, 0, np.where(is_d1, 1, np.where(is_v, 2, 3)))


def test_ratio_sectors_equal_degree_sectors_on_every_integer_gradient():
    gx, gy = _all_gradients()
    tx, ty = torch.from_numpy(gx), torch.from_numpy(gy)
    ratio = _four(*ck._ratio_sectors(tx, ty))
    degree = _four(*tfilt._degree_sectors(torch.atan2(ty, tx)))
    differ = np.argwhere(ratio != degree)
    assert [(gx[i, j], gy[i, j]) for i, j in differ] == [(0.0, 0.0)]
    assert degree[1020, 1020] == 0 and ratio[1020, 1020] == 1  # is_h, is_d1
    assert sorted(np.unique(ratio)) == [0, 1, 2, 3]
    # the JAX package's own sectors (sobel_edges' lines, once)
    adeg = (jnp.rad2deg(jnp.arctan2(jnp.asarray(gy), jnp.asarray(gx))) + 180.0) % 180.0
    jax_deg = _four((adeg < 22.5) | (adeg >= 157.5),
                    (adeg >= 22.5) & (adeg < 67.5),
                    (adeg >= 67.5) & (adeg < 112.5))
    assert np.array_equal(jax_deg, degree)
    for x, y in ((-408, 985), (985, 408), (-408, -985), (985, -408)):
        assert ratio[1020 + x, 1020 + y] == jax_deg[1020 + x, 1020 + y]


def test_zero_gradient_is_no_edge():
    """(0, 0) is the one gradient the sectors differ on: a flat image has
    magnitude 0 everywhere and no edge on either route."""
    flat = torch.full((1, 40, 48), 77.0)
    for use_pallas in (False, True):
        assert not ck.fused_edge_stats(flat, use_pallas=use_pallas).any()



# ---------------------------------------------------------------------------
# The CUDA kernel's opens, modelled in numpy (csrc/edge_stats.cu, es_opens):
# the edge map is bit-packed (bit x % 32 of word x // 32 of a row); a window
# of k rows or bits is built by doubling, A_2p[j] = A_p[j] op A_p[j + p]
# (the last step overlapping to reach k), with funnel shifts across words
# for the horizontal axis and neutral fill past the map; then it is shifted
# by k // 2 and masked to the map's width. The centred route runs the same
# steps on the map with k // 2 neutral lanes laid in front of the axis and
# reads the open of lane i off lane i of the second window; the union is the
# popcount of the OR of the v and h opens' words.

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


def _bits_back(win, h, fill=0, nw_out=None):
    """Every row moved up by h bits into nw_out words (row_bits_back): bits
    before and past the row are ``fill``."""
    H, nw = win.shape
    nw_out = nw if nw_out is None else nw_out
    q, r = h // 32, h % 32
    ext = np.concatenate([np.full((H, q + 1), fill, np.uint32), win,
                          np.full((H, nw_out), fill, np.uint32)], axis=1)
    hi = ext[:, 1:1 + nw_out].astype(np.uint64)
    lo = ext[:, :nw_out].astype(np.uint64)
    return (((hi << np.uint64(32)) | lo) << np.uint64(r) >> np.uint64(32)).astype(np.uint32)


def _shift_bits(win, h, vert, W):
    H, nw = win.shape
    if vert:
        out = np.zeros_like(win)
        out[h:] = win[:max(H - h, 0)]
    else:
        out = _bits_back(win, h)
    return out & _width_mask(nw, W)


def _open_bits(e, k, vert, centred=False):
    """The kernel's open of a (H, W) {0,1} map: unpacked (H, W) result."""
    H, W = e.shape
    words = _pack(e)
    nw = words.shape[1]
    words = words | ~_width_mask(nw, W)  # bits past W: ones for the erode
    if not centred:
        eroded = _shift_bits(_window_bits(words, k, vert, True), k // 2, vert, W)
        opened = _shift_bits(_window_bits(eroded, k, vert, False), k // 2, vert, W)
        return _unpack(opened, W)
    h = k // 2  # neutral lanes in front of the axis: ones for the erode
    if vert:
        padded, Wp = np.concatenate(
            [np.full((h, nw), 0xFFFFFFFF, np.uint32), words]), W
    else:
        Wp = W + h
        padded = _bits_back(words, h, fill=0xFFFFFFFF, nw_out=-(-Wp // 32))
    eroded = _shift_bits(_window_bits(padded, k, vert, True), h, vert, Wp)
    win = _window_bits(eroded, k, vert, False)
    return _unpack(win[:H, :nw] & _width_mask(nw, W), W)


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


def _centred_twin(e, k, dim):
    """_open_iter2's open with the odd window k = 2 * ((k + 1) // 2) - 1."""
    t = torch.from_numpy(e.astype(np.float32))
    half = (k + 1) // 2
    return tfeat._open_iter2(t, half if dim == 1 else 1,
                             half if dim == 2 else 1) > 0


@pytest.mark.parametrize("k", [39, 49, 7, 1])
@pytest.mark.parametrize("dim", [1, 2])
def test_bit_packed_centred_opens_equal_twin(k, dim):
    e = _edge_maps()
    want = _centred_twin(e, k, dim)
    for i in range(e.shape[0]):
        got = _open_bits(e[i], k, vert=dim == 1, centred=True)
        assert np.array_equal(got.astype(bool), want[i].numpy()), i
    assert want.any() and not want.all()


@pytest.mark.parametrize("shape", [(7, 45), (45, 13), (17, 33), (1, 100)])
def test_bit_packed_centred_opens_at_odd_shapes(shape):
    """W no multiple of 32, an axis shorter than the window's half."""
    e = (np.random.default_rng(3).random((2,) + shape) < 0.93).astype(np.int64)
    for k, dim in ((39, 1), (39, 2), (5, 1), (5, 2)):
        want = _centred_twin(e, k, dim)
        for i in range(2):
            got = _open_bits(e[i], k, vert=dim == 1, centred=True)
            assert np.array_equal(got.astype(bool), want[i].numpy()), (k, dim, i)


@pytest.mark.parametrize("centred", [True, False])
def test_bit_packed_union_equals_twin(centred):
    """The sixth count: popcount of the OR of the v and h opens' words."""
    e = _edge_maps()
    t = torch.from_numpy(e.astype(np.float32))
    if centred:
        v, h = _centred_twin(e, 39, 1), _centred_twin(e, 39, 2)
    else:
        v, h = ck._open1d(t, 39, 1) > 0, ck._open1d(t, 39, 2) > 0
    want = tfilt.box_count(v | h).numpy()
    for i in range(e.shape[0]):
        words = (_pack(_open_bits(e[i], 39, True, centred))
                 | _pack(_open_bits(e[i], 39, False, centred)))
        assert _unpack(words, e.shape[2]).sum() == want[i], i
    assert (want > 0).all()
    assert (want < (tfilt.box_count(v) + tfilt.box_count(h)).numpy()).any()
