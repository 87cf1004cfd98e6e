"""PyTorch port vs JAX: connected components, component stats, censuses.

The CPU wrapper (which runs the plain twin) must give exactly the labels of
JAX ``connected_components`` AND of the Pallas kernel in interpret mode, at
the caps the main path uses and at a cap that converges, for 8- and
4-connectivity. The CUDA kernel is held to the twin in
tests/test_torch_cuda.py (GPU only) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapta_tpu.ops import cc as jcc
from synapta_tpu.ops.filters import binarize_ink, downsample2
from synapta_tpu.ops.pallas_cc import connected_components_pallas
from synapta_tpu_torch.ops import cc as tcc

from torchfixtures import crops, gray_and_color


def _blobs():
    """Random rectangles + specks (the mask of tests/test_pallas.py)."""
    rng = np.random.default_rng(11)
    mask = np.zeros((2, 64, 128), np.float32)
    for b in range(2):
        for _ in range(12):
            y, x = rng.integers(0, 56), rng.integers(0, 118)
            h, w = rng.integers(2, 9), rng.integers(2, 11)
            mask[b, y:y + h, x:x + w] = 1.0
        sp = rng.random((64, 128)) < 0.04
        mask[b][sp] = 1.0
    return mask


def _staircase():
    """A diagonal-only chain, an isolated speck and a bar (test_pallas.py)."""
    mask = np.zeros((1, 32, 128), np.float32)
    for i in range(20):
        mask[0, 5 + i % 20, 30 + i] = 1.0
    mask[0, 2, 2] = 1.0
    mask[0, 28, 100:110] = 1.0
    return mask


def _half_res_ink():
    """One 256x256 half-resolution ink mask of a rendered crop."""
    gray, _ = gray_and_color(crops(1)[0])
    ink = binarize_ink(jnp.asarray(gray.astype(np.float32)))
    return np.asarray(downsample2(ink))


def _blobs_and_staircase():
    """Both test_pallas.py masks in one (3, 64, 128) batch (the staircase
    gains empty rows below; ids depend on the width only), so each XLA
    shape compiles once."""
    stair = np.zeros((1, 64, 128), np.float32)
    stair[:, :32] = _staircase()
    return np.concatenate([_blobs(), stair])


# one compiled program instead of op-by-op dispatch of the sort and scan
_jax_stats = jax.jit(jcc.component_stats_device, static_argnames="k")

MASKS = {"pallas_masks": _blobs_and_staircase, "rendered256": _half_res_ink}
CAPS = [4, 6, 10, 64]


@pytest.fixture(scope="module")
def masks():
    return {k: f() for k, f in MASKS.items()}


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("cap", CAPS)
def test_labels_equal_jax_xla(masks, name, conn, cap):
    m = masks[name]
    want = np.asarray(jcc.connected_components(jnp.asarray(m), max_iters=cap,
                                               connectivity=conn))
    got = tcc.connected_components(torch.from_numpy(m.copy()), cap, conn)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("cap", CAPS)
def test_labels_equal_pallas_interpret(masks, name, conn, cap):
    m = masks[name]
    want = np.asarray(connected_components_pallas(
        jnp.asarray(m), max_iters=cap, connectivity=conn, interpret=True))
    got = tcc.connected_components(torch.from_numpy(m.copy()), cap, conn)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("k", [8, 128])
def test_component_stats_exact(masks, name, k):
    m = masks[name]
    labels = np.array(jcc.connected_components(jnp.asarray(m), max_iters=10))
    want = _jax_stats(jnp.asarray(labels), k=k)
    got = tcc.component_stats_device(torch.from_numpy(labels), k=k)
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key


def test_census_counts_exact(masks):
    labels = np.array(jcc.connected_components(
        jnp.asarray(masks["rendered256"]), max_iters=6))
    js = _jax_stats(jnp.asarray(labels), k=8)
    ts = tcc.component_stats_device(torch.from_numpy(labels), k=8)
    preds = [
        lambda a, w, h, *_: (a >= 3) & (a <= 44),
        lambda a, w, h, *_: (a >= 30) & (w >= 6) & (h >= 6) & (a / (w * h) > 0.35),
        lambda a, w, h, x0, y0, x1, y1: (x0 > 0) & (y0 > 0) & (x1 < 100) & (h > 1.2 * w),
    ]
    for pred in preds:
        assert np.array_equal(tcc.census_counts(ts, pred).numpy(),
                              np.asarray(jcc.census_counts(js, pred)))


def test_wrapper_rejects_other_devices():
    """No silent fallback: only CPU (twin) and CUDA (kernel) tensors run."""
    m = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError):
        tcc.connected_components(m)



# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm, modelled in numpy (csrc/cc.cu). Each CTA of a
# cluster holds a band of rows; a column's forward-then-backward segmented
# max (= every vertical run gets its max) is taken in each band, then the
# bands publish their top run's max, bottom run's max and whether the column
# is all ink, and every band folds the runs that continue from above and
# below.

def _banded_column_pass(lbl, m, bands):
    """(H, W) int64 labels, {0,1} mask -> labels after the kernel's
    two-level column pass with ``bands`` bands of ceil(H / bands) rows."""
    H = lbl.shape[0]
    size = -(-H // bands)
    spans = [(k * size, min(H, (k + 1) * size)) for k in range(bands)]
    spans = [s for s in spans if s[1] > s[0]]
    out = np.empty_like(lbl)
    summaries = []
    for a, b in spans:  # level 1, inside each band (the twin's own scans)
        t = torch.from_numpy(lbl[None, a:b])
        tm = torch.from_numpy(m[None, a:b])
        t = tcc._seg_max_scan(t, tm, 1, False)
        out[a:b] = tcc._seg_max_scan(t, tm, 1, True)[0].numpy()
        summaries.append((out[a].copy(), out[b - 1].copy(),
                          m[a:b].all(axis=0)))
    for k, (a, b) in enumerate(spans):  # level 2, the carries
        up = np.zeros(lbl.shape[1], np.int64)
        live = np.ones(lbl.shape[1], bool)
        for j in range(k - 1, -1, -1):
            v = summaries[j][1]
            live &= v > 0
            up = np.where(live, np.maximum(up, v), up)
            live &= summaries[j][2]
        dn = np.zeros_like(up)
        live = np.ones(lbl.shape[1], bool)
        for j in range(k + 1, len(spans)):
            v = summaries[j][0]
            live &= v > 0
            dn = np.where(live, np.maximum(dn, v), dn)
            live &= summaries[j][2]
        full = summaries[k][2]
        up, dn = np.where(full, np.maximum(up, dn), up), np.where(full, np.maximum(up, dn), dn)
        band_m = m[a:b].astype(bool)
        top_run = np.cumprod(band_m, axis=0).astype(bool)
        bot_run = np.cumprod(band_m[::-1], axis=0)[::-1].astype(bool)
        seg = out[a:b]
        seg = np.where(top_run, np.maximum(seg, up), seg)
        out[a:b] = np.where(bot_run, np.maximum(seg, dn), seg)
    return out


def _column_masks():
    rng = np.random.default_rng(21)
    dense = (rng.random((61, 40)) < 0.7).astype(np.int64)
    bars = (rng.random((64, 48)) < 0.3).astype(np.int64)
    bars[:, 5] = 1   # a component that spans every band
    bars[:, 17:19] = 1
    bars[31:33, 30] = 1  # a run across a band edge only
    return {"dense": dense, "spanning_bars": bars,
            "full": np.ones((16, 8), np.int64)}


@pytest.mark.parametrize("bands", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["dense", "spanning_bars", "full"])
def test_banded_column_scan_equals_twin(bands, name):
    m = _column_masks()[name]
    rng = np.random.default_rng(bands)
    lbl = rng.integers(1, 1 << 20, m.shape).astype(np.int64) * m
    t, tm = torch.from_numpy(lbl[None]), torch.from_numpy(m[None])
    want = tcc._seg_max_scan(tcc._seg_max_scan(t, tm, 1, False), tm, 1, True)
    got = _banded_column_pass(lbl, m, bands)
    assert np.array_equal(got, want[0].numpy())


def _random_045():
    rng = np.random.default_rng(45)
    return (rng.random((1, 256, 256)) < 0.45).astype(np.float32)


@pytest.mark.parametrize("case", ["converges", "cap_bound"])
def test_twin_stops_at_fixed_point_or_cap(masks, case):
    """The twin (and the kernel) stop at the fixed point or after max_iters
    + 1 rounds, whichever comes first; the labels equal JAX's while_loop and
    the Pallas kernel's fixed rounds either way."""
    if case == "converges":
        m, cap, conn = masks["pallas_masks"], 64, 8
    else:  # a random 0.45-density mask does not settle in 5 rounds
        m, cap, conn = _random_045(), 4, 8
    got, rounds = tcc.connected_components_reference(
        torch.from_numpy(m.copy()), cap, conn, return_rounds=True)
    if case == "converges":
        assert int(rounds.max()) < cap + 1
    else:
        assert rounds.tolist() == [cap + 1]
    want = np.asarray(jcc.connected_components(jnp.asarray(m), max_iters=cap,
                                               connectivity=conn))
    assert np.array_equal(got.numpy(), want)
    pallas = np.asarray(connected_components_pallas(
        jnp.asarray(m), max_iters=cap, connectivity=conn, interpret=True))
    assert np.array_equal(got.numpy(), pallas)
