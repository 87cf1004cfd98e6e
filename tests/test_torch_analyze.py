"""PyTorch port vs JAX: the fused analyze pass and the text-line boxes.

The port's analyze (CPU: the kernels' plain twins) is held to JAX
``_analyze_impl`` on both of its routes: ``use_pallas=False``, the default
(XLA opens, the union in ``line_pixels``), and ``use_pallas=True``, whose
edge counts come from the Pallas kernel in interpret mode. Counts and boxes
exact, float features within 1e-5 relative. The packed layout must be
identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapta_tpu.ocr import linedet as jl
from synapta_tpu.ops import features as jfeat
from synapta_tpu_torch.ocr import linedet as tl
from synapta_tpu_torch.ops import features as tfeat

from torchfixtures import crops, gray_and_color

# columns holding real-valued (not integer-count) features
FLOAT_KEYS = {"ring_score", "ring_radius", "circle_edge_density",
              "ring_coverage", "variance"}


@pytest.fixture(scope="module")
def chunk():
    c, sizes = crops(2)
    gray, rgb_q = gray_and_color(c)
    return c, gray, rgb_q, sizes


@pytest.fixture(scope="module", params=[False, True],
                ids=["default_route", "pallas_route"])
def packed_pair(chunk, request):
    _, gray, rgb_q, sizes = chunk
    want = np.asarray(jfeat._analyze_impl(
        jnp.asarray(gray), jnp.asarray(rgb_q), jnp.asarray(sizes),
        use_pallas=request.param))
    got = tfeat.analyze(torch.from_numpy(gray), torch.from_numpy(rgb_q),
                        torch.from_numpy(sizes),
                        use_pallas=request.param).numpy()
    return want, got, request.param


def test_layout_identical(packed_pair):
    want, got, _ = packed_pair
    assert tfeat._SCALAR_KEYS == jfeat._SCALAR_KEYS
    assert tl.MAX_LINES == jl.MAX_LINES
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("key", jfeat._SCALAR_KEYS)
def test_scalar_feature(packed_pair, chunk, key):
    want, got, _ = packed_pair
    i = jfeat._SCALAR_KEYS.index(key)
    if key == "variance":
        # A float32 sum over 512x512 pixels: XLA's summation order leaves
        # ~1e-5 relative error in JAX's own value on rendered crops, while
        # torch's cascaded sum lands within 1e-6 of the float64 variance.
        # Held to the exact value, and at least as close to it as JAX.
        exact = chunk[1].astype(np.float64).var(axis=(1, 2))
        np.testing.assert_allclose(got[:, i], exact, rtol=1e-6)
        assert np.all(np.abs(got[:, i] - exact)
                      <= np.abs(want[:, i] - exact) + 1e-6 * exact)
    elif key in FLOAT_KEYS:
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=1e-5)
    else:
        assert np.array_equal(got[:, i], want[:, i]), (got[:, i], want[:, i])


def test_kmeans_columns(packed_pair):
    want, got, _ = packed_pair
    n = len(jfeat._SCALAR_KEYS)
    np.testing.assert_allclose(got[:, n:n + 15], want[:, n:n + 15],
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(got[:, n + 15:n + 20], want[:, n + 15:n + 20])


def test_line_boxes_exact(packed_pair):
    want, got, _ = packed_pair
    n = len(jfeat._SCALAR_KEYS) + 20
    assert np.array_equal(got[:, n:], want[:, n:])
    boxes = got[:, n:].reshape(2, tl.MAX_LINES, 5)
    assert (boxes[:, :, 4] > 0).sum() > 5  # some real text lines


def test_unpack_and_extract_line_boxes(packed_pair):
    want, got, _ = packed_pair
    jf, jb = jfeat.unpack_analysis(want, 2)
    tf, tb = tfeat.unpack_analysis(got, 2)
    assert set(jf) == set(tf)
    for i in range(2):
        assert tl.extract_line_boxes(tb[i]) == jl.extract_line_boxes(jb[i])


def test_device_analyze_dispatch_cpu(chunk, packed_pair):
    c, _, _, sizes = chunk
    _, got, use_pallas = packed_pair
    packed = tfeat.device_analyze_dispatch(c, sizes=sizes, device="cpu",
                                           use_pallas=use_pallas)
    assert packed.device.type == "cpu"
    assert np.array_equal(packed.numpy(), got)


def test_edge_columns_follow_the_route(packed_pair, chunk):
    """The edge columns of the packed result are the route's own counts, and
    ``line_pixels`` is the union (default) or the v + h sum (Pallas) plus
    ``diag_pixels``; on crop 1 the two routes' counts differ (the Pallas
    route loses the first lanes of every open)."""
    from synapta_tpu_torch.ops.cuda_kernels import fused_edge_stats_reference

    _, got, use_pallas = packed_pair
    col = {k: got[:, i] for i, k in enumerate(jfeat._SCALAR_KEYS)}
    gray = torch.from_numpy(chunk[1].astype(np.float32))
    own = fused_edge_stats_reference(gray, use_pallas=use_pallas).numpy()
    for j, k in enumerate(("edge_count", "v_pixels", "h_pixels", "grid_h", "grid_v")):
        assert np.array_equal(col[k], own[:, j]), k
    lines = own[:, 1] + own[:, 2] if use_pallas else own[:, 5]
    assert np.array_equal(col["line_pixels"], lines + col["diag_pixels"])
    other = fused_edge_stats_reference(gray, use_pallas=not use_pallas).numpy()
    assert own[1, 1] != other[1, 1] and own[1, 4] != other[1, 4]
    assert np.array_equal(own[:, 0], other[:, 0])  # the same edges here


def test_pallas_wanted_reads_the_environment(monkeypatch):
    monkeypatch.delenv("SYNAPTA_PALLAS_EDGE", raising=False)
    assert tfeat._pallas_wanted() is False
    monkeypatch.setenv("SYNAPTA_PALLAS_EDGE", "1")
    assert tfeat._pallas_wanted() is True
    monkeypatch.setenv("SYNAPTA_PALLAS_EDGE", "0")
    assert tfeat._pallas_wanted() is False


def test_standalone_detect_lines(chunk):
    """The standalone path (collect_tiles without fused boxes): float-luma
    ink -> boxes, against JAX line_boxes_device."""
    c = chunk[0][:1]
    want = np.asarray(jl.line_boxes_device(jnp.asarray(c)))
    got = tl.line_boxes_device(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, want)
    assert tl.detect_lines(c, "cpu") == [jl.extract_line_boxes(want[0])]
