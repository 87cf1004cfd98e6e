"""PyTorch port vs JAX: color, filters and k-means (CPU).

Same numpy inputs through both; masks and counts must be exact, floats
within 1e-5 relative, k-means centres within 1e-3 with exact counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import synapta_tpu.ops as jops
import synapta_tpu_torch.ops as tops
from synapta_tpu.ops import cc as jcc
from synapta_tpu.ops import color as jcolor
from synapta_tpu.ops import features as jfeat
from synapta_tpu.ops import filters as jf
from synapta_tpu.ops import kmeans as jkm
from synapta_tpu_torch.ops import cc as tcc
from synapta_tpu_torch.ops import color as tcolor
from synapta_tpu_torch.ops import features as tfeat
from synapta_tpu_torch.ops import filters as tf
from synapta_tpu_torch.ops import kmeans as tkm

from torchfixtures import crops, gray_and_color

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def gray2():
    """Two rendered crops' gray (float32 0..255), a 256x256 corner each."""
    c, _ = crops(2)
    gray, _ = gray_and_color(c)
    return gray[:, :256, :256].astype(np.float32)


def test_gray_quarter_host_copy_matches():
    c, _ = crops(2)
    g1, q1 = jcolor.gray_quarter_host(c)
    g2, q2 = tcolor.gray_quarter_host(c)
    assert np.array_equal(g1, g2) and np.array_equal(q1, q2)


@pytest.mark.parametrize("source", ["rendered", "random"])
def test_rgb_to_gray_and_hsv(source):
    if source == "rendered":
        rgb = crops(2)[0][:, ::4, ::4]
    else:
        rgb = np.random.default_rng(0).integers(0, 256, (2, 64, 96, 3), np.uint8)
    want = np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb)))
    got = tcolor.rgb_to_gray(_t(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    for w, g in zip(jcolor.rgb_to_hsv(jnp.asarray(rgb)), tcolor.rgb_to_hsv(_t(rgb))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-4)


def test_sobel_edges_exact(gray2):
    je, jm, jt = jf.sobel_edges(jnp.asarray(gray2))
    te, tm, tt = tf.sobel_edges(_t(gray2))
    assert np.array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL, atol=1e-6)
    gx_j, gy_j = jf.sobel_gradients(jnp.asarray(gray2))
    gx_t, gy_t = tf.sobel_gradients(_t(gray2))
    assert np.array_equal(gx_t.numpy(), np.asarray(gx_j))
    assert np.array_equal(gy_t.numpy(), np.asarray(gy_j))


@pytest.mark.parametrize("kh,kw", [(1, 41), (41, 1), (5, 5), (9, 9), (2, 2),
                                   (2, 1), (3, 3), (1, 102), (39, 1)])
def test_morphology_exact(gray2, kh, kw):
    ink = (gray2 < 200).astype(np.float32)
    for jfn, tfn in ((jf.erode, tf.erode), (jf.dilate, tf.dilate),
                     (jf.morph_open, tf.morph_open)):
        want = np.asarray(jfn(jnp.asarray(ink), kh, kw))
        got = tfn(_t(ink), kh, kw).numpy()
        assert np.array_equal(got, want), (jfn.__name__, kh, kw)


@pytest.mark.parametrize("k", [1, 5, 39, 102])
def test_morph_open_h_v_exact(gray2, k):
    ink = (gray2 < 200).astype(np.float32)
    for jfn, tfn in ((jf.morph_open_h, tf.morph_open_h),
                     (jf.morph_open_v, tf.morph_open_v)):
        assert np.array_equal(tfn(_t(ink), k).numpy(),
                              np.asarray(jfn(jnp.asarray(ink), k))), (jfn.__name__, k)


@pytest.mark.parametrize("kh,kw", [(20, 1), (1, 20), (1, 25), (25, 1), (3, 2),
                                   (1, 1)])
def test_open_iter2_exact(gray2, kh, kw):
    """The default route's opens, on the rendered crops' edge maps."""
    edges = np.asarray(jf.sobel_edges(jnp.asarray(gray2))[0]).astype(np.float32)
    want = np.asarray(jfeat._open_iter2(jnp.asarray(edges), kh, kw))
    got = tfeat._open_iter2(_t(edges), kh, kw).numpy()
    assert np.array_equal(got, want)
    if (kh, kw) == (1, 20):
        assert got.any()


def test_component_stats_host(gray2):
    """Host stats of one label map: the port's copy against the original,
    on the labels of a rendered crop's ink."""
    ink = _t((gray2[:1, :128, :128] < 200).astype(np.float32))
    labels = tcc.connected_components(ink)[0].numpy()
    got = tcc.component_stats(labels, min_area=2)
    assert got == jcc.component_stats(labels, min_area=2)
    assert len(got) > 3 and got[0]["area"] >= got[-1]["area"] >= 2
    assert tcc.component_stats(np.zeros((4, 4), np.int32)) == []


def test_extract_crop_features_matches_jax():
    """The features-only pass (default route) as host numpy: counts exact,
    floats within 1e-5, variance held to the exact value as in
    tests/test_torch_analyze.py, k-means centres within 1e-3."""
    c, sizes = crops(2)
    want = jfeat.extract_crop_features(c, sizes=sizes)
    got = tfeat.extract_crop_features(c, sizes=sizes, device="cpu")
    assert set(got) == set(want)
    gray = gray_and_color(c)[0].astype(np.float64)
    for k in jfeat._SCALAR_KEYS:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (2,)
        if k == "variance":
            np.testing.assert_allclose(got[k], gray.var(axis=(1, 2)), rtol=1e-6)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        elif k in ("ring_score", "ring_radius", "circle_edge_density",
                   "ring_coverage"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        else:
            assert np.array_equal(got[k], want[k]), k
    np.testing.assert_allclose(got["kmeans_centers"], want["kmeans_centers"],
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(got["kmeans_counts"], want["kmeans_counts"])
    no_sizes = tfeat.extract_crop_features(c[:, :64, :64], device="cpu")
    assert no_sizes["edge_count"].shape == (2,)


def test_ops_package_exports_the_jax_names_lazily():
    """Every name synapta_tpu.ops exports resolves in the port's ops to the
    submodule's function, and importing the package alone loads none."""
    import subprocess
    import sys

    names = [n for n in dir(jops) if not n.startswith("_")
             and callable(getattr(jops, n))]
    assert {"morph_open_h", "morph_open_v", "component_stats",
            "extract_crop_features"} <= set(names)
    assert sorted(names) == tops.__all__
    for n in names:
        fn = getattr(tops, n)
        assert callable(fn) and fn.__module__.startswith("synapta_tpu_torch.ops.")
    assert tops.extract_crop_features is tfeat.extract_crop_features
    with pytest.raises(AttributeError):
        tops.no_such_op
    code = ("import sys, synapta_tpu_torch.ops; "
            "print([m for m in sys.modules if m.startswith('synapta_tpu_torch.ops.')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("length,anti", [(24, False), (24, True), (12, False),
                                         (12, True), (1, False), (7, True)])
def test_diagonal_run_mask_exact(gray2, length, anti):
    edges = np.asarray(jf.sobel_edges(jnp.asarray(gray2))[0])
    want = np.asarray(jf.diagonal_run_mask(jnp.asarray(edges), length, anti=anti))
    got = tf.diagonal_run_mask(_t(edges), length, anti=anti).numpy()
    assert np.array_equal(got, want)


def test_binarize_box_count_downsample(gray2):
    ink_j = jf.binarize_ink(jnp.asarray(gray2))
    ink_t = tf.binarize_ink(_t(gray2))
    assert np.array_equal(ink_t.numpy(), np.asarray(ink_j))
    assert np.array_equal(tf.box_count(ink_t).numpy(), np.asarray(jf.box_count(ink_j)))
    assert np.array_equal(tf.downsample2(ink_t).numpy(), np.asarray(jf.downsample2(ink_j)))
    assert np.array_equal(tf.downsample2_min(ink_t).numpy(),
                          np.asarray(jf.downsample2_min(ink_j)))


@pytest.mark.parametrize("source", ["rendered", "random"])
def test_dominant_colors(source):
    if source == "rendered":
        _, rgb_q = gray_and_color(crops(4)[0])
    else:
        rng = np.random.default_rng(3)
        # a few saturated colour patches plus noise
        rgb_q = np.full((2, 64, 64, 3), 255, np.uint8)
        for b in range(2):
            for _ in range(5):
                y, x = rng.integers(0, 48, 2)
                rgb_q[b, y:y + 16, x:x + 16] = rng.integers(30, 220, 3)
    jc, jn, jm = jkm.dominant_colors(jnp.asarray(rgb_q))
    tc, tn, tm = tkm.dominant_colors(_t(rgb_q))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3, atol=1e-3)
    for b in range(rgb_q.shape[0]):
        assert tkm.colors_to_hex(tc[b].numpy(), tn[b].numpy(), float(tm[b])) == \
            jkm.colors_to_hex(np.asarray(jc[b]), np.asarray(jn[b]), float(jm[b]))
