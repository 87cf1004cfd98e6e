"""PyTorch port vs JAX: color, filters and k-means (CPU).

Same numpy inputs through both; masks and counts must be exact, floats
within 1e-5 relative, k-means centres within 1e-3 with exact counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapta_tpu.ops import color as jcolor
from synapta_tpu.ops import filters as jf
from synapta_tpu.ops import kmeans as jkm
from synapta_tpu_torch.ops import color as tcolor
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
