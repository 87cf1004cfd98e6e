"""PyTorch port vs flax: the DB line detector (models/detector.py).

Each test runs the same seeded numpy inputs through the JAX function and the
port's counterpart, on the CPU:

- the shipped weights in float32: logits within 1e-3 (measured 5.8e-5 at
  128² and 3.9e-5 at 512²) and >= 99.9% of the probability map on the same
  side of 0.3 (measured 100%);
- the parity hazards one by one: stride-2 SAME padding, GroupNorm (fast
  variance, eps 1e-6, float32 statistics on bfloat16), bilinear upsampling
  at the borders and at sizes that are not a doubling;
- the post stage (threshold -> closing -> CC -> stats -> boxes) given the
  same logit map: exactly equal to JAX's ``_boxes_device`` stage;
- ``DBLineDetector.detect_lines`` in bfloat16 on scanned canvases (the
  canvas path): every box equal to JAX's but the knife-edge line of
  tests/test_torch_entrypoints.py::KNIFE_EDGE, which may end a pixel higher
  (measured: 37 of 38 equal); on a native-resolution crop (1.05 < ratio
  <= 2): >= 90% of the boxes matched at IoU >= 0.9.
"""
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from synapta_tpu.models import detector as jdet
from synapta_tpu_torch.eval import _box_iou
from synapta_tpu_torch.models import detector as tdet

from torchfixtures import pin_threads

pin_threads()

LOGIT_03 = float(np.log(0.3 / 0.7))  # the probability threshold as a logit


@pytest.fixture(scope="module")
def tree():
    return tdet.load_det_params()


@pytest.fixture(scope="module")
def scanned():
    """Two scanned pages through the port's host prepare stage: (canvases
    (2, 512, 512, 3) uint8, render contexts)."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.ingest import open_pdf
    from synapta_tpu_torch.io.loader import prepare_batch
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book
    from synapta_tpu_torch.vision.detect import DetectionEngine

    pdf = tempfile.mkdtemp(prefix="torchdet_") + "/scan.pdf"
    make_scanned_book(pdf, pages=2, seed=2)
    cfg = PipelineConfig()
    render_doc = open_pdf(pdf)
    engine = DetectionEngine(open_pdf(pdf), cfg.detection, pixels_doc=render_doc)
    prepared = prepare_batch(engine, render_doc, cfg.detection.render_dpi,
                             cfg.ocr.crop_size, range(2))
    return np.array(prepared[1]), list(prepared[5])


def _port_logits(tree, x_nhwc):
    m = tdet.detector_from_flax(tree, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        out = m(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [128, 512])
def test_detector_f32_matches_flax(tree, scanned, size):
    rng = np.random.default_rng(size)
    x = rng.random((2, size, size, 1)).astype(np.float32)
    if size == 512:  # a scanned page and noise
        x[0, ..., 0] = tdet.DBLineDetector._luma(scanned[0][0]) / 255.0
    want = np.asarray(jdet.Detector(dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x)))
    got = _port_logits(tree, x)
    assert got.shape == want.shape == (2, size // 2, size // 2, 2)
    assert np.abs(got - want).max() <= 1e-3
    agree = np.mean((got[..., 0] > LOGIT_03) == (want[..., 0] > LOGIT_03))
    assert agree >= 0.999, agree


def test_state_dict_names_follow_flax(tree):
    """Conv_1 is the lateral of c4 (96 -> 64), Conv_4 the float32 head with
    a bias; GroupNorm's affine stays float32 in a bfloat16 model."""
    sd = tdet.params_from_flax(tree)
    assert tuple(sd["lat.1.weight"].shape) == (64, 96, 1, 1)
    assert tuple(sd["lat.3.weight"].shape) == (16, 16, 1, 1)
    m = tdet.detector_from_flax(tree, dtype=torch.bfloat16, device="cpu")
    assert m.blocks[0].conv.weight.dtype == torch.bfloat16
    assert m.blocks[0].gn_scale.dtype == torch.float32
    assert m.head.weight.dtype == torch.float32 and m.head.bias is not None
    with torch.no_grad():
        out = m(torch.zeros((1, 1, 64, 64)))
    assert out.dtype == torch.float32 and out.shape == (1, 2, 32, 32)


@pytest.mark.parametrize("n,stride", [(10, 2), (9, 2), (10, 1)])
def test_conv_block_same_padding_matches_flax(n, stride):
    """flax SAME on a stride-2 conv of an even axis pads (0, 1): padding=1
    would shift every map by a pixel."""
    blk = jdet.ConvBlock(16, stride, jnp.float32)
    rng = np.random.default_rng(n + stride)
    x = rng.random((2, n, n, 3)).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32),
        params)
    want = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    tb = tdet.ConvBlock(3, 16, stride, torch.float32)
    tb.conv.weight.data = torch.from_numpy(
        np.transpose(params["Conv_0"]["kernel"], (3, 2, 0, 1)).copy())
    tb.gn_scale.data = torch.from_numpy(params["GroupNorm_0"]["scale"])
    tb.gn_bias.data = torch.from_numpy(params["GroupNorm_0"]["bias"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tb(xt).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if stride == 2 and n % 2 == 0:
        # the tempting padding=1 shifts the map by a pixel and disagrees
        tb.conv.padding = (1, 1)
        with torch.no_grad():
            bad = torch.relu(tdet.group_norm(tb.conv(xt), 8, tb.gn_scale,
                                             tb.gn_bias))
        assert bad.shape == xt.shape[:1] + got.shape[-1:] + got.shape[1:3]
        assert np.abs(bad.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("channels,offset,spread,dtype", [
    (16, 0.0, 1e-3, jnp.float32), (96, 0.0, 1e-3, jnp.float32),
    (32, 2.0, 1.0, jnp.float32), (16, 0.5, 0.5, jnp.bfloat16),
    (96, 2.0, 1.0, jnp.bfloat16)])
def test_group_norm_matches_flax(channels, offset, spread, dtype):
    """groups min(8, C), eps 1e-6 (visible on a zero-mean input of spread
    1e-3), statistics and affine in float32, output in the compute dtype.
    Both compute the fast variance max(0, E[x²] - E[x]²); an offset far
    above the spread would make it rounding noise on both sides (summed in
    different orders), so offsets stay comparable to the spread."""
    gn = fnn.GroupNorm(num_groups=min(8, channels), dtype=dtype)
    rng = np.random.default_rng(channels)
    x = (offset + rng.normal(0, spread, (2, 6, 5, channels))).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    params = gn.init(jax.random.PRNGKey(0), xj)["params"]
    scale = rng.normal(1, 0.3, channels).astype(np.float32)
    bias = rng.normal(0, 0.3, channels).astype(np.float32)
    want = gn.apply({"params": {"scale": scale, "bias": bias}}, xj)
    assert set(params) == {"scale", "bias"}
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdtype)
    got = tdet.group_norm(xt.permute(0, 3, 1, 2), min(8, channels),
                          torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tdtype
    got = got.permute(0, 2, 3, 1).to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    # float32: rounding only; bfloat16: one bf16 step of the output
    tol = 1e-4 if dtype == jnp.float32 else 2 ** -7 * (np.abs(want) + 1)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("src,dst", [(8, 16), (32, 64), (7, 13), (13, 25),
                                     (25, 50), (3, 5)])
def test_upsample_matches_jax_resize(src, dst):
    """jax.image.resize bilinear drops an out-of-range tap and renormalises;
    F.interpolate clamps it: equal, borders included."""
    rng = np.random.default_rng(src * dst)
    t = rng.normal(0, 1, (2, src, src + 1, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(t), (2, dst, dst + 2, 3), "bilinear")
    like = torch.zeros((2, 3, dst, dst + 2))
    got = tdet.upsample_like(torch.from_numpy(t).permute(0, 3, 1, 2), like)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def test_post_stage_equals_jax(tree, scanned, monkeypatch):
    """Given the same logit map, threshold -> 1x9 closing -> CC (cap 10) ->
    component stats -> (B, 128, 5) boxes equal JAX's exactly. Logits within
    1e-3 of the threshold are moved 1e-2 away from it, so that sigmoid's
    last bit cannot flip a pixel on one side only."""
    gray = np.stack([tdet.DBLineDetector._luma(c) for c in scanned[0]])
    x = (gray.astype(np.float32) / 255.0)[..., None]
    logits = np.asarray(jdet.Detector(dtype=jnp.float32).apply(
        {"params": tree}, jnp.asarray(x)))
    p = logits[..., 0].copy()
    near = np.abs(p - LOGIT_03) < 1e-3
    p[near] = LOGIT_03 + np.where(p[near] >= LOGIT_03, 1e-2, -1e-2)
    assert (p > LOGIT_03).mean() > 0.01  # the map has text on it

    class FixedLogits:
        @staticmethod
        def apply(variables, inputs):
            return jnp.asarray(nudged)

    nudged = logits.copy()
    nudged[..., 0] = p
    monkeypatch.setattr(jdet, "_INFER_MODEL", FixedLogits())
    want = np.asarray(jdet._boxes_device.__wrapped__(None, gray, 0.3))
    mask = tdet.closed_mask(torch.from_numpy(p), 0.3)
    got = tdet.mask_boxes(mask).numpy()
    assert got.shape == want.shape == (2, 128, 5)
    assert (got[:, :, 4] > 4).sum() >= 20  # real line blobs
    np.testing.assert_array_equal(got, want)


def _matched_share(want, got):
    """Share of boxes (of the larger list) with a partner at IoU >= 0.9."""
    hits = sum(any(_box_iou(w, g) >= 0.9 for g in got) for w in want)
    return hits / max(len(want), len(got), 1)


@pytest.fixture(scope="module")
def detectors():
    return jdet.DBLineDetector(), tdet.DBLineDetector(device="cpu")


def test_detect_lines_scanned_canvas(detectors, scanned):
    """Scanned pages (ratio ~2.7) take the canvas path: one view a crop.
    Both bf16 models round alike op by op; the first line of page 1 has its
    lowest row on the threshold, so its box may end at y 32 against JAX's
    33. Every other box is equal."""
    jd, td = detectors
    canvases, ctxs = scanned
    assert all(c is not None and c[1] > 2.0 for c in ctxs)
    want = jd.detect_lines(canvases, hires=ctxs)
    got = td.detect_lines(canvases, hires=ctxs)
    assert [len(w) for w in want] == [len(g) for g in got]
    assert all(len(w) >= 15 for w in want)
    differ = [(w, g) for ws, gs in zip(want, got) for w, g in zip(ws, gs)
              if w != g]
    assert len(differ) <= 1, differ
    for w, g in differ:
        assert w == want[0][0] and w[:3] == g[:3] and w[3] - g[3] == 1, differ


def test_detect_lines_native_path(detectors):
    """A crop box-downscaled by 1.05 < ratio <= 2 detects on 512² views of
    its native-resolution image (here 2 x 2 views, stride 448)."""
    from PIL import Image, ImageDraw, ImageFont

    from synapta_tpu_torch.eval import _prep_standalone
    from synapta_tpu_torch.io.pdf_writer import DEJAVU

    rng = np.random.default_rng(4)
    im = Image.new("L", (820, 640), 240)
    d = ImageDraw.Draw(im)
    font = ImageFont.truetype(DEJAVU, 15)
    words = "the return of each asset depends on its weight and risk".split()
    for y in range(30, 600, 26):
        d.text((40, y), " ".join(rng.permutation(words)[:8]), fill=20, font=font)
    img = np.asarray(im, np.float32) + rng.normal(0, 4, (640, 820))
    img = np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)
    canvas, _, ctx = _prep_standalone(img, 512)
    assert 1.05 < ctx[1] <= 2.0
    jd, td = detectors
    want = jd.detect_lines(canvas[None], hires=[ctx])[0]
    got = td.detect_lines(canvas[None], hires=[ctx])[0]
    assert len(want) >= 15
    assert _matched_share(want, got) >= 0.9, (want, got)
