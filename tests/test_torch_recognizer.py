"""PyTorch port vs flax: weight reading and the CTC recognizer.

- the jax-free msgpack reader returns exactly what flax's msgpack_restore
  returns, for both shipped weight files;
- a small Recognizer in float32 with random parameters matches flax within
  1e-4 (logits), and each parity hazard is pinned on its own;
- the shipped weights in bfloat16 on real line tiles decode to the same
  strings as flax in bfloat16 for >= 95% of tiles (measured on the CPU:
  64 of the 64 tiles of this fixture; 62 before the port rounded where XLA
  rounds);
- a layer cut over a one-rank 'model' axis equals the unsharded layer in
  bfloat16, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from synapta_tpu.models import recognizer as jrec
from synapta_tpu.models.charset import NUM_CLASSES, decode_greedy_batch
from synapta_tpu.models.train import load_params as jax_load_params
from synapta_tpu_torch.models import msgpack_io
from synapta_tpu_torch.models import recognizer as trec

from torchfixtures import crops, gray_and_color

WEIGHTS = os.path.dirname(msgpack_io.WEIGHTS_PATH)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", ["recognizer.msgpack", "detector.msgpack"])
def test_msgpack_reader_equals_flax(name):
    raw = open(os.path.join(WEIGHTS, name), "rb").read()
    _assert_trees_equal(serialization.msgpack_restore(raw),
                        msgpack_io.msgpack_restore(raw))


def test_msgpack_scalars_and_containers():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.float32(1.5), "d": np.zeros((0,), np.float64)},
            "e": np.array([-1e4], np.float32)}
    got = msgpack_io.msgpack_restore(serialization.msgpack_serialize(tree))
    _assert_trees_equal(serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)), got)


def test_load_params_pads_narrow_head(tmp_path):
    params = jax_load_params(msgpack_io.WEIGHTS_PATH)
    narrow = jax.tree.map(np.asarray, params)
    narrow["Dense_0"] = {"kernel": narrow["Dense_0"]["kernel"][:, :100],
                         "bias": narrow["Dense_0"]["bias"][:100]}
    path = str(tmp_path / "narrow.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(narrow))
    want = jax_load_params(path)
    got = msgpack_io.load_params(path)
    assert got["Dense_0"]["kernel"].shape[-1] == NUM_CLASSES
    _assert_trees_equal(jax.tree.map(np.asarray, want), got)


def _small_flax(dim=32, blocks=1, width=64, classes=20, seed=0):
    model = jrec.Recognizer(num_classes=classes, dim=dim, blocks=blocks,
                            dtype=jnp.float32)
    x = np.zeros((1, 32, width, 1), np.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    # perturb every leaf so zero biases / unit scales do not hide a bug
    tree = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        params)
    return model, tree


@pytest.mark.parametrize("width", [64, 40])
def test_small_recognizer_f32_matches_flax(width):
    model, tree = _small_flax(width=width)
    x = np.random.default_rng(1).random((3, 32, width, 1)).astype(np.float32)
    want = np.asarray(model.apply({"params": tree}, jnp.asarray(x)))
    tm = trec.recognizer_from_flax(tree, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n,stride,pads", [(32, 2, (0, 1)), (31, 2, (1, 1)),
                                           (384, 1, (1, 1)), (4, 2, (0, 1)),
                                           (5, 1, (1, 1))])
def test_same_padding_matches_flax(n, stride, pads):
    """flax 'SAME' on a stride-2 conv of an even axis pads (0, 1): an
    explicit pad + padding=0, never padding=1 (a one-pixel shift)."""
    assert trec._same_pad(n, stride) == pads


def test_encoder_block_hazards_match_flax():
    """LayerNorm eps 1e-6 (visible on a low-variance input), tanh gelu and
    the query scaling, against flax's EncoderBlock alone."""
    dim = 16
    fblk = jrec.EncoderBlock(dim=dim, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    # zero-mean: flax computes var as E[x^2] - E[x]^2, which cancels badly
    # on an offset input; the 1e-6 variance makes eps matter
    x = rng.normal(0, 1e-3, (2, 5, dim)).astype(np.float32)
    params = fblk.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tree = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.3, a.shape).astype(np.float32),
        params)
    want = np.asarray(fblk.apply({"params": tree}, jnp.asarray(x)))
    # wrap the block in a full flax-shaped tree so params_from_flax maps it
    sd = trec.params_from_flax({
        "Conv_0": {"kernel": np.zeros((3, 3, 1, 32), np.float32),
                   "bias": np.zeros(32, np.float32)},
        "pos_embed": np.zeros((1, 5, dim), np.float32),
        "EncoderBlock_0": tree,
        "LayerNorm_0": {"scale": np.ones(dim, np.float32),
                        "bias": np.zeros(dim, np.float32)},
        "Dense_0": {"kernel": np.zeros((dim, 3), np.float32),
                    "bias": np.zeros(3, np.float32)},
    })
    blk = trec.EncoderBlock(dim, dtype=torch.float32)
    blk.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()
                         if k.startswith("blocks.0.")})
    assert blk.ln0.eps == 1e-6 and blk.ln1.eps == 1e-6
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_model_axis_one_rank_equals_unsharded_bf16():
    """A layer cut over a 'model' axis (parallel/mesh.py::ModelAxis) gathers
    its ranks' columns and then adds the bias, as the unsharded layer adds
    it: in bfloat16 both round the product, then the sum. Over one gloo rank
    every conv and Dense of a small model, and so the logits, equal the
    unsharded model's bit for bit."""
    import torch.distributed as dist

    from synapta_tpu_torch.parallel.mesh import ModelAxis

    _, tree = _small_flax(width=64)
    tm = trec.recognizer_from_flax(tree, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(5).random((2, 1, 32, 64)).astype(np.float32))
    layers = trec.kernel_modules(tm)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with torch.no_grad():
            want = tm(x)
            h = torch.from_numpy(np.random.default_rng(6).normal(
                0, 1, (2, 16, 32)).astype(np.float32)).to(torch.bfloat16)
            plain = trec._dense(tm.blocks[0].query, h)
            for layer in layers.values():
                layer.model_axis = ModelAxis(dist.group.WORLD)
            got = tm(x)
            cut = trec._dense(tm.blocks[0].query, h)
    finally:
        dist.destroy_process_group()
    assert plain.dtype == torch.bfloat16 and torch.equal(cut, plain)
    assert torch.equal(got, want)


def test_head_runs_float32_on_bf16_trunk():
    tree = jax.tree.map(np.asarray, jax_load_params(msgpack_io.WEIGHTS_PATH))
    m = trec.recognizer_from_flax(tree, dtype=torch.bfloat16, device="cpu")
    assert m.convs[0].weight.dtype == torch.bfloat16
    assert m.head.weight.dtype == torch.float32
    with torch.no_grad():
        out = m(torch.zeros((1, 1, 32, 384)))
    assert out.dtype == torch.float32 and out.shape == (1, 96, NUM_CLASSES)


@pytest.fixture(scope="module")
def real_tiles():
    """~64 real (32, 384) uint8 line tiles cut from rendered crops."""
    from synapta_tpu_torch.config import OCRConfig
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.ops.features import analyze, unpack_analysis

    c, sizes = crops(8)
    gray, rgb_q = gray_and_color(c)
    packed = analyze(torch.from_numpy(gray), torch.from_numpy(rgb_q),
                     torch.from_numpy(sizes)).numpy()
    _, boxes = unpack_analysis(packed, c.shape[0])
    ocr = TorchOCR(OCRConfig(), device="cpu")
    tiles = ocr.collect_tiles(c, None, boxes)[0]
    assert len(tiles) >= 32
    return ocr, np.stack(tiles[:64])


def test_real_weights_bf16_decode_agreement(real_tiles):
    ocr, tiles = real_tiles
    params = jax_load_params(msgpack_io.WEIGHTS_PATH)
    x = jnp.asarray(tiles[..., None]).astype(jnp.float32) / 255.0
    logits = jrec.Recognizer().apply({"params": params}, x)
    want = decode_greedy_batch(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    got = [r["text"] for r in ocr.recognize_tiles(tiles)]
    agree = np.mean([a == b for a, b in zip(got, want)])
    assert agree >= 0.95, agree
