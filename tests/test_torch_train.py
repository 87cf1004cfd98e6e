"""The port's recognizer trainer vs the JAX package's, on the CPU.

Small sizes (dim 32, 1 encoder block, 32 × 64 tiles, batch 4) unless a
check needs the shipped weights. Inputs come from numpy seeds; flax
parameters cross over through ``params_from_flax``. Tolerances:

- CTC loss rtol 1e-5; every parameter gradient within 1e-4 of its leaf's
  largest magnitude (+1e-6): measured 5e-6 relative.
- adamw + schedule against optax over 5 steps on both models' trees:
  params within 1e-6 relative + 1e-7 absolute (a few float32 ulps);
  schedule values at every count within 1e-5
  relative (+1e-7 × peak absolute: optax computes in float32).
- 3 ``make_train_step`` steps: losses rtol 1e-5, params within 1e-6
  absolute; the attention key bias, whose gradient is zero in exact
  arithmetic, within 2 × the summed learning rates.
- ``evaluate``'s CER, ``pad_params``, the msgpack bytes, the seeded batches,
  ``params_to_flax ∘ params_from_flax`` and flax's key order: equal.
- The init: the same shapes and key order as a flax init, zero biases,
  LayerNorm ones, and each kernel's standard deviation within 10% of
  flax's (sampling tolerance for the smallest leaf, 288 draws).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from synapta_tpu.models import recognizer as jrec
from synapta_tpu.models import synthdata as jsd
from synapta_tpu.models import train as jtrain
from synapta_tpu_torch.models import msgpack_io, optim
from synapta_tpu_torch.models import recognizer as trec
from synapta_tpu_torch.models import synthdata as tsd
from synapta_tpu_torch.models import train as ttrain

from torchfixtures import pin_threads

pin_threads()


def np_tree(x):
    """A flax tree as nested dicts of numpy arrays, keys in their order."""
    return {k: np_tree(v) for k, v in x.items()} if hasattr(x, "items") \
        else np.asarray(x)


def leaves(x, path=""):
    for k, v in x.items():
        if isinstance(v, dict):
            yield from leaves(v, path + k + "/")
        else:
            yield path + k, np.asarray(v)


def keys(x, path=""):
    out = []
    for k, v in x.items():
        out.append(path + k)
        if isinstance(v, dict):
            out += keys(v, path + k + "/")
    return out


def assert_trees_equal(a, b):
    """The same leaves at the same paths (files keep flax's sorted order,
    params_to_flax flax's creation order)."""
    a, b = dict(leaves(a)), dict(leaves(b))
    assert sorted(a) == sorted(b)
    for p, x in a.items():
        assert x.dtype == b[p].dtype and x.shape == b[p].shape, p
        assert np.array_equal(x, b[p]), p


def small(seed=0, width=64):
    """A float32 flax recognizer (dim 32, 1 block) with perturbed params
    (so zero biases and unit scales hide nothing) and the port's twin."""
    jm = jrec.Recognizer(dim=32, blocks=1, dtype=jnp.float32)
    params = np_tree(jm.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 32, width, 1)))["params"])
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict)
                else v + rng.normal(0, 0.02, v.shape).astype(np.float32)
                for k, v in t.items()}

    params = perturb(params)
    tm = trec.Recognizer(dim=32, blocks=1, seq_len=width // 4,
                         dtype=torch.float32)
    tm.load_state_dict(trec.params_from_flax(params))
    return jm, params, tm


def batch(seed=1, n=4):
    # labels of at most 8 characters: a 64-wide tile has 16 frames
    return jsd.make_batch(np.random.default_rng(seed), batch=n, width=64,
                          max_label=8)


def to_torch(imgs, labels, lens):
    return (torch.from_numpy(imgs).permute(0, 3, 1, 2),
            torch.from_numpy(labels), torch.from_numpy(lens))


def grads_tree(model):
    return trec.params_to_flax({k: p.grad for k, p in model.named_parameters()})


def test_ctc_objective_and_grads_match_jax():
    jm, params, tm = small()
    imgs, labels, lens = batch()
    want, jgrads = jax.value_and_grad(jtrain.ctc_objective)(
        params, jm, imgs, labels, lens)
    got = ttrain.ctc_objective(tm, *to_torch(imgs, labels, lens))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jg = dict(leaves(np_tree(jgrads)))
    for path, g in leaves(grads_tree(tm)):
        w = jg[path]
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=path)


def test_ctc_objective_is_the_plain_mean():
    """optax averages per-sequence NLLs; torch's "mean" would divide each by
    its label length first, which differs when the lengths differ."""
    _, _, tm = small()
    imgs, labels, lens = batch()
    assert len(set(lens.tolist())) > 1
    x, y, n = to_torch(imgs, labels, lens)
    with torch.no_grad():
        got = float(ttrain.ctc_objective(tm, x, y, n))
        lp = torch.log_softmax(tm(x), -1).transpose(0, 1)
        frames = torch.full((4,), lp.shape[0], dtype=torch.long)
        per_len = float(torch.nn.functional.ctc_loss(
            lp, y.long(), frames, n.long(), reduction="mean"))
    assert abs(got - per_len) > 1e-3 * got


@pytest.mark.parametrize("steps,warmup,peak", [(1500, 100, 3e-4), (400, 50, 1e-3),
                                               (150, 100, 3e-4), (60, 50, 1e-3),
                                               (10, 2, 1e-3)])
def test_schedule_matches_optax(steps, warmup, peak):
    want_fn = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    got_fn = optim.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    counts = np.arange(steps + 5)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(counts)))
    got = np.array([got_fn(int(c)) for c in counts])
    assert got[0] == 0.0  # the first update has lr 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * peak)


def test_schedule_raises_like_optax_without_decay_steps():
    for fn in (optax.warmup_cosine_decay_schedule,
               optim.warmup_cosine_decay_schedule):
        with pytest.raises(ValueError):
            fn(0.0, 1e-3, 50, 30)


def _detector_tree(seed):
    from synapta_tpu.models.detector import Detector

    return np_tree(Detector(dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 1)))["params"])


@pytest.mark.parametrize("model,b2", [("recognizer", 0.98), ("detector", 0.999)])
def test_adamw_matches_optax(model, b2):
    """5 updates from the same gradients (seeded numpy) on both models'
    trees, with the trainers' betas and a warmup-cosine schedule."""
    tree = small()[1] if model == "recognizer" else _detector_tree(0)
    names = [p for p, _ in leaves(tree)]
    sched = (2, 10, 1e-3)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, sched[2], sched[0],
                                                         sched[1]), 0.9, b2)
    jparams = {p: jnp.asarray(v) for p, v in leaves(tree)}
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = [torch.tensor(v, requires_grad=True) for _, v in leaves(tree)]
    ttx = optim.adamw(tparams, optim.warmup_cosine_decay_schedule(
        0.0, sched[2], sched[0], sched[1]), 0.9, b2)
    rng = np.random.default_rng(3)
    for _ in range(5):
        g = {p: rng.normal(0, 1, v.shape).astype(np.float32)
             for p, v in leaves(tree)}
        updates, state = update({p: jnp.asarray(v) for p, v in g.items()},
                                state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, name in zip(tparams, names):
            p.grad = torch.from_numpy(g[name])
        ttx.step()
    for p, name in zip(tparams, names):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_train_step_matches_jax():
    """3 steps of make_train_step against JAX's (float32, adamw b2 0.98,
    warmup 2 of 10 so that steps 2 and 3 move the parameters)."""
    jm, params, tm = small()
    sched = (0.0, 1e-3, 2, 10)
    jstep = jtrain.make_train_step(
        jm, optax.adamw(optax.warmup_cosine_decay_schedule(*sched), 0.9, 0.98))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(*sched), 0.9, 0.98)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tstep = ttrain.make_train_step(tm, optim.adamw(
        tm.parameters(), optim.warmup_cosine_decay_schedule(*sched), 0.9, 0.98))
    for s in range(3):
        imgs, labels, lens = batch(seed=10 + s)
        jp, state, jloss = jstep(jp, state, imgs, labels, lens)
        tloss = tstep(imgs, labels, lens)
        assert tloss.ndim == 0 and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = dict(leaves(np_tree(jp)))
    lr_sum = sum(optax.warmup_cosine_decay_schedule(*sched)(c) for c in range(3))
    for path, got in leaves(trec.params_to_flax(tm.state_dict())):
        # softmax ignores a per-key shift: the key bias's gradient is zero in
        # exact arithmetic, and Adam normalises its rounding noise to ±lr
        atol = 2 * float(lr_sum) if path.endswith("key/bias") else 1e-6
        np.testing.assert_allclose(got, want[path], rtol=0, atol=atol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def shipped():
    return msgpack_io.load_params()


def test_evaluate_cer_equals_jax(shipped):
    """The shipped weights in float32: the same CER on the same seeded lines."""
    jm = jrec.Recognizer(dtype=jnp.float32)
    want = jtrain.evaluate(jm, jax.tree.map(jnp.asarray, shipped),
                           np.random.default_rng(5), n_batches=1, batch=16)
    tm = trec.recognizer_from_flax(shipped, dtype=torch.float32, device="cpu")
    got = ttrain.evaluate(tm, np.random.default_rng(5), n_batches=1, batch=16)
    assert got == want
    assert got < 0.05  # the JAX package's bar (tests/test_ocr.py)


def test_pad_params_equals_jax(shipped):
    old = {k: dict(v) if isinstance(v, dict) else v for k, v in shipped.items()}
    old["Dense_0"] = {"kernel": shipped["Dense_0"]["kernel"][:, :100],
                      "bias": shipped["Dense_0"]["bias"][:100]}
    new = ttrain.init_params(torch.Generator().manual_seed(0))
    got = ttrain.pad_params(old, new)
    want = np_tree(jtrain.pad_params(old, new))
    assert keys(got) == keys(new)
    assert_trees_equal(got, want)
    assert np.array_equal(got["Dense_0"]["kernel"][:, 100:],
                          new["Dense_0"]["kernel"][:, 100:])
    with pytest.raises(ValueError):
        ttrain.pad_params({"pos_embed": np.zeros((96, 192), np.float32)}, new)


def test_params_to_flax_inverts_params_from_flax(shipped):
    back = trec.params_to_flax(trec.params_from_flax(shipped))
    assert_trees_equal(back, shipped)
    # flax's creation order (the key order is the same at any width)
    assert keys(back) == keys(np_tree(jrec.Recognizer(dim=32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 1)))["params"]))


def test_msgpack_writer_bytes_equal_flax():
    """Byte for byte, for a tree in flax's creation order (flax writes every
    dict's keys sorted) and for the other types flax's writer takes."""
    tree = small()[1]
    assert msgpack_io.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    odd = {"s": np.float32(1.5), "i": np.int64(-3), "e": np.zeros((0,), np.float64),
           "h": np.ones((300,), np.float16), "b": np.arange(3, dtype=np.int8),
           "py": [1, -1, 200, -200, 70000, -70000, 2 ** 40, -2 ** 40, 1.25,
                  None, True, False, "x" * 40, b"y" * 300], "n" * 40: {}}
    assert msgpack_io.msgpack_serialize(odd) == serialization.msgpack_serialize(odd)


def test_checkpoints_cross_both_ways(tmp_path):
    """The port's checkpoint through JAX's load_params, and flax's file
    through the port's: the same forward pass either way (float32)."""
    x = np.random.default_rng(2).random((2, 32, 384, 1)).astype(np.float32)
    jm = jrec.Recognizer(dtype=jnp.float32)
    tree = ttrain.init_params(torch.Generator().manual_seed(4))
    path = str(tmp_path / "port.msgpack")
    ttrain.save_params(tree, path)
    jparams = jtrain.load_params(path)
    want = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)))
    tm = trec.recognizer_from_flax(ttrain.load_params(path), dtype=torch.float32,
                                   device="cpu")
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # flax's own file (JAX's save_params) through the port's reader
    fpath = str(tmp_path / "flax.msgpack")
    jtrain.save_params(jparams, fpath)
    assert open(fpath, "rb").read() == open(path, "rb").read()
    assert_trees_equal(ttrain.load_params(fpath), tree)


def test_init_params_matches_flax_init():
    want = np_tree(jtrain.init_params(jax.random.PRNGKey(0)))
    got = ttrain.init_params(torch.Generator().manual_seed(0))
    assert keys(got) == keys(want)
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("bias"):
            assert not g.any(), path
        elif path.endswith("scale"):
            assert (g == 1).all(), path
        else:  # lecun_normal kernels, pos_embed N(0, 0.02)
            assert abs(g.std() / w.std() - 1) < 0.1, path
            if not path.endswith("pos_embed"):  # truncated at 2 sigma
                assert np.abs(g).max() <= np.abs(w).max() * 1.02, path


def test_training_dtypes_give_the_inference_logits():
    """float32 parameters cast to bf16 where flax casts them (the trainer's
    models) against the inference loaders' bf16 parameters: the detector's
    logits are equal; the recognizer's differ only by its LayerNorms, which
    train in float32 as flax's do and infer in bf16 as since PR 1 (within
    0.05; measured 0.024 on logits up to 3.1)."""
    from synapta_tpu_torch.models import detector as tdet

    tree = ttrain.init_params(torch.Generator().manual_seed(3))
    train_m = ttrain.create_model(torch.bfloat16)
    train_m.load_state_dict(trec.params_from_flax(tree))
    assert train_m.convs[0].weight.dtype == torch.float32
    infer_m = trec.recognizer_from_flax(tree, dtype=torch.bfloat16, device="cpu")
    x = torch.rand((2, 1, 32, 384), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        err = float((train_m(x) - infer_m(x)).abs().max())
    assert err <= 0.05
    sd = tdet.init_params(tdet.Detector(dtype=torch.float32),
                          torch.Generator().manual_seed(3)).state_dict()
    train_d = tdet.Detector(dtype=torch.bfloat16)
    train_d.load_state_dict(sd)
    infer_d = tdet.detector_from_flax(tdet.params_to_flax(sd),
                                      dtype=torch.bfloat16, device="cpu")
    x = torch.rand((1, 1, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(train_d(x), infer_d(x))


@pytest.mark.parametrize("kind", ["pil", "mixed"])
def test_batches_equal_jax(kind):
    if kind == "pil":
        want = jsd.make_batch(np.random.default_rng(7), batch=6, width=128)
        got = tsd.make_batch(np.random.default_rng(7), batch=6, width=128)
    else:
        want = jsd.make_batch_mixed(np.random.default_rng(7), batch=6)
        got = tsd.make_batch_mixed(np.random.default_rng(7), batch=6)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_synthdata_fonts_without_system_fonts_or_fonttools(monkeypatch):
    """Missing system DejaVu files and no fontTools: the generator's faces
    point at the shipped copies, and each face's coverage comes from its
    cmap, equal to what fontTools reports."""
    import builtins

    import synapta_tpu_torch.io.pdf_writer as pw
    from synapta_tpu_torch import hostlibs

    fonts = os.path.join(os.path.dirname(hostlibs.__file__), "fonts")
    want_cov = {os.path.basename(p): tsd._coverage(p) for p in tsd.FONTS}
    for mod, names in ((pw, ("DEJAVU", "DEJAVU_BOLD")),
                       (tsd, ("DEJAVU", "DEJAVU_BOLD", "DEJAVU_SERIF",
                              "DEJAVU_MONO"))):
        for n in names:
            monkeypatch.setattr(mod, n, "/nonexistent/" + n + ".ttf")
    monkeypatch.setattr(pw.text_width, "__defaults__", pw.text_width.__defaults__)
    monkeypatch.setattr(pw, "_CIDFontInfo", pw._CIDFontInfo)
    for n in ("FONTS", "_COVERAGE", "_FONT_CACHE"):
        monkeypatch.setattr(tsd, n, type(getattr(tsd, n))())
    real_import = builtins.__import__

    def no_fonttools(name, *a, **kw):
        if name.startswith("fontTools"):
            raise ImportError("no fontTools")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_fonttools)
    monkeypatch.delitem(sys.modules, "fontTools.ttLib", raising=False)
    hostlibs.ensure_synthdata_fonts()
    assert tsd.DEJAVU == os.path.join(fonts, "DejaVuSans.ttf")
    assert tsd.DEJAVU_SERIF == os.path.join(fonts, "DejaVuSerif.ttf")
    assert tsd.DEJAVU_MONO == os.path.join(fonts, "DejaVuSansMono.ttf")
    assert tsd.FONTS[:4] == [os.path.join(fonts, n) for n in (
        "DejaVuSans.ttf", "DejaVuSans-Bold.ttf", "DejaVuSerif.ttf",
        "DejaVuSansMono.ttf")]
    for p in tsd.FONTS:
        assert os.path.exists(p)
        assert tsd._coverage(p) == want_cov[os.path.basename(p)], p
    imgs, labels, lens = tsd.make_batch(np.random.default_rng(0), batch=4)
    assert imgs.shape == (4, 32, 384, 1) and lens.min() > 0


def test_train_cpu_from_shipped_weights(tmp_path):
    """``train`` end to end on the CPU (the smallest run the schedule allows:
    101 steps), warm-started from the shipped weights: a checkpoint that
    JAX's load_params reads, losses that stay low, and the JAX bar on CER."""
    out = str(tmp_path / "rec.msgpack")
    run = ttrain.train(steps=101, batch=2, seed=0, out=out, log_every=50,
                       init_from=msgpack_io.WEIGHTS_PATH, device="cpu")
    assert len(run["losses"]) == 101 and np.isfinite(run["losses"]).all()
    assert run["device_step_s"] is None and run["data_s"] > 0
    assert np.mean(run["losses"]) < 5.0, run["losses"]
    assert run["cer"] < 0.05
    params = jtrain.load_params(out)
    assert params["Dense_0"]["kernel"].shape == (192, 161)
    assert_trees_equal(np_tree(params), ttrain.load_params(out))


def test_train_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ttrain.train(steps=101, device="cuda")
