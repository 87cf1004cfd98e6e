"""The port's DB detector trainer vs the JAX package's, on the CPU.

Small sizes (64² and 128² pages, batch 2). Inputs come from numpy seeds;
flax parameters cross over through ``params_from_flax``. Tolerances:

- ``db_loss`` alone (a model that returns fixed logits), with ties at the
  hard-negative cut: loss rtol 1e-5 (float32 sums over 2048 pixels in
  another order), gradient w.r.t. the logits within
  1e-7, and the BCE term's share on exactly the first tied pixels by index.
- ``db_loss`` through the detector: in float64 every parameter gradient
  within 1e-5 of its leaf's largest magnitude (the head runs in float32, as
  flax's does); in float32 the loss rtol 1e-5. float32 gradients are not
  compared: GroupNorm's fast variance E[x²] − E[x]² cancels on the nearly
  constant activations of white pages, and the binarization's sigmoid(50·)
  amplifies the rounding (measured up to 1.4e-2 relative apart, in both
  frameworks' own orders of summation).
- 3 training steps (adamw, warmup 2 of 10) in float64: losses rtol 1e-7,
  parameters within 2.5e-7 once cast to float32 (two float32 ulps at 1).
- ``make_det_batch``, the msgpack bytes, ``params_to_flax ∘
  params_from_flax`` and flax's key order: equal. A forward pass from a
  crossed checkpoint: float32 logits within 1e-3 (as
  tests/test_torch_detector.py holds the detector).
- The init: flax's shapes and key order, zero head bias, GroupNorm ones and
  zeros, and each kernel's standard deviation within 15% of flax's
  (sampling tolerance for the smallest leaf, 144 draws).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
from flax import serialization

from synapta_tpu.models import detector as jdet
from synapta_tpu_torch.models import detector as tdet
from synapta_tpu_torch.models import optim

from test_torch_train import assert_trees_equal, keys, leaves, np_tree

from torchfixtures import pin_threads

pin_threads()


def _flax_params(seed=0, size=64, dtype=jnp.float32):
    return np_tree(jdet.Detector(dtype=dtype).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 1)))["params"])


def _targets(seed=0, batch=2, size=64):
    return jdet.make_det_batch(np.random.default_rng(seed), batch=batch, size=size)


def test_top_k_ties_prefer_the_lower_index():
    """XLA's top_k and a stable descending sort order tied values the same
    way, lower index first (-inf, the masked positives, last)."""
    x = np.array([1.0, 2.0, 2.0, -np.inf, 1.0, 2.0, -np.inf, 0.5, 2.0],
                 np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), x.size)[1])
    got = torch.sort(torch.from_numpy(x), descending=True, stable=True).indices
    assert want.tolist() == got.tolist() == [1, 2, 5, 8, 0, 4, 7, 3, 6]


class _FixedOut(fnn.Module):
    shape: tuple

    @fnn.compact
    def __call__(self, x):
        return self.param("out", lambda key, s: jnp.zeros(s), self.shape)


class _TorchFixedOut(torch.nn.Module):
    def __init__(self, out_nhwc):
        super().__init__()
        self.out = torch.nn.Parameter(torch.from_numpy(out_nhwc))

    def forward(self, x):
        return self.out.permute(0, 3, 1, 2)


def test_db_loss_alone_matches_jax_with_ties_at_the_cut():
    """White background gives exactly equal BCE values. Here 20 positive
    pixels make k = 60 hard negatives; 30 background pixels are distinct
    and harder, the other 2018 share one logit, so the cut falls inside the
    tied run and the gradient lands on its first 30 pixels by index."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 32, 32
    prob_t = np.zeros((B, H, W), np.float32)
    prob_t[0, 4:8, 10:15] = 1.0
    # one threshold logit everywhere: the tied pixels then differ only in
    # whether the BCE term counts them
    logits = np.full((B, H, W, 2), -3.0, np.float32)
    logits[..., 1] = 0.5
    hard = rng.choice(np.flatnonzero(prob_t.ravel() == 0), 30, replace=False)
    logits[..., 0].reshape(-1)[hard] = rng.uniform(-1.0, 2.0, 30)
    logits[0, 4:8, 10:15, 0] = rng.normal(0, 1, (4, 5))
    band = (rng.random((B, H, W)) < 0.3).astype(np.float32)
    thr_t = 0.7 * band
    jm = _FixedOut(logits.shape)
    want, jg = jax.value_and_grad(jdet.db_loss)(
        {"out": jnp.asarray(logits)}, jm, jnp.zeros((B, 2 * H, 2 * W, 1)),
        prob_t, band, thr_t)
    tm = _TorchFixedOut(logits)
    got = tdet.db_loss(tm, torch.zeros((B, 1, 2 * H, 2 * W)),
                       *(torch.from_numpy(a) for a in (prob_t, band, thr_t)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g_t = tm.out.grad.numpy()[..., 0].ravel()
    g_j = np.asarray(jg["out"])[..., 0].ravel()
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tm.out.grad.numpy(), np.asarray(jg["out"]),
                               rtol=0, atol=1e-7)
    # through the BCE term only the hard negatives inside k are set apart
    # from the rest of the tied run: the first 30 tied pixels by index
    tied = np.flatnonzero((logits[..., 0].ravel() == -3.0)
                          & (prob_t.ravel() == 0))
    bce_part = g_t[tied] - g_t[tied[-1]]
    assert (np.abs(bce_part[:30]) > 1e-6).all()
    assert (bce_part[30:] == 0).all()


def _small_pair(f64=False, seed=0):
    """A flax Detector and its perturbed params (float64 leaves for a
    float64 run) and the port's twin in the same dtype (its head stays
    float32 either way, as flax's head conv does)."""
    dt = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.02, a.shape)).astype(dt),
        _flax_params(seed))
    tdt = torch.float64 if f64 else torch.float32
    tm = tdet.Detector(dtype=tdt, param_dtype=tdt)
    tm.load_state_dict(tdet.params_from_flax(params))
    return jdet.Detector(dtype=jnp.float64 if f64 else jnp.float32), np_tree(params), tm


def test_db_loss_and_grads_match_jax():
    imgs, prob_t, band, thr_t = _targets()
    # float32: the loss
    jm, params, tm = _small_pair()
    want = jdet.db_loss(params, jm, imgs, prob_t, band, thr_t)
    with torch.no_grad():
        got = tdet.db_loss(tm, torch.from_numpy(imgs).permute(0, 3, 1, 2),
                           *(torch.from_numpy(a) for a in (prob_t, band, thr_t)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # float64: every parameter's gradient
    with jax.enable_x64(True):
        b64 = [a.astype(np.float64) for a in (imgs, prob_t, band, thr_t)]
        jm, params, tm = _small_pair(f64=True)
        want, jg = jax.jit(jax.value_and_grad(jdet.db_loss),
                           static_argnums=1)(params, jm, *b64)
        got = tdet.db_loss(tm, torch.from_numpy(b64[0]).permute(0, 3, 1, 2),
                           *(torch.from_numpy(a) for a in b64[1:]))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
        jg = dict(leaves(np_tree(jg)))
        grads = {k: p.grad for k, p in tm.named_parameters()}
        for path, g in leaves(tdet.params_to_flax(grads)):
            w = jg[path]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(), err_msg=path)


def test_det_train_step_matches_jax():
    """3 steps of make_det_train_step against train_detector's step
    function (value_and_grad of db_loss, adamw update), in float64."""
    sched = (0.0, 1e-3, 2, 10)
    with jax.enable_x64(True):
        jm, params, tm = _small_pair(f64=True)
        tx = optax.adamw(optax.warmup_cosine_decay_schedule(*sched))

        @jax.jit
        def jstep(params, opt_state, imgs, prob_t, band, thr_t):
            loss, grads = jax.value_and_grad(jdet.db_loss)(
                params, jm, imgs, prob_t, band, thr_t)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        tstep = tdet.make_det_train_step(tm, optim.adamw(
            tm.parameters(), optim.warmup_cosine_decay_schedule(*sched)))
        jp = jax.tree.map(jnp.asarray, params)
        state = tx.init(jp)
        rng = np.random.default_rng(4)
        for _ in range(3):
            b = [a.astype(np.float64) for a in jdet.make_det_batch(rng, 2, 64)]
            jp, state, jloss = jstep(jp, state, *b)
            tloss = tstep(*b)
            assert tloss.ndim == 0 and not tloss.requires_grad
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-7)
        want = dict(leaves(np_tree(jp)))
    for path, got in leaves(tdet.params_to_flax(tm.state_dict())):
        np.testing.assert_allclose(got, want[path].astype(np.float32), rtol=0,
                                   atol=2.5e-7, err_msg=path)


@pytest.mark.parametrize("size", [64, 128])
def test_make_det_batch_equals_jax(size):
    want = jdet.make_det_batch(np.random.default_rng(3), batch=3, size=size)
    got = tdet.make_det_batch(np.random.default_rng(3), batch=3, size=size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tdet.shrink_box(10.0, 20.0, 110.0, 30.0) == jdet.shrink_box(
        10.0, 20.0, 110.0, 30.0)


def test_det_params_to_flax_inverts_params_from_flax():
    shipped = tdet.load_det_params()
    back = tdet.params_to_flax(tdet.params_from_flax(shipped))
    assert_trees_equal(back, shipped)
    assert keys(back) == keys(_flax_params())  # flax's creation order


def test_det_checkpoints_cross_both_ways(tmp_path):
    tree = tdet.params_to_flax(tdet.init_params(
        tdet.Detector(dtype=torch.float32), torch.Generator().manual_seed(2)
    ).state_dict())
    path = str(tmp_path / "port.msgpack")
    tdet.save_det_params(tree, path)
    jparams = jdet.load_det_params(path, size=64)
    x = np.random.default_rng(5).random((2, 64, 64, 1)).astype(np.float32)
    want = np.asarray(jdet.Detector(dtype=jnp.float32).apply(
        {"params": jparams}, jnp.asarray(x)))
    tm = tdet.detector_from_flax(tdet.load_det_params(path), dtype=torch.float32,
                                 device="cpu")
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    fpath = str(tmp_path / "flax.msgpack")
    jdet.save_det_params(jparams, fpath)
    assert open(fpath, "rb").read() == open(path, "rb").read()
    assert_trees_equal(tdet.load_det_params(fpath), tree)
    assert open(path, "rb").read() == serialization.to_bytes(jparams)


def test_det_init_matches_flax_init():
    want = _flax_params(0)
    got = tdet.params_to_flax(tdet.init_params(
        tdet.Detector(dtype=torch.float32), torch.Generator().manual_seed(0)
    ).state_dict())
    assert keys(got) == keys(want)
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("bias"):
            assert not g.any(), path
        elif path.endswith("scale"):
            assert (g == 1).all(), path
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, path
            assert np.abs(g).max() <= np.abs(w).max() * 1.05, path


def test_train_detector_cpu_from_shipped_weights(tmp_path):
    """``train_detector`` end to end on the CPU at 64² (the smallest run the
    schedule allows: 51 steps), warm-started from the shipped weights: a
    checkpoint that JAX's load_det_params reads and that holds the returned
    model's parameters, finite losses, the run's timings."""
    out = str(tmp_path / "det.msgpack")
    run = tdet.train_detector(steps=51, batch=2, size=64, out=out, log_every=25,
                              init_from=tdet.DET_WEIGHTS_PATH, device="cpu")
    assert len(run["losses"]) == 51 and np.isfinite(run["losses"]).all()
    assert run["data_s"] > 0 and run["device_step_s"] is None
    jparams = jdet.load_det_params(out, size=64)
    assert_trees_equal(np_tree(jparams), tdet.load_det_params(out))
    assert_trees_equal(tdet.params_to_flax(run["model"].state_dict()),
                       tdet.load_det_params(out))


def test_train_detector_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdet.train_detector(steps=51, device="cuda")
