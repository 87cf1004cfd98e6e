"""CTC text-line recognizer — counterpart of synapta_tpu/models/recognizer.py.

A conv stack collapses a (B, 1, 32, W) line image into W/4 frames, two
self-attention blocks contextualize them, and a float32 head emits per-frame
class logits. Input is NCHW float in [0, 1]; output (B, W // 4, classes).

Parity with the flax module (each pinned by a test):
  - flax ``SAME`` on a stride-2 conv pads (0, 1) on an even axis, so every
    conv pads explicitly (``_same_pad``) and runs with padding=0;
  - LayerNorm eps 1e-6 and flax's fast variance max(0, E[x²] - E[x]²);
    ``nn.gelu`` is the tanh approximation;
  - attention scales the query by the reciprocal of sqrt(head_dim) cast to
    the compute dtype, written as explicit matmul + softmax;
  - height collapses by a mean; the head runs in float32 on the trunk output.

Rounding. In a lower compute dtype (bfloat16 in production) the model rounds
where XLA rounds flax's model on the CPU (its compiled HLO, read op by op
with ``scripts/bf16_op_parity.py``): after every matmul and conv, again
after the bias add, and after every elementwise op of a chain (GELU with
its constants in the compute dtype, the softmax's difference and quotient).
Three sums stay float32 where XLA keeps them unrounded: each residual sum
(and the first block's input, the mean plus ``pos_embed``) as LayerNorm
reads it, while the residual path reads it rounded; and the softmax's
exponentials as its denominator sums them. ``_wide`` marks those sums;
in float32 it and every rounding are no-ops.

The convs and matmuls go to cuDNN/cuBLAS in the compute dtype, as the JAX
package leaves them to XLA. ``param_dtype`` is the dtype the parameters are
stored in: float32 for training, as flax keeps them, each weight cast to
``dtype`` where flax casts it (conv and Dense kernels and biases,
``pos_embed``). ``recognizer_from_flax`` stores those in the compute dtype
for inference, which gives the same values. LayerNorm's scale and bias and
the head stay float32 in every model, as flax reads them. ``init_params``
draws a fresh model with flax's initialisers.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from synapta_tpu_torch.models.charset import NUM_CLASSES


def _same_pad(n: int, stride: int, k: int = 3):
    """(low, high) padding of flax/XLA 'SAME' along an axis of length n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in its own dtype if that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm as XLA computes it: mean and fast variance
    max(0, E[x²] - E[x]²) in float32, the scale folded into the reciprocal
    standard deviation, the result rounded to ``dtype``. ``x`` may be the
    float32 sum that XLA hands LayerNorm unrounded."""
    xf = _wide(x)
    inv = 1.0 / x.shape[-1]
    mean = xf.sum(-1, keepdim=True) * inv
    var = ((xf * xf).sum(-1, keepdim=True) * inv - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.to(xf.dtype)
    return ((xf - mean) * mul + ln.bias.to(xf.dtype)).to(dtype)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's Dense in x's dtype: the product rounded to it, then the bias
    (cast to it) added and the sum rounded again, as XLA computes it. A
    layer whose kernel is cut over the 'model' axis (``model_axis``, set by
    parallel/mesh.py::shard_params) computes its rank's output columns and
    gathers all ranks' before the same bias add."""
    axis = getattr(lin, "model_axis", None)
    if axis is not None:
        y = axis.column(lambda h: F.linear(h, lin.weight.to(h.dtype)), x, -1)
    else:
        y = F.linear(x, lin.weight.to(x.dtype))
    return y + lin.bias.to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A padding-free conv in x's dtype, its bias added after the product
    is rounded, as ``_dense``; cut over the 'model' axis as ``_dense`` is
    (output channels gathered)."""
    axis = getattr(conv, "model_axis", None)
    if axis is not None:
        y = axis.column(
            lambda h: F.conv2d(h, conv.weight.to(h.dtype), None, conv.stride),
            x, 1)
    else:
        y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride)
    return y + conv.bias.to(x.dtype).view(1, -1, 1, 1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op by op in x's dtype, each result
    rounded to it and both constants cast to it, as XLA computes it."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """flax's dot-product attention on (B, heads, T, hd) in q's dtype: the
    query times the float32 reciprocal of ``scale`` (the square root of hd,
    cast to q's dtype), scores, softmax, weighted values. The softmax rounds
    the difference to the row maximum and the quotient, and sums the
    exponentials unrounded, as XLA computes ``jax.nn.softmax``."""
    dtype = q.dtype
    q = (_wide(q) * (1.0 / _wide(scale))).to(dtype)
    s = q @ k.transpose(-1, -2)
    e = torch.exp(_wide(s - s.amax(dim=-1, keepdim=True)))
    w = e.to(dtype) / e.sum(dim=-1, keepdim=True).to(dtype)
    return w @ v


# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps its variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal truncated to two standard
    deviations, variance 1/fan_in. fan_in is w[0].numel(): in × kh × kw of
    an OIHW conv, in of a Linear, and D of every attention projection (flax's
    (D, heads, hd) and (heads, hd, D) kernels flatten to a fan-in of D)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers on every conv, Linear and LayerNorm in
    ``module``: lecun_normal kernels, zero biases, LayerNorm ones and
    zeros (torch's defaults train another model: kaiming-uniform kernels,
    non-zero uniform biases)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 2,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(dtype=param_dtype)
        self.heads = heads
        self.dtype = dtype
        # LayerNorm's scale and bias stay float32, as flax keeps and reads them
        self.ln0 = nn.LayerNorm(dim, eps=1e-6, dtype=torch.float32)
        self.query = nn.Linear(dim, dim, **kw)
        self.key = nn.Linear(dim, dim, **kw)
        self.value = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, dtype=torch.float32)
        self.fc0 = nn.Linear(dim, dim * mlp_ratio, **kw)
        self.fc1 = nn.Linear(dim * mlp_ratio, dim, **kw)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """flax's MultiHeadDotProductAttention(h, h) in h's dtype."""
        B, T, D = h.shape
        hd = D // self.heads

        def split(t):  # (B, T, D) -> (B, heads, T, hd)
            return t.view(B, T, self.heads, hd).transpose(1, 2)

        scale = torch.tensor(math.sqrt(hd), dtype=h.dtype, device=h.device)
        a = attention_core(split(_dense(self.query, h)),
                           split(_dense(self.key, h)),
                           split(_dense(self.value, h)), scale)
        return _dense(self.out, a.transpose(1, 2).reshape(B, T, D))

    def forward(self, s: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        """``s`` is the block's input as a float32 sum (or already in the
        compute dtype): LayerNorm reads it whole, the residual path rounded
        to the compute dtype. Returns the block's output sum the same way."""
        dtype = self.dtype
        a = self.attend(_layer_norm(self.ln0, s, dtype))
        x = _wide(s.to(dtype)) + _wide(a)
        h = _dense(self.fc0, _layer_norm(self.ln1, x, dtype))
        h = _dense(self.fc1, gelu_tanh(h))
        return _wide(x.to(dtype)) + _wide(h)


class Recognizer(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES, dim: int = 192,
                 blocks: int = 2, seq_len: int = 96,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(dtype=param_dtype)
        self.dtype = dtype
        self.strides = [(1, 1), (2, 2), (2, 2), (2, 1), (2, 1)]
        chans = [1, 32, 64, 128, dim, dim]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=s, **kw)
            for i, s in enumerate(self.strides)
        )
        self.pos_embed = nn.Parameter(torch.zeros(1, seq_len, dim, **kw))
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, dtype=dtype, param_dtype=param_dtype)
            for _ in range(blocks)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-6, dtype=torch.float32)
        self.head = nn.Linear(dim, num_classes, dtype=torch.float32)

    def collapse(self, x: torch.Tensor) -> torch.Tensor:
        """(B, dim, H, T) conv output -> (B, T, dim) float32 sum of its
        height mean (rounded) and ``pos_embed`` (cast to the compute dtype)."""
        m = (_wide(x).sum(dim=2) * (1.0 / x.shape[2])).to(self.dtype)
        return _wide(m.transpose(1, 2)) + _wide(self.pos_embed.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 1, 32, W)
        x = x.to(self.dtype)
        for conv, (sh, sw) in zip(self.convs, self.strides):
            ph = _same_pad(x.shape[2], sh)
            pw = _same_pad(x.shape[3], sw)
            x = F.relu(_conv(conv, F.pad(x, (*pw, *ph))))
        s = self.collapse(x)
        for blk in self.blocks:
            s = blk(s)
        h = _layer_norm(self.norm, s, self.dtype)
        return _dense(self.head, h.to(torch.float32))


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) -> this module's state_dict
    (float32). Conv HWIO -> OIHW, Dense (in, out) -> Linear (out, in),
    attention query/key/value (D, heads, hd) -> (heads*hd, D) and out
    (heads, hd, D) -> (D, heads*hd)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"Conv_{i}" in tree:
        c = tree[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = t(np.transpose(c["kernel"], (3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = t(c["bias"])
        i += 1
    sd["pos_embed"] = t(tree["pos_embed"])
    j = 0
    while f"EncoderBlock_{j}" in tree:
        blk = tree[f"EncoderBlock_{j}"]
        pre = f"blocks.{j}."
        for src, dst in (("LayerNorm_0", "ln0"), ("LayerNorm_1", "ln1")):
            sd[pre + dst + ".weight"] = t(blk[src]["scale"])
            sd[pre + dst + ".bias"] = t(blk[src]["bias"])
        att = blk["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            k = np.asarray(att[name]["kernel"])  # (D, heads, hd)
            sd[pre + name + ".weight"] = t(k.reshape(k.shape[0], -1).T)
            sd[pre + name + ".bias"] = t(np.asarray(att[name]["bias"]).reshape(-1))
        k = np.asarray(att["out"]["kernel"])  # (heads, hd, D)
        sd[pre + "out.weight"] = t(k.reshape(-1, k.shape[-1]).T)
        sd[pre + "out.bias"] = t(att["out"]["bias"])
        for src, dst in (("Dense_0", "fc0"), ("Dense_1", "fc1")):
            sd[pre + dst + ".weight"] = t(np.asarray(blk[src]["kernel"]).T)
            sd[pre + dst + ".bias"] = t(blk[src]["bias"])
        j += 1
    sd["norm.weight"] = t(tree["LayerNorm_0"]["scale"])
    sd["norm.bias"] = t(tree["LayerNorm_0"]["bias"])
    sd["head.weight"] = t(np.asarray(tree["Dense_0"]["kernel"]).T)
    sd["head.bias"] = t(tree["Dense_0"]["bias"])
    return sd


def params_to_flax(sd, heads: int = 4) -> Dict:
    """The exact inverse of ``params_from_flax``: a Recognizer state_dict ->
    the flax parameter tree (float32 numpy leaves), keys in flax's creation
    order, attention kernels and biases in flax's (D, heads, hd),
    (heads, hd) and (heads, hd, D) layouts."""
    def a(key):
        return np.ascontiguousarray(
            sd[key].detach().to("cpu", torch.float32).numpy())

    tree: Dict = {}
    i = 0
    while f"convs.{i}.weight" in sd:
        tree[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(a(f"convs.{i}.weight").transpose(2, 3, 1, 0)),
            "bias": a(f"convs.{i}.bias"),
        }
        i += 1
    tree["pos_embed"] = a("pos_embed")
    j = 0
    while f"blocks.{j}.ln0.weight" in sd:
        pre = f"blocks.{j}."

        def ln(name):
            return {"scale": a(pre + name + ".weight"), "bias": a(pre + name + ".bias")}

        def dense(name):
            return {"kernel": np.ascontiguousarray(a(pre + name + ".weight").T),
                    "bias": a(pre + name + ".bias")}

        att = {}
        for name in ("query", "key", "value"):
            w = a(pre + name + ".weight")  # (heads*hd, D)
            att[name] = {
                "kernel": np.ascontiguousarray(w.T.reshape(w.shape[1], heads, -1)),
                "bias": a(pre + name + ".bias").reshape(heads, -1),
            }
        w = a(pre + "out.weight")  # (D, heads*hd)
        att["out"] = {"kernel": np.ascontiguousarray(w.T.reshape(heads, -1, w.shape[0])),
                      "bias": a(pre + "out.bias")}
        tree[f"EncoderBlock_{j}"] = {
            "LayerNorm_0": ln("ln0"), "MultiHeadDotProductAttention_0": att,
            "LayerNorm_1": ln("ln1"), "Dense_0": dense("fc0"), "Dense_1": dense("fc1"),
        }
        j += 1
    tree["LayerNorm_0"] = {"scale": a("norm.weight"), "bias": a("norm.bias")}
    tree["Dense_0"] = {"kernel": np.ascontiguousarray(a("head.weight").T),
                       "bias": a("head.bias")}
    return tree


def kernel_modules(model: Recognizer) -> Dict[tuple, nn.Module]:
    """flax path of every conv and Dense kernel -> the torch layer that
    holds it (``weight`` (out, ...): dim 0 is flax's last dim)."""
    out: Dict[tuple, nn.Module] = {}
    for i, conv in enumerate(model.convs):
        out[(f"Conv_{i}", "kernel")] = conv
    for j, blk in enumerate(model.blocks):
        pre = f"EncoderBlock_{j}"
        for name in ("query", "key", "value", "out"):
            out[(pre, "MultiHeadDotProductAttention_0", name, "kernel")] = (
                getattr(blk, name))
        out[(pre, "Dense_0", "kernel")] = blk.fc0
        out[(pre, "Dense_1", "kernel")] = blk.fc1
    out[("Dense_0", "kernel")] = model.head
    return out


def init_params(model: Recognizer, generator: torch.Generator) -> Recognizer:
    """flax's initialisers on ``model`` in place: lecun_normal kernels, zero
    biases, LayerNorm ones and zeros, ``pos_embed`` ~ N(0, 0.02)."""
    flax_init_(model, generator)
    nn.init.normal_(model.pos_embed, 0.0, 0.02, generator=generator)
    return model


def recognizer_from_flax(tree, dtype: torch.dtype = torch.bfloat16,
                         device="cuda") -> Recognizer:
    """Build a Recognizer whose shape follows the flax tree, load it with its
    conv and Dense parameters and ``pos_embed`` stored in ``dtype``
    (inference), and put it in eval mode on ``device``."""
    sd = params_from_flax(tree)
    _, seq_len, dim = sd["pos_embed"].shape
    blocks = sum(1 for k in tree if k.startswith("EncoderBlock_"))
    model = Recognizer(num_classes=sd["head.weight"].shape[0], dim=dim,
                       blocks=blocks, seq_len=seq_len, dtype=dtype,
                       param_dtype=dtype)
    model.load_state_dict(sd)
    return model.to(device).eval()
