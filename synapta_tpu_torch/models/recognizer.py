"""CTC text-line recognizer — counterpart of synapta_tpu/models/recognizer.py.

A conv stack collapses a (B, 1, 32, W) line image into W/4 frames, two
self-attention blocks contextualize them, and a float32 head emits per-frame
class logits. Input is NCHW float in [0, 1]; output (B, W // 4, classes).

Parity with the flax module (each pinned by a test):
  - flax ``SAME`` on a stride-2 conv pads (0, 1) on an even axis, so every
    conv pads explicitly (``_same_pad``) and runs with padding=0;
  - LayerNorm eps is 1e-6; ``nn.gelu`` is the tanh approximation;
  - attention divides the query by sqrt(head_dim) cast to the compute dtype,
    written as explicit matmul + softmax;
  - height collapses by a mean; the head runs in float32 on the trunk output.

The convs and matmuls go to cuDNN/cuBLAS, as the JAX package leaves them to
XLA. ``dtype`` is the compute dtype of the trunk (bfloat16 in production);
parameters are stored in it, the head stays float32.
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


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(dtype=dtype)
        self.heads = heads
        self.dtype = dtype
        self.ln0 = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.query = nn.Linear(dim, dim, **kw)
        self.key = nn.Linear(dim, dim, **kw)
        self.value = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)
        self.ln1 = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.fc0 = nn.Linear(dim, dim * mlp_ratio, **kw)
        self.fc1 = nn.Linear(dim * mlp_ratio, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        B, T, D = x.shape
        hd = D // self.heads
        h = self.ln0(x)

        def split(t):  # (B, T, D) -> (B, heads, T, hd)
            return t.view(B, T, self.heads, hd).transpose(1, 2)

        scale = torch.tensor(math.sqrt(hd), dtype=self.dtype, device=x.device)
        q = split(self.query(h)) / scale
        k = split(self.key(h))
        v = split(self.value(h))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        a = (w @ v).transpose(1, 2).reshape(B, T, D)
        x = x + self.out(a)
        h = self.fc1(F.gelu(self.fc0(self.ln1(x)), approximate="tanh"))
        return x + h


class Recognizer(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES, dim: int = 192,
                 blocks: int = 2, seq_len: int = 96,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype)
        self.dtype = dtype
        self.strides = [(1, 1), (2, 2), (2, 2), (2, 1), (2, 1)]
        chans = [1, 32, 64, 128, dim, dim]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=s, **kw)
            for i, s in enumerate(self.strides)
        )
        self.pos_embed = nn.Parameter(torch.zeros(1, seq_len, dim, **kw))
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, dtype=dtype) for _ in range(blocks)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-6, **kw)
        self.head = nn.Linear(dim, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 1, 32, W)
        x = x.to(self.dtype)
        for conv, (sh, sw) in zip(self.convs, self.strides):
            ph = _same_pad(x.shape[2], sh)
            pw = _same_pad(x.shape[3], sw)
            x = F.relu(conv(F.pad(x, (*pw, *ph))))
        x = x.mean(dim=2).transpose(1, 2)  # collapse height -> (B, T, dim)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return self.head(x.to(torch.float32))


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


def recognizer_from_flax(tree, dtype: torch.dtype = torch.bfloat16,
                         device="cpu") -> Recognizer:
    """Build a Recognizer whose shape follows the flax tree, load it, and
    put it in eval mode on ``device``."""
    sd = params_from_flax(tree)
    _, seq_len, dim = sd["pos_embed"].shape
    blocks = sum(1 for k in tree if k.startswith("EncoderBlock_"))
    model = Recognizer(num_classes=sd["head.weight"].shape[0], dim=dim,
                       blocks=blocks, seq_len=seq_len, dtype=dtype)
    model.load_state_dict(sd)
    return model.to(device).eval()
