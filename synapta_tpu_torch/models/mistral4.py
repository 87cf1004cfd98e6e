"""Mistral-Small-4-119B-2603 on one GPU: the text model (multi-head latent
attention, a mixture of experts on every layer) and a Pixtral-style vision
encoder with its projector, bf16 weights and activations, float32 softmax,
norms and router.

Published configuration (``Mistral4Config`` defaults): 36 layers, hidden
4,096, RMSNorm eps 1e-6, SiLU; MLA with ``q_lora_rank`` 1,024,
``kv_lora_rank`` 256, 32 heads, qk nope/rope 64/64, v 128; yarn RoPE,
interleaved (theta 1e4, factor 128, original 8,192, mscale = mscale_all_dim
= 1, beta fast/slow 32/1) and the llama-4 query scale (beta 0.1); 128
routed experts of width 2,048, top-4 renormalised, one shared expert;
vocabulary 131,072, untied head.

Assumed where the configuration is silent (``VisionConfig``, the router):
the router scores are a softmax over the 128 logits, then the top 4,
renormalised; the softmax scale is DeepSeek-V3's, qk_head_dim^-1/2 times
the yarn mscale (0.1 ln(factor) + 1) squared; the vision tower is the
Mistral Small 3.x Pixtral encoder (hidden 1,024, 24 layers, 16 heads of
64, gated-SiLU MLP 4,096, patch 14, 2D RoPE theta 1e4) with a 2x2 patch
merge and a two-layer GELU projector to the text width.

An expert layer is told which experts it ``held``: it routes over all of
them and computes its own experts' share for the tokens routed to them
(one grouped matrix product over the held experts), plus the shared
expert. In an expert-parallel deployment the other ranks add theirs; on
one card nothing stands in for them.

MLA runs two ways. Prefill (``attn_prefill``) expands the latent through
``kv_b`` into per-head keys and values and calls
``scaled_dot_product_attention``. Decode (``attn_decode``) keeps only the
latent cache, c_kv (256) and the roped k (64) a token a layer: ``kv_b``'s
key half is folded into the query and its value half applied after
attention over the latent.

Weights are made on the device from ``(seed, scope, name)`` one tensor at a
time (``param``), so that any layer can be rebuilt alone: ``randn`` in
float32 from a generator seeded by a hash of the three, scaled, rounded to
the model's dtype. ``tests/mistral4_plain.py`` rebuilds them the same way.
"""
from __future__ import annotations

import contextlib
import hashlib
import math
from dataclasses import dataclass, field, fields
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from synapta_tpu_torch.utils.profiler import TIMERS


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    rope_theta: float = 10000.0
    spatial_merge_size: int = 2
    rms_norm_eps: float = 1e-5


@dataclass(frozen=True)
class Mistral4Config:
    vocab_size: int = 131072
    hidden_size: int = 4096
    num_hidden_layers: int = 36
    num_attention_heads: int = 32
    q_lora_rank: int = 1024
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe_intermediate_size: int = 2048
    n_routed_experts: int = 128
    num_experts_per_tok: int = 4
    n_shared_experts: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 128.0
    original_max_position_embeddings: int = 8192
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0
    llama_4_scaling_beta: float = 0.1
    vision: VisionConfig = field(default_factory=VisionConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "Mistral4Config":
        """Fields by name; ``vision`` a dict of ``VisionConfig`` fields."""
        names = {f.name for f in fields(cls)}
        kw = {k: v for k, v in d.items() if k in names and k != "vision"}
        if "vision" in d:
            kw["vision"] = VisionConfig(**d["vision"])
        return cls(**kw)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# ------------------------------------------------------------- weights


def param_key(seed: int, scope: str, name: str) -> int:
    h = hashlib.blake2b(f"{int(seed)}/{scope}/{name}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def param(seed: int, scope: str, name: str, shape: Sequence[int], kind: str,
          device, dtype) -> torch.Tensor:
    """One weight: float32 ``randn`` from its own generator, times
    1/sqrt(fan in) for a matrix (``kind`` "linear": (out, in); "conv":
    (out, in, kh, kw)), 1 for an embedding, or 1 + 0.1 randn for a norm's
    scale; rounded to bf16, the precision the weights are published in, and
    held in ``dtype``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(param_key(seed, scope, name))
    x = torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)
    if kind == "norm":
        x = 1.0 + 0.1 * x
    elif kind == "linear":
        x = x * (1.0 / math.sqrt(shape[-1]))
    elif kind == "conv":
        x = x * (1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
    elif kind != "embed":
        raise ValueError(kind)
    return x.to(torch.bfloat16).to(dtype)


# ------------------------------------------------------------- positions


def yarn_inv_freq(cfg: Mistral4Config) -> torch.Tensor:
    """The yarn-interpolated inverse frequencies of the rope half (float64),
    as DeepSeek-V3 computes them (floor/ceil of the correction range)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig, factor = cfg.original_max_position_embeddings, cfg.rope_factor

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr_dim(cfg.beta_fast)), 0)
    high = min(math.ceil(corr_dim(cfg.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    extra, inter = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # share of the extrapolated frequency
    return inter * (1.0 - keep) + extra * keep


def yarn_mscale(scale: float, m: float) -> float:
    return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0


def softmax_scale(cfg: Mistral4Config) -> float:
    s = cfg.qk_head_dim ** -0.5
    if cfg.mscale_all_dim:
        s *= yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) ** 2
    return s


def rope_attention_factor(cfg: Mistral4Config) -> float:
    return (yarn_mscale(cfg.rope_factor, cfg.mscale)
            / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))


def llama4_scale(cfg: Mistral4Config, pos: torch.Tensor) -> torch.Tensor:
    """1 + beta ln(1 + floor(pos / original)) (float32, pos's shape)."""
    n = torch.div(pos, cfg.original_max_position_embeddings, rounding_mode="floor")
    return 1.0 + cfg.llama_4_scaling_beta * torch.log1p(n.to(torch.float32))


def rope_rotation(cfg: Mistral4Config, pos: torch.Tensor, inv_freq: torch.Tensor):
    """The rope half's rotation at positions ``pos`` (T,): complex64 (T,
    rope/2), angle pos x frequency (computed in float64) and modulus the
    yarn attention factor."""
    ang = pos.to(torch.float64)[:, None] * inv_freq.to(pos.device)[None, :]
    f = rope_attention_factor(cfg)
    return torch.complex((torch.cos(ang) * f).to(torch.float32),
                         (torch.sin(ang) * f).to(torch.float32))


def rope_interleaved(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i+1]) of the last dim by ``rot``'s i-th
    entry (a complex product in float32); ``rot`` (T, d/2) broadcasts over
    the dims between. -> float32, ``x``'s shape."""
    xc = torch.view_as_complex(x.to(torch.float32).reshape(*x.shape[:-1], -1, 2))
    while rot.dim() < xc.dim():
        rot = rot.unsqueeze(1)
    return torch.view_as_real(xc * rot).flatten(-2)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm (float32 inside), the result in ``x``'s dtype."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


# ------------------------------------------------------------- the model


class Layer:
    """One decoder layer's weights. The attention's: ``qkv_a`` (q_a and
    kv_a, which read the same input), ``q_b``, ``kv_b`` (the expanded
    path), ``w_q`` (H, nope + rope, kvl + rope): per head kv_b's key half
    beside an identity on the rope dims, so that one product turns a query
    into its absorbed form [q_nope W_uk | q_pe], ``w_uv_t`` (H, kvl, v),
    kv_b's value half, and ``o``. The experts': the held experts and then
    the shared one stacked for the grouped product, ``w13`` (G + 1, 2F, D)
    and ``w2`` (G + 1, D, F)."""

    def __init__(self, cfg: Mistral4Config, seed: int, l: int, held: List[int],
                 device, dtype):
        D, H = cfg.hidden_size, cfg.num_attention_heads
        nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        ql, kvl, Fw = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.moe_intermediate_size
        s = f"L{l}"

        def p(name, shape, kind="linear"):
            return param(seed, s, name, shape, kind, device, dtype)

        self.attn_norm = p("attn_norm", (D,), "norm")
        self.qkv_a = torch.cat([p("q_a", (ql, D)), p("kv_a", (kvl + rope, D))])
        self.q_a_norm = p("q_a_norm", (ql,), "norm")
        self.q_b = p("q_b", (H * (nope + rope), ql))
        self.kv_a_norm = p("kv_a_norm", (kvl,), "norm")
        self.kv_b = p("kv_b", (H * (nope + vd), kvl))
        per_head = self.kv_b.view(H, nope + vd, kvl)
        self.w_q = torch.zeros(H, nope + rope, kvl + rope, dtype=dtype, device=device)
        self.w_q[:, :nope, :kvl] = per_head[:, :nope]
        self.w_q[:, nope:, kvl:] = torch.eye(rope, dtype=dtype, device=device)
        self.w_uv_t = per_head[:, nope:].transpose(1, 2).contiguous()  # (H, kvl, v)
        self.o = p("o", (D, H * vd))
        self.mlp_norm = p("mlp_norm", (D,), "norm")
        self.router = param(seed, s, "router", (cfg.n_routed_experts, D), "linear",
                            device, torch.float32)
        S = Fw * cfg.n_shared_experts
        if S != Fw:
            raise ValueError("the shared experts are stacked as one expert of the held "
                             f"experts' width: {S} != {Fw}")
        names = [f"expert{e}" for e in held] + ["shared"]
        self.w13 = torch.stack([torch.cat([p(f"{n}.w1", (Fw, D)), p(f"{n}.w3", (Fw, D))])
                                for n in names])
        self.w2 = torch.stack([p(f"{n}.w2", (D, Fw)) for n in names])


class MoeCounts:
    """Per layer of one forward pass: the tokens each held expert takes
    (G,) on the device, and the ``moe`` spans' counts they are read into
    (``held_tokens``, ``experts``) once the step's copy has landed."""

    def __init__(self):
        self.rows: List[torch.Tensor] = []
        self.attrs: List[dict] = []


class Mistral4:
    """The text model and the vision encoder of one card, its weights built
    from ``seed`` on ``device``. ``held``: the routed experts this card
    computes (all of them when None).

    The latent cache ``kv`` (layers, slots, max len, kvl + rope) holds a
    token's normed c_kv and its roped k beside it."""

    def __init__(self, cfg: Mistral4Config, seed: int, device="cuda",
                 held: Optional[Sequence[int]] = None, dtype=torch.bfloat16):
        self.cfg, self.seed = cfg, int(seed)
        self.device, self.dtype = torch.device(device), dtype
        self.held = list(range(cfg.n_routed_experts)) if held is None else [int(e) for e in held]
        G = len(self.held)
        # routed expert -> its place in the stack; G + 1: not held here
        hm = torch.full((cfg.n_routed_experts,), G + 1, dtype=torch.long)
        hm[torch.tensor(self.held, dtype=torch.long)] = torch.arange(G)
        self.held_map = hm.to(self.device)
        self.groups = torch.arange(G + 1, device=self.device)
        D, V = cfg.hidden_size, cfg.vocab_size
        self.embed = param(seed, "G", "embed", (V, D), "embed", device, dtype)
        self.layers = [Layer(cfg, seed, l, self.held, device, dtype)
                       for l in range(cfg.num_hidden_layers)]
        self.final_norm = param(seed, "G", "final_norm", (D,), "norm", device, dtype)
        self.head = param(seed, "G", "head", (V, D), "linear", device, dtype)
        self.inv_freq = yarn_inv_freq(cfg).to(self.device)
        self.scale = softmax_scale(cfg)
        self.vision = VisionEncoder(cfg, seed, device, dtype)

    # ------------------------------------------------------------ pieces

    def positions(self, pos: torch.Tensor):
        """-> the rope rotation (T, rope/2) and the llama-4 query scale (T,)."""
        return rope_rotation(self.cfg, pos, self.inv_freq), llama4_scale(self.cfg, pos)

    def _q_latent(self, lw: Layer, h: torch.Tensor, rot):
        """-> q (T, H, nope + rope), its rope dims roped (no llama-4 scale),
        and the latent (T, kvl + rope): c_kv normed, k_pe roped."""
        cfg = self.cfg
        H, nope, rope = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
        a = F.linear(h, lw.qkv_a)
        q = F.linear(rms_norm(a[:, :ql], lw.q_a_norm, cfg.rms_norm_eps), lw.q_b)
        q = q.view(-1, H, nope + rope)
        q[..., nope:] = rope_interleaved(q[..., nope:], rot)
        lat = torch.empty(h.shape[0], kvl + rope, dtype=h.dtype, device=h.device)
        lat[:, :kvl] = rms_norm(a[:, ql:ql + kvl], lw.kv_a_norm, cfg.rms_norm_eps)
        lat[:, kvl:] = rope_interleaved(a[:, ql + kvl:], rot)
        return q, lat

    def attn_prefill(self, lw: Layer, h, rot, qscale, seg_lens: List[int]):
        """Expanded MLA over the packed sequences ``seg_lens`` (causal within
        each); -> (attention output (T, D), the latent (T, kvl + rope))."""
        cfg = self.cfg
        H, nope, vd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
        kvl = cfg.kv_lora_rank
        q, lat = self._q_latent(lw, h, rot)
        q.mul_(qscale.to(q.dtype)[:, None, None])
        kv = F.linear(lat[:, :kvl], lw.kv_b).view(-1, H, nope + vd)
        k = torch.cat([kv[..., :nope], lat[:, None, kvl:].expand(-1, H, -1)], dim=-1)
        v = kv[..., nope:]
        outs, at = [], 0
        for n in seg_lens:
            qi, ki, vi = (t[at:at + n].transpose(0, 1)[None] for t in (q, k, v))
            o = F.scaled_dot_product_attention(qi, ki, vi, is_causal=True, scale=self.scale)
            outs.append(o[0].transpose(0, 1).reshape(n, H * vd))
            at += n
        o = torch.cat(outs) if len(outs) > 1 else outs[0]
        return F.linear(o, lw.o), lat

    def attn_decode(self, lw: Layer, h, rot, rowscale, kv, bias):
        """Absorbed MLA for one new token of each of B sequences against the
        latent cache ``kv`` (slots, max len, kvl + rope), whose slots 0..B-1
        hold them; the new tokens' latents are written at ``self._rows``
        first. ``bias`` (B, L): 0 where a position is attended, -inf
        elsewhere; ``rowscale`` (B,): the softmax scale times the llama-4
        query scale. -> attention output (B, D)."""
        kvl = self.cfg.kv_lora_rank
        B = h.shape[0]
        q, lat = self._q_latent(lw, h, rot)
        kv.view(-1, kv.shape[-1]).index_copy_(0, self._rows, lat)
        # [q_nope W_uk | q_pe] for each head: (H, B, kvl + rope)
        qa = torch.bmm(q.transpose(0, 1), lw.w_q)
        c = kv[:B, :bias.shape[1]]
        s = torch.bmm(qa.transpose(0, 1), c.transpose(1, 2))                # (B, H, L)
        p = torch.softmax(torch.addcmul(bias[:, None, :], s, rowscale[:, None, None]),
                          dim=-1).to(self.dtype)
        ctx = torch.bmm(p, c[..., :kvl])                                    # (B, H, kvl)
        o = torch.bmm(ctx.transpose(0, 1), lw.w_uv_t)                       # (H, B, v)
        return F.linear(o.transpose(0, 1).reshape(B, -1), lw.o)

    def moe(self, lw: Layer, x: torch.Tensor, counts: Optional[MoeCounts] = None,
            tap: Optional[list] = None, tap_rows: Optional[torch.Tensor] = None,
            valid: Optional[torch.Tensor] = None, span: bool = True) -> torch.Tensor:
        """The held experts' share for the tokens routed to them plus the
        shared expert, of normed ``x`` (T, D), in float32. ``valid`` (T,)
        marks the rows that are tokens (padding rows go to no routed
        expert); ``tap`` gets each call's chosen experts (of ``tap_rows``,
        or all rows); ``span`` records a ``moe`` span (off inside a
        captured decode step)."""
        with (TIMERS.stage("moe") if span else contextlib.nullcontext({})) as attrs:
            out, n = self._moe(lw, x, tap, tap_rows, valid)
            if counts is not None:
                counts.rows.append(n)
                counts.attrs.append(attrs)
        return out

    def _moe(self, lw, x, tap, tap_rows, valid):
        """One grouped product over the held experts and the shared one
        (group G, which every row takes with weight 1): the assignments
        sorted by group, the rows of routed experts held elsewhere last,
        where the grouped product leaves them unwritten."""
        cfg = self.cfg
        k, G, Fw = cfg.num_experts_per_tok, len(self.held), cfg.moe_intermediate_size
        T = x.shape[0]
        logits = F.linear(x.to(torch.float32), lw.router)
        top, idx = logits.topk(k, dim=-1, sorted=False)
        if cfg.norm_topk_prob:  # the softmax over all, renormalised over the top k
            w = torch.softmax(top, dim=-1)
        else:
            w = torch.softmax(logits, dim=-1).gather(1, idx)
        if cfg.routed_scaling_factor != 1:
            w = w * cfg.routed_scaling_factor
        if tap is not None:
            tap.append(idx if tap_rows is None else idx[tap_rows])
        loc = self.held_map[idx]                                   # (T, k)
        if valid is not None:
            loc = torch.where(valid[:, None], loc, G + 1)
        loc = F.pad(loc, (0, 1), value=G).flatten()                # (T (k + 1),)
        w = F.pad(w, (0, 1), value=1.0).flatten()
        srt, order = torch.sort(loc, stable=True)
        n = (loc[:, None] == self.groups).sum(0)                   # (G + 1,)
        offs = torch.cumsum(n, 0, dtype=torch.int32)
        xs = x[torch.div(order, k + 1, rounding_mode="floor")]
        h13 = torch._grouped_mm(xs, lw.w13.transpose(1, 2), offs=offs)
        y = torch._grouped_mm(F.silu(h13[:, :Fw]) * h13[:, Fw:], lw.w2.transpose(1, 2),
                              offs=offs)
        y = torch.where((srt <= G)[:, None], y * w[order][:, None], 0.0)
        back = torch.empty_like(y).index_copy_(0, order, y)
        return back.view(T, k + 1, -1).sum(1), n[:G]

    # ------------------------------------------------------------ passes

    def embed_tokens(self, ids: torch.Tensor, image_rows: Optional[torch.Tensor] = None,
                     image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed[ids]
        if image_rows is not None and image_rows.numel():
            x = x.index_copy(0, image_rows, image_embeds.to(x.dtype))
        return x

    def prefill(self, x: torch.Tensor, pos: torch.Tensor, seg_lens: List[int],
                rows: torch.Tensor, kv, counts=None, tap=None, tap_rows=None) -> torch.Tensor:
        """Packed sequences' embeddings ``x`` (T, D) at positions ``pos``
        through every layer, each layer's latents written to the cache at
        flat ``rows``; ``kv`` (layers, slots, max len, kvl + rope). -> the
        final hidden states (T, D), not normed."""
        rot, qscale = self.positions(pos)
        eps = self.cfg.rms_norm_eps
        for l, lw in enumerate(self.layers):
            a, lat = self.attn_prefill(lw, rms_norm(x, lw.attn_norm, eps), rot, qscale,
                                       seg_lens)
            kv[l].view(-1, kv.shape[-1]).index_copy_(0, rows, lat)
            x = x + a
            x = x.add_(self.moe(lw, rms_norm(x, lw.mlp_norm, eps), counts, tap, tap_rows))
        return x

    def decode(self, ids: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
               mask: torch.Tensor, kv, counts=None, tap=None, tap_rows=None, valid=None,
               span: bool = True) -> torch.Tensor:
        """One token of each of B cached sequences (cache slots 0..B-1;
        ``mask`` (B, L) true where a position is attended) -> final hidden
        states (B, D), not normed; ``valid`` as in ``moe``."""
        x = self.embed[ids]
        rot, qscale = self.positions(pos)
        bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        bias.masked_fill_(~mask, float("-inf"))
        rowscale = qscale * self.scale
        self._rows = rows
        eps = self.cfg.rms_norm_eps
        for l, lw in enumerate(self.layers):
            x = x + self.attn_decode(lw, rms_norm(x, lw.attn_norm, eps), rot, rowscale,
                                     kv[l], bias)
            x = x.add_(self.moe(lw, rms_norm(x, lw.mlp_norm, eps), counts, tap, tap_rows,
                                valid, span))
        return x

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm and head -> float32 logits."""
        return F.linear(rms_norm(h, self.final_norm, self.cfg.rms_norm_eps),
                        self.head).to(torch.float32)

    def free(self) -> None:
        """Drop every weight."""
        self.layers, self.vision = [], None
        self.embed = self.head = self.final_norm = None


# ------------------------------------------------------------- vision


class VisionEncoder:
    """Pixtral-style encoder: a 14x14 patch conv, RMSNorm, ``layers``
    pre-norm blocks (2D RoPE attention, gated-SiLU MLP), then the
    projector: RMSNorm, 2x2 patch merge (4 x 1024 -> 1024), and
    linear -> GELU -> linear to the text width."""

    MEAN = (0.48145466, 0.4578275, 0.40821073)
    STD = (0.26862954, 0.26130258, 0.27577711)

    def __init__(self, cfg: Mistral4Config, seed: int, device, dtype):
        vc = cfg.vision
        self.cfg, self.vc, self.dtype = cfg, vc, dtype
        E, I, P = vc.hidden_size, vc.intermediate_size, vc.patch_size
        m = vc.spatial_merge_size
        self.patch = param(seed, "V", "patch_conv", (E, 3, P, P), "conv", device, dtype)
        self.ln_pre = param(seed, "V", "ln_pre", (E,), "norm", device, dtype)
        self.layers = []
        for l in range(vc.num_hidden_layers):
            s = f"V{l}"

            def p(name, shape, kind="linear"):
                return param(seed, s, name, shape, kind, device, dtype)

            self.layers.append({
                "attn_norm": p("attn_norm", (E,), "norm"),
                "wqkv": torch.cat([p("wq", (E, E)), p("wk", (E, E)), p("wv", (E, E))]),
                "wo": p("wo", (E, E)),
                "ffn_norm": p("ffn_norm", (E,), "norm"),
                "w13": torch.cat([p("w1", (I, E)), p("w3", (I, E))]),
                "w2": p("w2", (E, I)),
            })
        self.proj_norm = param(seed, "P", "norm", (E,), "norm", device, dtype)
        self.merge = param(seed, "P", "merge", (E, E * m * m), "linear", device, dtype)
        self.lin1 = param(seed, "P", "lin1", (cfg.hidden_size, E), "linear", device, dtype)
        self.lin2 = param(seed, "P", "lin2", (cfg.hidden_size, cfg.hidden_size), "linear",
                          device, dtype)
        head = E // vc.num_attention_heads
        base = 1.0 / (vc.rope_theta ** (torch.arange(0, head, 2, dtype=torch.float64) / head))
        self.freq_h, self.freq_w = base[::2].to(device), base[1::2].to(device)

    def rope(self, gh: int, gw: int):
        """cos, sin (gh gw, head) of the 2D positions, row-major."""
        hh = torch.arange(gh, device=self.freq_h.device, dtype=torch.float64)
        ww = torch.arange(gw, device=self.freq_h.device, dtype=torch.float64)
        ang = torch.cat([(hh[:, None, None] * self.freq_h).expand(gh, gw, -1),
                         (ww[None, :, None] * self.freq_w).expand(gh, gw, -1)], dim=-1)
        ang = ang.reshape(gh * gw, -1)
        ang = torch.cat([ang, ang], dim=-1)
        return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)

    @staticmethod
    def _rotate_half(x, cos, sin):
        xf = x.to(torch.float32)
        h = xf.shape[-1] // 2
        rot = torch.cat([-xf[..., h:], xf[..., :h]], dim=-1)
        return (xf * cos + rot * sin).to(x.dtype)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """Normalised images (N, 3, H, W), H and W multiples of patch x
        merge -> (N, H/28 * W/28, text hidden) image embeddings, row-major
        over the merged grid."""
        vc = self.vc
        N, _, Hh, Ww = images.shape
        P, m = vc.patch_size, vc.spatial_merge_size
        gh, gw = Hh // P, Ww // P
        E, nh = vc.hidden_size, vc.num_attention_heads
        hd = E // nh
        x = F.conv2d(images.to(self.dtype), self.patch, stride=P)       # (N, E, gh, gw)
        x = x.flatten(2).transpose(1, 2)                                # (N, gh gw, E)
        x = rms_norm(x, self.ln_pre, vc.rms_norm_eps)
        cos, sin = self.rope(gh, gw)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        S = gh * gw
        for lw in self.layers:
            h = rms_norm(x, lw["attn_norm"], vc.rms_norm_eps)
            q, k, v = F.linear(h, lw["wqkv"]).view(N, S, 3, nh, hd).unbind(2)
            q, k = self._rotate_half(q, cos, sin), self._rotate_half(k, cos, sin)
            o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2))
            x = x + F.linear(o.transpose(1, 2).reshape(N, S, E), lw["wo"])
            h = F.linear(rms_norm(x, lw["ffn_norm"], vc.rms_norm_eps), lw["w13"])
            I = h.shape[-1] // 2
            x = x + F.linear(F.silu(h[..., :I]) * h[..., I:], lw["w2"])
        x = rms_norm(x, self.proj_norm, self.cfg.rms_norm_eps)
        # 2x2 merge as unfold lays it out: channel by channel, each
        # channel's four patches row-major within the cell
        x = x.view(N, gh // m, m, gw // m, m, E).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(N, (gh // m) * (gw // m), m * m * E)
        x = F.linear(x, self.merge)
        return F.linear(F.gelu(F.linear(x, self.lin1)), self.lin2)
