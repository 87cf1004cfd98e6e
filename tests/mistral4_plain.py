"""Mistral-Small-4-119B-2603's forward pass in plain torch and float32: the
text model over whole sequences (no cache, no batching, the expanded
attention with an explicit softmax), its expert layer with a list of held
experts, and the Pixtral-style vision encoder with its projector. It
imports nothing of the program, of JAX or of the JAX package, and turns
TF32 off where it builds its weights on a card.

It follows the published configuration (``CONFIG``: the model's own
config.json) and, where that is silent, the choices listed under
"assumed" in ``portbench/configs/textbook_digital_mistral4.json``. Its
departures from a checkpoint's forward pass, each deliberate:

- weights are not read from a checkpoint: each tensor is float32 ``randn``
  from a generator seeded by a hash of (seed, scope, name), times 1/sqrt(fan
  in) (an embedding: 1; a norm's scale: 1 + 0.1 randn), rounded to bf16 and
  back, the values the program holds (``param``);
- ``held`` experts only: a token's routed share is that of its chosen
  experts that are held, the rest left out (an expert-parallel rank's part);
- ``routes`` may force each layer's chosen experts (a comparison follows
  the program's choices and reads, as ``route_gap``, how far the reference's
  own scores place them below its fourth best);
- the router's score function is a softmax over the routed logits (the
  configuration gives none), the top 4 renormalised;
- the softmax scale is DeepSeek-V3's: qk_head_dim^-1/2 times the yarn mscale
  (0.1 ln(factor) + 1) squared;
- ``fp8=True`` is the comparison's control: every linear layer and the
  patch convolution read their input rounded to float8 e4m3 (one scale a
  tensor, its largest magnitude at 448) and their weight alike with a scale
  per output channel.

Ids come from the caller: the stand-in tokenizer and the image layout are
the client's, and the image's embeddings take the rows it names.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

# the published text configuration, and the vision tower assumed
CONFIG = {
    "vocab_size": 131072, "hidden_size": 4096, "num_hidden_layers": 36,
    "num_attention_heads": 32, "q_lora_rank": 1024, "kv_lora_rank": 256,
    "qk_nope_head_dim": 64, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "moe_intermediate_size": 2048, "n_routed_experts": 128, "num_experts_per_tok": 4,
    "n_shared_experts": 1, "norm_topk_prob": True, "routed_scaling_factor": 1.0,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "rope_factor": 128.0,
    "original_max_position_embeddings": 8192, "beta_fast": 32.0, "beta_slow": 1.0,
    "mscale": 1.0, "mscale_all_dim": 1.0, "llama_4_scaling_beta": 0.1,
    "vision": {"hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
               "intermediate_size": 4096, "patch_size": 14, "rope_theta": 10000.0,
               "spatial_merge_size": 2, "rms_norm_eps": 1e-5},
}


def config(**over) -> dict:
    c = dict(CONFIG, **{k: v for k, v in over.items() if k != "vision"})
    c["vision"] = dict(CONFIG["vision"], **over.get("vision", {}))
    return c


# ------------------------------------------------------------------ weights


def param(seed, scope: str, name: str, shape, kind: str, device) -> torch.Tensor:
    """The weight the program holds, in float32."""
    key = hashlib.blake2b(f"{int(seed)}/{scope}/{name}".encode(), digest_size=8)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int.from_bytes(key.digest(), "little") & ((1 << 63) - 1))
    x = torch.randn(tuple(shape), generator=g, device=torch.device(device),
                    dtype=torch.float32)
    if kind == "norm":
        x = 1.0 + 0.1 * x
    elif kind == "linear":
        x = x * (1.0 / math.sqrt(shape[-1]))
    elif kind == "conv":
        x = x * (1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
    return x.to(torch.bfloat16).to(torch.float32)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x rounded to float8 e4m3 and back, one scale over ``dims`` (None:
    the whole tensor), the largest magnitude at 448."""
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    s = torch.clamp(a, min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x, w, fp8=False):
    if fp8:
        x, w = fp8_round(x), fp8_round(w, (1,))
    return x @ w.t()


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


# ------------------------------------------------------------------ text


def layer_weights(c: dict, seed, l: int, held: Optional[Sequence[int]], device) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    ql, kvl, Fw = c["q_lora_rank"], c["kv_lora_rank"], c["moe_intermediate_size"]
    s = f"L{l}"
    held = range(c["n_routed_experts"]) if held is None else held
    return {
        "attn_norm": param(seed, s, "attn_norm", (D,), "norm", device),
        "q_a": param(seed, s, "q_a", (ql, D), "linear", device),
        "q_a_norm": param(seed, s, "q_a_norm", (ql,), "norm", device),
        "q_b": param(seed, s, "q_b", (H * (nope + rope), ql), "linear", device),
        "kv_a": param(seed, s, "kv_a", (kvl + rope, D), "linear", device),
        "kv_a_norm": param(seed, s, "kv_a_norm", (kvl,), "norm", device),
        "kv_b": param(seed, s, "kv_b", (H * (nope + vd), kvl), "linear", device),
        "o": param(seed, s, "o", (D, H * vd), "linear", device),
        "mlp_norm": param(seed, s, "mlp_norm", (D,), "norm", device),
        "router": param(seed, s, "router", (c["n_routed_experts"], D), "linear", device),
        "experts": {e: (param(seed, s, f"expert{e}.w1", (Fw, D), "linear", device),
                        param(seed, s, f"expert{e}.w3", (Fw, D), "linear", device),
                        param(seed, s, f"expert{e}.w2", (D, Fw), "linear", device))
                    for e in held},
        "shared": (param(seed, s, "shared.w1", (Fw * c["n_shared_experts"], D), "linear", device),
                   param(seed, s, "shared.w3", (Fw * c["n_shared_experts"], D), "linear", device),
                   param(seed, s, "shared.w2", (D, Fw * c["n_shared_experts"]), "linear", device)),
    }


def yarn(c: dict, pos: torch.Tensor):
    """cos, sin (T, rope) for the de-interleaved rope half, and the
    softmax scale."""
    dim, base, factor = c["qk_rope_head_dim"], c["rope_theta"], c["rope_factor"]
    orig = c["original_max_position_embeddings"]
    lo = math.floor(dim * math.log(orig / (c["beta_fast"] * 2 * math.pi)) / (2 * math.log(base)))
    hi = math.ceil(dim * math.log(orig / (c["beta_slow"] * 2 * math.pi)) / (2 * math.log(base)))
    lo, hi = max(lo, 0), min(hi, dim - 1)
    if lo == hi:
        hi += 0.001
    freqs = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - lo) / (hi - lo), 0, 1)
    inv = (freqs / factor) * ramp + freqs * (1 - ramp)

    def mscale(m):
        return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0

    att = mscale(c["mscale"]) / mscale(c["mscale_all_dim"])
    ang = torch.outer(pos.double().cpu(), inv)
    emb = torch.cat([ang, ang], dim=-1)
    cos = (emb.cos() * att).float().to(pos.device)
    sin = (emb.sin() * att).float().to(pos.device)
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    if c["mscale_all_dim"]:
        scale *= mscale(c["mscale_all_dim"]) ** 2
    return cos, sin, scale


def deinterleave(x):
    """(..., d) pairs (x0, x1), (x2, x3), ... -> [x0, x2, ..., x1, x3, ...]."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def llama4_query_scale(c: dict, pos: torch.Tensor) -> torch.Tensor:
    n = torch.floor(pos.double() / c["original_max_position_embeddings"])
    return (1.0 + c["llama_4_scaling_beta"] * torch.log(1.0 + n)).float()


def attention(c: dict, w: dict, x, pos, fp8=False):
    """Expanded MLA, causal, over one sequence x (T, D)."""
    T = x.shape[0]
    H, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
    eps, kvl = c["rms_norm_eps"], c["kv_lora_rank"]
    q = linear(rms(linear(x, w["q_a"], fp8), w["q_a_norm"], eps), w["q_b"], fp8).view(T, H, -1)
    kv = linear(x, w["kv_a"], fp8)
    c_kv = rms(kv[:, :kvl], w["kv_a_norm"], eps)
    kb = linear(c_kv, w["kv_b"], fp8).view(T, H, nope + vd)
    cos, sin, scale = yarn(c, pos)
    q_pe = deinterleave(q[..., nope:])
    q_pe = q_pe * cos[:, None] + rotate_half(q_pe) * sin[:, None]
    k_pe = deinterleave(kv[:, kvl:])
    k_pe = k_pe * cos + rotate_half(k_pe) * sin
    qq = torch.cat([q[..., :nope], q_pe], -1) * llama4_query_scale(c, pos)[:, None, None]
    kk = torch.cat([kb[..., :nope], k_pe[:, None, :].expand(T, H, rope)], -1)
    v = kb[..., nope:]
    s = torch.einsum("thd,uhd->htu", qq, kk) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("htu,uhd->thd", p, v).reshape(T, H * vd)
    return linear(o, w["o"], fp8)


def experts(c: dict, w: dict, x, routes=None, fp8=False):
    """-> (the held experts' share plus the shared expert's output, the
    chosen experts (T, k), the route gap: the widest distance in router
    logits by which a chosen expert lies below the fourth best)."""
    k = c["num_experts_per_tok"]
    logits = linear(x, w["router"], fp8)
    probs = torch.softmax(logits, dim=-1)
    if routes is None:
        routes = probs.topk(k, dim=-1).indices
    routes = routes.long()
    gate = probs.gather(1, routes)
    if c["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    gate = gate * c["routed_scaling_factor"]
    kth = logits.topk(k, dim=-1).values[:, -1]
    gap = float((kth - logits.gather(1, routes).min(-1).values).clamp(min=0).max())
    out = torch.zeros_like(x)
    for e, (w1, w3, w2) in w["experts"].items():
        tok, slot = (routes == e).nonzero(as_tuple=True)
        if tok.numel():
            xe = x[tok]
            ye = linear(F.silu(linear(xe, w1, fp8)) * linear(xe, w3, fp8), w2, fp8)
            out.index_add_(0, tok, ye * gate[tok, slot][:, None])
    w1, w3, w2 = w["shared"]
    out = out + linear(F.silu(linear(x, w1, fp8)) * linear(x, w3, fp8), w2, fp8)
    return out, routes, gap


def layer(c: dict, w: dict, x, pos, routes=None, fp8=False):
    eps = c["rms_norm_eps"]
    x = x + attention(c, w, rms(x, w["attn_norm"], eps), pos, fp8)
    y, chosen, gap = experts(c, w, rms(x, w["mlp_norm"], eps), routes, fp8)
    return x + y, chosen, gap


def forward_many(c: dict, seed, seqs: List[dict], held=None, fp8=False, device="cpu"):
    """Every sequence through the text model, one layer's weights built at a
    time. A sequence: ``ids`` (T,), optional ``image_rows`` and
    ``image_embeds`` (rows of the embedding they replace), optional
    ``routes`` (layers, T, k) to force, ``at`` the positions whose logits to
    return. -> per sequence {"logits" (len(at), vocab), "routes" (layers,
    T, k), "route_gap"}."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _no_tf32()
    D, V = c["hidden_size"], c["vocab_size"]
    emb = param(seed, "G", "embed", (V, D), "embed", dev)
    xs = []
    for s in seqs:
        x = emb[torch.as_tensor(s["ids"], device=dev).long()]
        if s.get("image_rows") is not None and len(s["image_rows"]):
            x[torch.as_tensor(s["image_rows"], device=dev).long()] = s["image_embeds"].to(dev).float()
        xs.append(x)
    del emb
    out = [{"routes": [], "route_gap": 0.0} for _ in seqs]
    for l in range(c["num_hidden_layers"]):
        w = layer_weights(c, seed, l, held, dev)
        for i, s in enumerate(seqs):
            pos = torch.arange(xs[i].shape[0], device=dev)
            forced = None if s.get("routes") is None else s["routes"][l].to(dev)
            xs[i], chosen, gap = layer(c, w, xs[i], pos, forced, fp8)
            out[i]["routes"].append(chosen)
            out[i]["route_gap"] = max(out[i]["route_gap"], gap)
        del w
    norm = param(seed, "G", "final_norm", (D,), "norm", dev)
    head = param(seed, "G", "head", (V, D), "linear", dev)
    for i, s in enumerate(seqs):
        at = torch.as_tensor(s.get("at", range(xs[i].shape[0])), device=dev).long()
        out[i]["logits"] = linear(rms(xs[i][at], norm, c["rms_norm_eps"]), head, fp8)
        out[i]["routes"] = torch.stack(out[i]["routes"])
    return out


def forward(c: dict, seed, ids, held=None, image_rows=None, image_embeds=None,
            routes=None, fp8=False, device="cpu") -> torch.Tensor:
    """Logits (T, vocab) of one sequence."""
    return forward_many(c, seed, [{"ids": ids, "image_rows": image_rows,
                                   "image_embeds": image_embeds, "routes": routes}],
                        held, fp8, device)[0]["logits"]


def moe_layer(c: dict, seed, l: int, x, held=None, device="cpu"):
    """Layer ``l``'s expert layer (held share plus the shared expert) of
    normed inputs x (T, D), routed by the reference."""
    w = layer_weights(c, seed, l, held, device)
    return experts(c, w, x.float())[0]


# ------------------------------------------------------------------ vision


def vision(c: dict, seed, images: torch.Tensor, fp8=False, device="cpu") -> torch.Tensor:
    """Normalised images (N, 3, H, W) -> (N, H/28 W/28, hidden) embeddings."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _no_tf32()
    v = c["vision"]
    E, nh, P, m, eps = (v["hidden_size"], v["num_attention_heads"], v["patch_size"],
                        v["spatial_merge_size"], v["rms_norm_eps"])
    hd = E // nh
    x = images.to(dev).float()
    N, _, Hh, Ww = x.shape
    gh, gw = Hh // P, Ww // P
    conv = param(seed, "V", "patch_conv", (E, 3, P, P), "conv", dev)
    if fp8:
        x, conv = fp8_round(x), fp8_round(conv, (1, 2, 3))
    x = F.conv2d(x, conv, stride=P).flatten(2).transpose(1, 2)  # (N, S, E)
    x = rms(x, param(seed, "V", "ln_pre", (E,), "norm", dev), eps)
    freqs = 1.0 / (v["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd))
    fh = torch.outer(torch.arange(gh, dtype=torch.float64), freqs[::2])
    fw = torch.outer(torch.arange(gw, dtype=torch.float64), freqs[1::2])
    inv = torch.cat([fh[:, None, :].repeat(1, gw, 1), fw[None, :, :].repeat(gh, 1, 1)],
                    dim=-1).reshape(gh * gw, hd // 2)
    inv = torch.cat([inv, inv], dim=-1)
    cos, sin = inv.cos().float().to(dev), inv.sin().float().to(dev)
    S = gh * gw
    for l in range(v["num_hidden_layers"]):
        s = f"V{l}"

        def p(name, shape, kind="linear"):
            return param(seed, s, name, shape, kind, dev)

        h = rms(x, p("attn_norm", (E,), "norm"), eps)
        q, k, val = (linear(h, p(n, (E, E)), fp8).view(N, S, nh, hd) for n in ("wq", "wk", "wv"))
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        a = torch.softmax(torch.einsum("nshd,nthd->nhst", q, k) / math.sqrt(hd), dim=-1)
        o = torch.einsum("nhst,nthd->nshd", a, val).reshape(N, S, E)
        x = x + linear(o, p("wo", (E, E)), fp8)
        h = rms(x, p("ffn_norm", (E,), "norm"), eps)
        I = v["intermediate_size"]
        x = x + linear(F.silu(linear(h, p("w1", (I, E)), fp8)) * linear(h, p("w3", (I, E)), fp8),
                       p("w2", (E, I)), fp8)
    x = rms(x, param(seed, "P", "norm", (E,), "norm", dev), c["rms_norm_eps"])
    # the 2x2 merge as torch's unfold lays it out
    grid = x.transpose(1, 2).reshape(N, E, gh, gw)
    x = F.unfold(grid, kernel_size=m, stride=m).transpose(1, 2)  # (N, cells, E m m)
    x = linear(x, param(seed, "P", "merge", (E, E * m * m), "linear", dev), fp8)
    Dt = c["hidden_size"]
    x = F.gelu(linear(x, param(seed, "P", "lin1", (Dt, E), "linear", dev), fp8))
    return linear(x, param(seed, "P", "lin2", (Dt, Dt), "linear", dev), fp8)
