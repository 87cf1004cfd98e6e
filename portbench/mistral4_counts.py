"""Operations and bytes of Mistral-Small-4-119B-2603's engine steps on one
card (``synapta_tpu_torch/llm/engine.py``), from the published shapes and
the counts its spans carry, against the peaks of ``counts.py``.

A decode step reads, at least, every weight it uses once: per layer the
attention's projections, the norms, the router (float32), the shared
expert and the held experts that the step's tokens touched (its
``experts``), and the latent cache it attends (c_kv 256 + k_rope 64
in bf16, 640 bytes a position a layer); then the embedding rows and the
head. FLOPs count 2 a multiply-add of every product the engine computes:
prefill the expanded attention (causal: half the score matrix), decode the
absorbed one, the held experts' assignments (``held_tokens``),
the head at the rows it is applied to, and the vision tower per image.
"""
from __future__ import annotations

from portbench import counts

D, L, H, V = 4096, 36, 32, 131072
QL, KVL, NOPE, ROPE, VD = 1024, 256, 64, 64, 128
FW, E, K = 2048, 128, 4
VE, VL, VI, PATCH, MERGE = 1024, 24, 4096, 14, 2
BF16 = 2


def attn_params() -> int:
    """The attention's weights of one layer (q_a, kv_a, q_b, kv_b, o)."""
    return (QL + KVL + ROPE) * D + H * (NOPE + ROPE) * QL + H * (NOPE + VD) * KVL + D * H * VD


def expert_params() -> int:
    return 3 * FW * D


def decode_bytes(seqs: int, context: int, experts_touched: int) -> int:
    """Least bytes of one decode step of ``seqs`` sequences attending
    ``context`` cache positions in all (each layer), the held experts
    touched summed over the layers."""
    per_layer = (attn_params() + expert_params()) * BF16 + (2 * D + QL + KVL) * BF16 \
        + E * D * 4 + context * (KVL + ROPE) * BF16
    return (L * per_layer + experts_touched * expert_params() * BF16
            + seqs * D * BF16 + D * BF16 + V * D * BF16)


def layer_flops(tokens: int, assignments: int) -> float:
    """Products of one layer's projections, router and experts, attention
    scores aside."""
    return 2.0 * tokens * (attn_params() + expert_params() + E * D) \
        + 2.0 * assignments * expert_params()


def prefill_flops(tokens: int, tokens_sq: int, seqs: int, assignments: int) -> float:
    """A prefill of ``seqs`` prompts of ``tokens`` in all (``tokens_sq``:
    the sum of their squares), ``assignments`` to held experts summed over
    the layers; the head at each prompt's last row."""
    attn = 2.0 * H * (NOPE + ROPE + VD) * tokens_sq / 2
    return L * (layer_flops(tokens, 0) + attn) + 2.0 * assignments * expert_params() \
        + 2.0 * seqs * V * D


def decode_flops(seqs: int, context: int, assignments: int) -> float:
    """One decode step: the absorbed attention (fold the key half of kv_b
    into the query, scores against c_kv and k_rope, the latent context,
    the value half), the layers' products and the head for each sequence."""
    attn = 2.0 * H * (seqs * NOPE * KVL + context * (KVL + ROPE) + context * KVL
                      + seqs * KVL * VD)
    proj = 2.0 * seqs * (attn_params() - H * (NOPE + VD) * KVL + expert_params() + E * D)
    return L * (attn + proj) + 2.0 * assignments * expert_params() + 2.0 * seqs * V * D


def vision_flops(patches: int, images: int) -> float:
    """The vision tower and projector on ``images`` of ``patches`` patches
    in all (each image's attention over its own patches)."""
    per = patches / max(images, 1)
    conv = 2.0 * patches * 3 * PATCH * PATCH * VE
    layer = 2.0 * patches * (4 * VE * VE + 3 * VE * VI) + images * 2.0 * 2 * per * per * VE
    cells = patches / (MERGE * MERGE)
    proj = 2.0 * cells * (MERGE * MERGE * VE * VE + VE * D + D * D)
    return conv + VL * layer + proj


def decode_least_s(seqs: int, context: int, experts_touched: int) -> float:
    return decode_bytes(seqs, context, experts_touched) / counts.HBM_BYTES_PER_S


def bf16_s(flops: float) -> float:
    return flops / counts.BF16_FLOPS


# ------------------------------------------------ the engine's spans of a run


def engine_spans(run):
    """-> (the placed program spans or None, {name: spans}) of the engine's
    ``vision_encode``, ``llm_prefill``, ``llm_decode`` and ``moe``."""
    from portbench import program_spans

    prog = program_spans.load(run)
    if prog is None:
        return None, {}
    by = {}
    for s in prog.spans:
        if s.name in ("vision_encode", "llm_prefill", "llm_decode", "moe"):
            by.setdefault(s.name, []).append(s)
    return prog, by


def moe_sums(by: dict) -> dict:
    """{step span id: (assignments to held experts, held experts touched)}
    summed over a step's layers: a decode step carries them itself, a
    prefill in its ``moe`` spans."""
    out = {}
    for s in by.get("moe", []):
        a, e = out.get(s.parent, (0, 0))
        out[s.parent] = (a + s.attrs.get("held_tokens", 0), e + s.attrs.get("experts", 0))
    for s in by.get("llm_decode", []):
        out[s.sid] = (s.attrs.get("held_tokens", 0), s.attrs.get("experts", 0))
    return out


def step_flops(s, moe: dict) -> float:
    a = moe.get(s.sid, (0, 0))[0]
    if s.name == "llm_prefill":
        return prefill_flops(s.attrs["tokens"], s.attrs["tokens_sq"], s.attrs["seqs"], a)
    if s.name == "llm_decode":
        return decode_flops(s.attrs["seqs"], s.attrs["context"], a)
    return vision_flops(s.attrs["patches"], s.attrs["images"])
