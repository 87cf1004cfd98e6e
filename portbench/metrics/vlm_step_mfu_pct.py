"""The vision LLM engine's share of the card's bf16 peak (989 TFLOP/s):
the model FLOPs of every prefill, decode step and vision encode in the
window (``mistral4_counts``) over the traced window."""
from portbench import mistral4_counts as M


def read(run):
    _, by = M.engine_spans(run)
    steps = by.get("llm_prefill", []) + by.get("llm_decode", []) + by.get("vision_encode", [])
    if not steps or not run.window_s:
        return None
    moe = M.moe_sums(by)
    return 100.0 * M.bf16_s(sum(M.step_flops(s, moe) for s in steps)) / run.window_s
