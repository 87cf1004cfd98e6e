"""Prefill's share of the card's bf16 peak (989 TFLOP/s): the FLOPs of the
``llm_prefill`` spans' prompts (``mistral4_counts.prefill_flops``) over
their device time."""
from portbench import mistral4_counts as M


def read(run):
    prog, by = M.engine_spans(run)
    steps = by.get("llm_prefill", [])
    if not steps:
        return None
    moe = M.moe_sums(by)
    busy = sum(prog.device_s(s) for s in steps)
    flops = sum(M.step_flops(s, moe) for s in steps)
    return 100.0 * M.bf16_s(flops) / busy if busy else None
