"""Tokens the vision LLM generated a page: one a sequence a prefill (its
first token) and one a sequence a decode step, over the pages of the
finished books. The traffic fixes the reply lengths, so this counts the
work the window asked of the engine."""
from portbench import mistral4_counts as M


def read(run):
    _, by = M.engine_spans(run)
    steps = by.get("llm_prefill", []) + by.get("llm_decode", [])
    if not steps or not run.pages:
        return None
    return sum(s.attrs["seqs"] for s in steps) / run.pages
