"""Sequences a decode step of the vision LLM's engine carries, averaged over
the ``llm_decode`` spans."""
from portbench import mistral4_counts as M


def read(run):
    _, by = M.engine_spans(run)
    steps = by.get("llm_decode", [])
    if not steps:
        return None
    return sum(s.attrs["seqs"] for s in steps) / len(steps)
