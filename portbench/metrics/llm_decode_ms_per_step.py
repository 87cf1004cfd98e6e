"""Device ms of one decode step of the vision LLM's engine: the device time
of the operations launched inside the program's ``llm_decode`` spans over
their count."""
from portbench import mistral4_counts as M


def read(run):
    prog, by = M.engine_spans(run)
    steps = by.get("llm_decode", [])
    if not steps:
        return None
    return 1e3 * sum(prog.device_s(s) for s in steps) / len(steps)
