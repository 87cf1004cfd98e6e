"""Decode steps' share of their roofline: the least bytes each step reads
(``mistral4_counts.decode_bytes``: the weights it uses with the held experts
its tokens touched, the latent cache it attends, the head) at 3.35 TB/s,
summed, over the device time of the ``llm_decode`` spans."""
from portbench import mistral4_counts as M


def read(run):
    prog, by = M.engine_spans(run)
    steps = by.get("llm_decode", [])
    if not steps:
        return None
    moe = M.moe_sums(by)
    least = sum(M.decode_least_s(s.attrs["seqs"], s.attrs["context"],
                                 moe.get(s.sid, (0, 0))[1]) for s in steps)
    busy = sum(prog.device_s(s) for s in steps)
    return 100.0 * least / busy if busy else None
