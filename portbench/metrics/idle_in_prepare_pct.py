"""Share of the traced window in which the device ran nothing while the
program's main thread was inside ``prepare_body`` or ``prepare_wait``
(program spans, ``program_spans.py``)."""
from portbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "prepare")
