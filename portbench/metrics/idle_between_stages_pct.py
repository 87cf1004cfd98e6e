"""Share of the traced window in which the device ran nothing while the
program's main thread was in none of ``prepare_body``, ``prepare_wait``,
``dispatch`` and ``enrich`` (book open, finalize, the queue's manifest and
events, the loop between books; program spans, ``program_spans.py``). With
the three others it sums to the window's device idle share."""
from portbench import program_spans


def read(run):
    return program_spans.idle_pct(run, "between")
