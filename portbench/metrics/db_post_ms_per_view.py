"""Device ms a real DB view of the post stage alone (threshold, closing, CC,
stats): device time of the operations launched from the main thread inside
the program's ``db_post`` spans over their real views (program spans,
``program_spans.py``)."""
from portbench import program_spans


def read(run):
    prog = program_spans.load(run)
    if prog is None:
        return None
    spans = [s for s in prog.spans if s.name == "db_post" and "views" in s.attrs
             and s.tid == prog.main_tid]
    views = sum(s.attrs["views"] for s in spans)
    if not views:
        return None
    return 1e3 * sum(prog.device_s(s) for s in spans) / views
