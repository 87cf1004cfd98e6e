"""Host enrich and writes ms a segment: the window's ``TIMERS``
``build_segment`` + ``writer_append`` seconds over the segments written."""


def read(run):
    if not run.segments or "build_segment" not in run.timers:
        return None
    return 1e3 * (run.timers["build_segment"]
                  + run.timers.get("writer_append", 0.0)) / run.segments
