"""Shelf throughput: pages of the books finished in the window over the
seconds from the window's start to the last book's end (host clock)."""


def read(run):
    if not run.pages or not run.window_s:
        return None
    return run.pages / run.window_s
