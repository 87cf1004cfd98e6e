"""Host prepare (detect, render, PNG submit) ms a page: the window's
``TIMERS`` ``prepare_body`` seconds over the pages of its books."""


def read(run):
    if not run.pages or "prepare_body" not in run.timers:
        return None
    return 1e3 * run.timers["prepare_body"] / run.pages
