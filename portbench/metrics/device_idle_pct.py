"""Share of the traced window in which no operation ran on the device:
1 - (union of kernel, copy and set intervals) / window."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
