"""The edge-stats kernel's share of its roofline: the least time of every
``edge_stats`` call's shapes (counts.edge_stats_least_s) over the device
time inside those spans."""


def read(run):
    spans = [s for s in run.spans if s.name == "edge_stats" and s.device_s]
    if not spans:
        return None
    least = sum(run.counts.edge_stats_least_s(*s.attrs["shape"], s.attrs["counts"])
                for s in spans)
    return 100.0 * least / sum(s.device_s for s in spans)
