"""The CC kernel's share of its roofline: the least time of every ``cc``
call's shapes (counts.cc_least_s) over the device time inside those spans."""


def read(run):
    spans = [s for s in run.spans if s.name == "cc" and s.device_s]
    if not spans:
        return None
    least = sum(run.counts.cc_least_s(*s.attrs["shape"], s.attrs["connectivity"])
                for s in spans)
    return 100.0 * least / sum(s.device_s for s in spans)
