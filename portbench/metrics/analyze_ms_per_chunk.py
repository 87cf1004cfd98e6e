"""Device ms a 16-crop analyze chunk: device time of the operations launched
inside the ``analyze`` spans (trace) over the chunks."""


def read(run):
    spans = [s for s in run.spans if s.name == "analyze" and s.device_s is not None]
    if not spans:
        return None
    return 1e3 * sum(s.device_s for s in spans) / sum(s.attrs["chunks"] for s in spans)
