"""Device ms a real DB view: device time inside the ``db`` spans (model and
post stage of every chunk) over the real views of the ``db_chunk`` spans
within them."""


def read(run):
    spans = [s for s in run.spans if s.name == "db" and s.device_s is not None]
    views = sum(s.attrs["views"] for s in run.spans if s.name == "db_chunk")
    if not spans or not views:
        return None
    return 1e3 * sum(s.device_s for s in spans) / views
