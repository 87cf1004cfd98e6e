"""Device ms of the vision encoder and projector a picture: the device time
inside the ``vision_encode`` spans over their images."""
from portbench import mistral4_counts as M


def read(run):
    prog, by = M.engine_spans(run)
    spans = by.get("vision_encode", [])
    images = sum(s.attrs["images"] for s in spans)
    if not images:
        return None
    return 1e3 * sum(prog.device_s(s) for s in spans) / images
