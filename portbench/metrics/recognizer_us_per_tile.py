"""Device µs a real line tile (padding rows of the 128-tile batches left
out of the count): device time inside the ``recognizer`` spans over their
tiles."""


def read(run):
    spans = [s for s in run.spans if s.name == "recognizer" and s.device_s is not None]
    tiles = sum(s.attrs["tiles"] for s in spans)
    if not tiles:
        return None
    return 1e6 * sum(s.device_s for s in spans) / tiles
