"""The whole page step's share of the card's peak: the two models' FLOPs on
the real tiles and DB views the window processed (counts.page_step_s, each
at the peak of its precision) over the traced window."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    tiles = sum(s.attrs["tiles"] for s in run.spans if s.name == "recognizer")
    views = sum(s.attrs["views"] for s in run.spans if s.name == "db_chunk")
    if not tiles and not views:
        return None
    rec, det = run.models["recognizer"], run.models["detector"]
    return 100.0 * run.counts.page_step_s(rec, det["size"], tiles, views) / run.window_s
