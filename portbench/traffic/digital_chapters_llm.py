"""The plan of ``digital_chapters_llm``: born-digital chapters in which
every seed asks the same work of the vision LLM.

As ``shelf.plan`` does, a book has round(visuals_per_page x pages) pages of
the generator's 8-page cycle and text-only pages for the rest, and its
generator seed is drawn from the run's seed. Unlike it, every book starts
at page 0 of the cycle, and the text pages are drawn inside each
``batch_pages``-page super-batch (the pipeline's ``pages_per_batch``) for
that super-batch alone, so that each super-batch holds the same cycle
pages, and so the same visual kinds, for every seed: the first
super-batches take one cycle page more where they do not divide evenly.
"""
from typing import List

import numpy as np

from portbench.shelf import BookSpec


def cycle_pages_per_batch(pages: int, cycle: int, batch: int) -> List[int]:
    """Cycle pages of each super-batch, as even as the pages allow."""
    sizes = [min(batch, pages - b0) for b0 in range(0, pages, batch)]
    base, extra = divmod(cycle, len(sizes))
    out = [min(s, base + (i < extra)) for i, s in enumerate(sizes)]
    if sum(out) != cycle:
        raise ValueError(f"{cycle} cycle pages do not fit {sizes}")
    return out


def plan(mix: dict, seed: int) -> List[BookSpec]:
    rng = np.random.default_rng(seed)
    lengths = [int(p) for p in mix["pages"]]
    batch = int(mix["batch_pages"])
    out: List[BookSpec] = []
    while len(out) < int(mix["books"]):
        for i in rng.permutation(len(lengths)):
            n = lengths[i]
            cycle = int(round(mix["visuals_per_page"] * n))
            text = []
            for b, c in enumerate(cycle_pages_per_batch(n, cycle, batch)):
                b0 = b * batch
                size = min(batch, n - b0)
                text += sorted(b0 + int(p) for p in rng.choice(size, size - c, replace=False))
            out.append(BookSpec(mix["generator"], n, int(rng.integers(0, 2 ** 62)), 0,
                                tuple(text)))
    return out[: int(mix["books"])]
