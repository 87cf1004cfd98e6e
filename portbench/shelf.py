"""The general traffic generator: a mix file (``traffic/<mix>.json``) of
parameters becomes a shelf of distinct books, drawn from the run's seed and
written in parallel worker processes.

A mix names its ``generator`` (``test_book`` or ``scanned_book`` of
``bookgen``), the multiset of book lengths ``pages`` that the shelf cycles
through, each cycle in an order the seed shuffles (so every seed sends the
same lengths), the number of distinct ``books`` on the shelf and the pages
of the warm-up book. A configuration's ``visuals_per_page`` (born-digital
books; the harness puts it into the mix) makes round(visuals_per_page x
pages) of a book's pages cycle pages (one visual a page over the cycle)
and the rest text-only pages, at places the seed draws, so that every seed
sends the same number of each. A mix that needs code beside its data puts a
``traffic/<mix>.py`` with ``plan(mix, seed) -> [BookSpec]`` next to it.
"""
from __future__ import annotations

import importlib.util
import json
import os
import time
from dataclasses import dataclass
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class BookSpec:
    generator: str
    pages: int
    seed: int
    start: int = 0
    text_pages: tuple = ()


def load_mix(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def plan(mix: dict, seed: int, name: str = "", root: str = HERE) -> List[BookSpec]:
    """The shelf's books in the order the closed loop sends them."""
    code = os.path.join(root, "traffic", f"{name}.py")
    if name and os.path.exists(code):
        spec = importlib.util.spec_from_file_location(f"portbench_mix_{name}", code)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.plan(mix, seed)
    rng = np.random.default_rng(seed)
    lengths = [int(p) for p in mix["pages"]]
    visuals_per_page = mix.get("visuals_per_page")
    out: List[BookSpec] = []
    while len(out) < int(mix["books"]):
        for i in rng.permutation(len(lengths)):
            n = lengths[i]
            text = ()
            if visuals_per_page is not None:
                k = n - int(round(visuals_per_page * n))
                text = tuple(sorted(int(p) for p in rng.choice(n, k, replace=False)))
            out.append(BookSpec(mix["generator"], n,
                                int(rng.integers(0, 2 ** 62)),
                                int(rng.integers(0, 8)), text))
    return out[: int(mix["books"])]


def warmup_spec(mix: dict, seed: int) -> BookSpec:
    """The warm-up book: the mix's generator at ``warmup_pages``, from a
    seed of its own."""
    rng = np.random.default_rng([seed, 1])
    return BookSpec(mix["generator"], int(mix["warmup_pages"]),
                    int(rng.integers(0, 2 ** 62)), 0)


def _truth(truths) -> list:
    """Per page: the truth visuals' (kind, [x0, y0, x1, y1]) in points."""
    return [[(v.kind, list(v.bbox)) for v in t.visuals] for t in truths]


def write_book(spec: BookSpec, path: str) -> dict:
    """Write one book; -> {"path", "pages", "visuals", "texts"}: the truth
    the comparison reads (``texts``: each scanned page's drawn text)."""
    from portbench import bookgen

    if spec.generator == "test_book":
        truths = bookgen.make_test_book(path, pages=spec.pages, seed=spec.seed,
                                        start=spec.start, text_pages=spec.text_pages)
        texts = None
    elif spec.generator == "scanned_book":
        truths, texts = bookgen.make_scanned_book(path, pages=spec.pages,
                                                  seed=spec.seed)
    else:
        raise ValueError(f"unknown generator {spec.generator!r}")
    return {"path": path, "pages": spec.pages, "visuals": _truth(truths),
            "texts": texts}


def _write(args):
    return write_book(*args)


def make_shelf(specs: List[BookSpec], folder: str, workers: int) -> List[dict]:
    """Write every book under ``folder`` with ``workers`` spawned processes
    (all joined before this returns); the books in ``specs`` order."""
    import multiprocessing as mp

    os.makedirs(folder, exist_ok=True)
    jobs = [(s, os.path.join(folder, f"book{i:04d}.pdf"))
            for i, s in enumerate(specs)]
    # the longest books first, so that no worker is left with one at the end
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][0].pages)
    out: List[dict] = [None] * len(jobs)
    pool = mp.get_context("spawn").Pool(max(1, min(workers, len(jobs))))
    try:
        for i, res in zip(order, pool.imap(_write, [jobs[i] for i in order])):
            out[i] = res
        pool.close()
    finally:
        pool.terminate()
        pool.join()
    return out


def generate(mix: dict, name: str, seed: int, folder: str, workers: int):
    """-> (warm-up book, shelf books, seconds): every book of the run, on
    the disk (flushed, so that writing the shelf back leaves the window's
    own writes alone)."""
    t0 = time.perf_counter()
    specs = [warmup_spec(mix, seed)] + plan(mix, seed, name)
    books = make_shelf(specs, folder, workers)
    os.sync()
    return books[0], books[1:], time.perf_counter() - t0
