"""The frozen book generators draw the program's books byte for byte."""
import numpy as np
import pytest

from portbench import bookgen, shelf


@pytest.mark.parametrize("kind,kw", [
    ("make_test_book", {"pages": 9, "seed": 2 ** 33 + 5}),
    ("make_scanned_book", {"pages": 2, "seed": 7}),
])
def test_frozen_copy_is_the_original(tmp_path, kind, kw):
    from synapta_tpu_torch.hostlibs import ensure_fixture_fonts
    from synapta_tpu_torch.io import pdf_writer

    ensure_fixture_fonts()
    getattr(bookgen, kind)(str(tmp_path / "a.pdf"), **kw)
    getattr(pdf_writer, kind)(str(tmp_path / "b.pdf"), **kw)
    assert (tmp_path / "a.pdf").read_bytes() == (tmp_path / "b.pdf").read_bytes()


def test_cycle_start_shifts_the_page_kinds(tmp_path):
    a = bookgen.make_test_book(str(tmp_path / "a.pdf"), pages=4, seed=1, start=3)
    b = bookgen.make_test_book(str(tmp_path / "b.pdf"), pages=7, seed=1)
    # page 0 of a starts at cycle page 3 (flowchart); b's page 3 is one too
    assert [v.kind for v in a[0].visuals] == [v.kind for v in b[3].visuals]
    assert [len(t.visuals) for t in a] == [len(t.visuals) for t in b[3:7]]


def test_text_pages_go_between_the_cycle(tmp_path):
    a = bookgen.make_test_book(str(tmp_path / "a.pdf"), pages=10, seed=1, start=2,
                               text_pages=(0, 4, 5))
    b = bookgen.make_test_book(str(tmp_path / "b.pdf"), pages=7, seed=1, start=2)
    assert [len(a[p].visuals) for p in (0, 4, 5)] == [0, 0, 0]
    cycle = [t for p, t in enumerate(a) if p not in (0, 4, 5)]
    assert [[v.kind for v in t.visuals] for t in cycle] == \
        [[v.kind for v in t.visuals] for t in b]


@pytest.mark.parametrize("pages", [300, 64, 5])
def test_plan_gives_every_book_the_configured_visuals_a_page(pages):
    mix = {"generator": "test_book", "pages": [pages], "books": 6,
           "visuals_per_page": 591 / 1003}
    for seed in (3, 2 ** 41 + 7):
        plan = shelf.plan(mix, seed)
        cycle = {pages - len(s.text_pages) for s in plan}
        assert cycle == {round(591 / 1003 * pages)}
        assert all(len(set(s.text_pages)) == len(s.text_pages) and
                   all(0 <= p < pages for p in s.text_pages) for s in plan)
    assert len({s.text_pages for s in shelf.plan(mix, 3)}) > 1


def test_shelf_reaches_the_sources_visuals_a_page(tmp_path):
    mix = {"generator": "test_book", "pages": [48], "books": 2, "warmup_pages": 1,
           "visuals_per_page": 591 / 1003}
    _, books, _ = shelf.generate(mix, "", 11, str(tmp_path), workers=2)
    visuals = sum(len(v) for b in books for v in b["visuals"])
    assert abs(visuals / 96 - 591 / 1003) < 2 / 96


def test_plan_sends_the_same_lengths_for_every_seed():
    mix = {"generator": "test_book", "pages": [4, 6, 8, 12, 16], "books": 25}
    lengths = [sorted(s.pages for s in shelf.plan(mix, seed)) for seed in (1, 2 ** 40)]
    assert lengths[0] == lengths[1] == sorted([4, 6, 8, 12, 16] * 5)
    plan = shelf.plan(mix, 2 ** 40)
    for i in range(0, 25, 5):  # each cycle of five is the whole multiset
        assert sorted(s.pages for s in plan[i:i + 5]) == [4, 6, 8, 12, 16]
    assert plan == shelf.plan(mix, 2 ** 40)
    assert len({s.seed for s in plan}) == 25


def test_shelf_writes_every_book_in_plan_order(tmp_path):
    mix = {"generator": "test_book", "pages": [2, 3], "books": 3, "warmup_pages": 1}
    warm, books, gen_s = shelf.generate(mix, "", 5, str(tmp_path), workers=2)
    assert [b["pages"] for b in books] == [s.pages for s in shelf.plan(mix, 5)]
    assert warm["pages"] == 1 and gen_s > 0
    for b in books:
        assert len(b["visuals"]) == b["pages"]
        assert open(b["path"], "rb").read(5) == b"%PDF-"
    assert np.all([b["texts"] is None for b in books])
