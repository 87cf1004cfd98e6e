"""The control comes out not correct: the reference in fp8 (float8 e4m3,
the precision below the program's bfloat16 models) put in the program's
place, read at each frame and DB pixel of the same sampled calls, fails the
limit of ``rec_gap`` and of ``db_gap`` by the harness's own verdict, while
the program, on the same books, passes. CPU, small books; on the card at
the cells' own sizes: ``portbench/run.py ... --control``."""
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import bench_with_born_digital

# eight whole 8-page cycles; two scanned pages (the widest gap grows with the
# frames read, so a smaller book can leave the control under its limit)
BOOKS = {
    "digital-volumes": {"generator": "test_book", "pages": [64], "books": 1,
                        "warmup_pages": 1},
    "scanned-chapters": {"generator": "scanned_book", "pages": [2], "books": 1,
                         "warmup_pages": 1},
}


@pytest.mark.parametrize("cell,numbers", [
    ("digital-volumes", ["rec_gap"]),
    ("scanned-chapters", ["rec_gap", "db_gap"]),
])
def test_control_fails_its_limits(cell, numbers):
    torch.set_num_threads(4)
    bench = bench_with_born_digital()
    runs = {c: harness.run_cell(bench, cell, 2 ** 35 + 3, 0.1, False, device="cpu",
                                workers=2, mix=BOOKS[cell], control=c)
            for c in (False, True)}
    assert runs[False]["correct"] is True, runs[False]["checks"]
    assert runs[True]["correct"] is False, runs[True]["checks"]
    for name in numbers:
        limit = runs[True]["checks"][name]["limit"]
        assert runs[True]["checks"][name]["value"] > limit
        assert runs[False]["checks"][name]["value"] <= limit
