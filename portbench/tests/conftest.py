"""The benchmark's own tests (CPU; those marked ``cuda`` decide inside the
test whether a card is there). Run from the repo root:

    python -m pytest portbench/tests -q
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")

# The born-digital cell: out of BENCHMARK.json while its pages/s spreads by
# more than the largest bound on the card's host; its configuration and mix
# stay in portbench/, and these tests still drive its comparison.
BORN_DIGITAL_CONFIG = {
    "name": "textbook_digital",
    "source": "https://github.com/ashr2k/synapta-image-segmentation",
    "file": "portbench/configs/textbook_digital.json", "reduced": ["book_pages"],
    "why": "born-digital textbook pages: analyze pass, CC and edge stats, recognizer"}
BORN_DIGITAL_CELL = {
    "name": "digital-volumes", "config": "textbook_digital", "traffic": "volumes",
    "chips": 1, "why": "300-page volumes, 1 client, closed loop"}


def bench_with_born_digital() -> dict:
    """BENCHMARK.json with the born-digital cell beside its own cells."""
    from portbench import harness

    bench = harness.load_benchmark()
    if all(w["name"] != BORN_DIGITAL_CELL["name"] for w in bench["workloads"]):
        bench["configs"].append(dict(BORN_DIGITAL_CONFIG))
        bench["workloads"].append(dict(BORN_DIGITAL_CELL))
    return bench
