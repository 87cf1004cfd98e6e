"""A configuration, a traffic mix, a span and a per-layer metric added as
new files in a copy of the benchmark are found by name, with no edit to a
file that is there; the run uses them (CPU, tiny books)."""
import json
import os
import shutil

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)

SPAN = '''"""consume: the enrich stage's segment loop of one super-batch."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._consume_batch"


def attrs(args, kwargs, result):
    return {"regions": len(args[1][0])}
'''
METRIC = '''"""Regions a consume span, over the window."""


def read(run):
    spans = [s for s in run.spans if s.name == "consume"]
    return sum(s.attrs["regions"] for s in spans) / len(spans) if spans else None
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in
              map(str, (root / "portbench").rglob("*")) if os.path.isfile(p)}
    cfg = json.load(open(root / "portbench/configs/textbook_digital.json"))
    cfg["name"] = "tiny_digital"
    (root / "portbench/configs/tiny_digital.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(
        {"generator": "test_book", "pages": [2], "books": 2, "warmup_pages": 1,
         "why": "two 2-page books"}))
    (root / "portbench/spans/consume.py").write_text(SPAN)
    (root / "portbench/metrics/regions_per_consume.py").write_text(METRIC)
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny_digital", "source": "test",
                             "file": "portbench/configs/tiny_digital.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny", "config": "tiny_digital",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "regions_per_consume", "unit": "regions",
                               "better": "higher", "source": "program_span",
                               "layer": "host enrich and writes",
                               "moves": "pages_per_s", "workloads": ["tiny"]})
    for p, data in before.items():  # nothing that was there changed
        assert open(p, "rb").read() == data
    out = harness.run_cell(bench, "tiny", 77, 0.1, True, device="cpu",
                           workers=2, root=str(root))
    assert out["metrics"]["regions_per_consume"]["value"] >= 1
    assert out["correct"] is True
    # the new cell reports the per-layer metrics that list it, and no other
    assert set(out["metrics"]) == {"regions_per_consume"}
