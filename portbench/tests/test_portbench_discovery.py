"""What a configuration adds as new files in a copy of the benchmark is
found by name, with no edit to a file that is there, and the run uses it
(CPU, tiny books): a configuration, a traffic mix, a span, a per-layer
metric, its own vision-LLM client and its own comparison. A span whose
target the program lacks is skipped, and a configuration without the new
keys reads the numbers it read before."""
import functools
import json
import os
import shutil
import weakref

import pytest

from portbench import check, harness, tracing

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
FAKE = "synapta_tpu_torch.llm.fake:FakePixtralClient"
SUMMARY = "Fake analysis of the visual element."

SPAN = '''"""consume: the enrich stage's segment loop of one super-batch."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._consume_batch"


def attrs(args, kwargs, result):
    return {"regions": len(args[1][0])}
'''
GHOST = '''"""ghost: a layer that a later tree of the program adds."""
TARGET = "synapta_tpu_torch.pipeline:VisualSegmentationPipeline._ghost_stage"
'''
METRIC = '''"""Regions a consume span, over the window."""


def read(run):
    spans = [s for s in run.spans if s.name == "consume"]
    return sum(s.attrs["regions"] for s in spans) / len(spans) if spans else None
'''
# A comparison of the configured client's answers: the sampled
# comprehensive analyses' confidences against the one the client's model
# states (0.9); the control states it in sixteenths.
TOY = '''"""toy_conf_gap: widest |served - reference| confidence of the sampled
comprehensive analyses of the configured client."""
import numpy as np

from portbench.check import Reservoir

STATED = 0.9


def install(seed, k):
    from synapta_tpu_torch.llm.fake import FakePixtralClient as cls

    res = Reservoir(k, np.random.default_rng([seed, 7]))
    orig = cls.__dict__["analyze_comprehensive"]

    def analyze(client, pixels, ocr):
        out = orig(client, pixels, ocr)
        i = res.slot()
        if i is not None:
            res.put(i, (np.array(pixels), float(out["confidence"])))
        return out

    cls.analyze_comprehensive = analyze
    return res, [lambda: setattr(cls, "analyze_comprehensive", orig)]


def to_host(res):
    return res.items


def numbers(items, device, control):
    import torch

    ref = torch.tensor(STATED, dtype=torch.float64, device=device)
    if control:
        ref = torch.round(ref * 16) / 16
    served = torch.tensor([c for _, c in items], dtype=torch.float64, device=device)
    return {"toy_conf_gap": float((served - ref).abs().max()) if items else None}
'''


def checkout(tmp_path):
    """A copy of the benchmark, and what each of its files held."""
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in
              map(str, (root / "portbench").rglob("*")) if os.path.isfile(p)}
    return root, before


def add_cell(root, bench, name, **config):
    """A configuration ``tiny_<name>`` (``textbook_digital`` with ``config``
    over it), the tiny mix and the cell ``name``, as new files."""
    cfg = json.load(open(root / "portbench/configs/textbook_digital.json"))
    cfg.update(config, name=f"tiny_{name}")
    (root / f"portbench/configs/tiny_{name}.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(
        {"generator": "test_book", "pages": [2], "books": 2, "warmup_pages": 1,
         "why": "two 2-page books"}))
    bench["configs"].append({"name": f"tiny_{name}", "source": "test",
                             "file": f"portbench/configs/tiny_{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": f"tiny_{name}",
                               "traffic": "tiny", "chips": 1, "why": "test"})


def unchanged(before):
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def spy(monkeypatch, name, after=None, before=None):
    """Wrap ``check.<name>``: ``before(args)`` sees each call, and
    ``after(args, result)`` its result."""
    orig = getattr(check, name)

    def wrapped(*args, **kw):
        if before is not None:
            before(args)
        out = orig(*args, **kw)
        if after is not None:
            after(args, out)
        return out

    monkeypatch.setattr(check, name, wrapped)


def test_new_files_are_found_by_name(tmp_path):
    root, before = checkout(tmp_path)
    bench = json.load(open(root / "BENCHMARK.json"))
    add_cell(root, bench, "tiny")
    (root / "portbench/spans/consume.py").write_text(SPAN)
    (root / "portbench/metrics/regions_per_consume.py").write_text(METRIC)
    bench["per_layer"].append({"name": "regions_per_consume", "unit": "regions",
                               "better": "higher", "source": "program_span",
                               "layer": "host enrich and writes",
                               "moves": "pages_per_s", "workloads": ["tiny"]})
    unchanged(before)
    out = harness.run_cell(bench, "tiny", 77, 0.1, True, device="cpu",
                           workers=2, root=str(root))
    assert out["metrics"]["regions_per_consume"]["value"] >= 1
    assert out["correct"] is True
    # the new cell reports the per-layer metrics that list it, and no other
    assert set(out["metrics"]) == {"regions_per_consume"}


def plant_wrong_confidence(monkeypatch):
    """Every comprehensive analysis answered at confidence 0.5, where the
    client produces it."""
    from synapta_tpu_torch.llm.fake import FakePixtralClient

    orig = FakePixtralClient.analyze_comprehensive
    monkeypatch.setattr(FakePixtralClient, "analyze_comprehensive",
                        lambda self, pixels, ocr: dict(orig(self, pixels, ocr),
                                                       confidence=0.5))


@pytest.mark.parametrize("case", ["program", "control", "fault"])
def test_a_configuration_brings_its_client_and_comparison(tmp_path, monkeypatch,
                                                          capsys, case):
    from synapta_tpu_torch.llm.fake import FakePixtralClient

    root, before = checkout(tmp_path)
    bench = json.load(open(root / "BENCHMARK.json"))
    limits = dict(json.load(open(root / "portbench/configs/textbook_digital.json"))["limits"],
                  toy_conf_gap=0.01, llm_failures=0)
    add_cell(root, bench, "llm", pipeline={"use_vision_llm": True},
             vision_llm={"client": FAKE, "args": {}}, compare=["toy"], limits=limits)
    (root / "portbench/compare").mkdir()
    (root / "portbench/compare/toy.py").write_text(TOY)
    (root / "portbench/spans/consume.py").write_text(SPAN)
    (root / "portbench/spans/ghost.py").write_text(GHOST)
    (root / "portbench/metrics/regions_per_consume.py").write_text(METRIC)
    bench["per_layer"].append({"name": "regions_per_consume", "unit": "regions",
                               "better": "higher", "source": "program_span",
                               "layer": "host enrich and writes",
                               "moves": "pages_per_s", "workloads": ["llm"]})
    unchanged(before)

    # every client the factory makes, and whether one lives when each
    # comparison starts
    clients, alive = [], []
    init = FakePixtralClient.__init__

    @functools.wraps(init)
    def watched(self, *a, **kw):
        init(self, *a, **kw)
        clients.append(weakref.ref(self))

    monkeypatch.setattr(FakePixtralClient, "__init__", watched)
    spy(monkeypatch, "compare", before=lambda a: alive.append(
        ("compare", [c() is not None for c in clients])))
    orig_comparisons = check.comparisons

    def comparisons(names, root_):
        mods = orig_comparisons(names, root_)
        for mod in mods.values():
            def numbers(caps, device, control, f=mod.numbers):
                alive.append(("toy", [c() is not None for c in clients]))
                return f(caps, device, control)

            mod.numbers = numbers
        return mods

    monkeypatch.setattr(check, "comparisons", comparisons)
    numbers, summaries = [], []
    spy(monkeypatch, "verdict", lambda a, out: numbers.append(a[0]))

    def read_segments(args, out):
        for b in args[0]:
            with open(os.path.join(args[1], b["book_id"],
                                   f"{b['book_id']}_visual_segments.json")) as f:
                summaries.extend(s["summary"] for s in json.load(f)["segments"])

    spy(monkeypatch, "outputs", read_segments)
    if case == "fault":
        plant_wrong_confidence(monkeypatch)

    out = harness.run_cell(bench, "llm", 2 ** 33 + 5, 0.1, True, device="cpu",
                           workers=2, root=str(root), control=case == "control")
    err = capsys.readouterr().err
    assert err.count("spans/ghost.py skipped") == 1
    assert "VisualSegmentationPipeline._ghost_stage" in err
    # the other spans recorded, the new one among them
    assert out["metrics"]["regions_per_consume"]["value"] >= 1
    # the configured client served the pipeline's calls in the window
    assert len(clients) == 1
    assert numbers[0]["llm_calls"] > 0 and numbers[0]["llm_failures"] == 0
    assert summaries and all(s == SUMMARY for s in summaries)
    # freed before any comparison ran
    assert alive == [("compare", [False]), ("toy", [False])]
    row = out["checks"]["toy_conf_gap"]
    assert row["limit"] == 0.01
    if case == "program":
        assert out["correct"] is True, out["checks"]
        assert row["value"] == 0.0
    else:
        assert out["correct"] is False
        assert row["value"] > row["limit"]
        assert row["value"] == pytest.approx(0.025 if case == "control" else 0.4)


def test_without_the_new_keys_the_numbers_are_the_builtin_ones(tmp_path, monkeypatch):
    """The numbers are those of the built-in comparisons and the written
    books, as the harness read them before a configuration could add its
    own: no client, no ``llm_*`` count."""
    root, _ = checkout(tmp_path)
    bench = json.load(open(root / "BENCHMARK.json"))
    add_cell(root, bench, "plain")
    parts, numbers = {}, []
    spy(monkeypatch, "compare", lambda a, out: parts.update(out))
    spy(monkeypatch, "outputs", lambda a, out: parts.update(out))
    spy(monkeypatch, "verdict", lambda a, out: numbers.append(a[0]))
    out = harness.run_cell(bench, "plain", 77, 0.1, False, device="cpu",
                           workers=2, root=str(root))
    assert numbers == [parts]
    assert set(parts) == {"analyze_diff", "rec_gap", "books_incomplete",
                          "visuals_missed"}
    assert out["correct"] is True


def test_a_listed_comparison_without_its_file_fails_the_run(tmp_path):
    root, _ = checkout(tmp_path)
    bench = json.load(open(root / "BENCHMARK.json"))
    add_cell(root, bench, "lost", compare=["nowhere"])
    with pytest.raises(SystemExit, match="compare/nowhere.py"):
        harness.run_cell(bench, "lost", 1, 0.1, False, device="cpu", root=str(root))


@pytest.mark.parametrize("target", ["json:loads", "synapta_tpu.llm.fake:FakePixtralClient",
                                    "synapta_tpu_torchx.llm:make", "synapta_tpu_torch.llm.fake"])
def test_a_client_outside_the_program_is_refused(target):
    with pytest.raises(SystemExit, match="vision_llm client"):
        harness.make_client({"client": target}, "cpu", 1)


def test_the_factory_gets_device_and_seed_where_it_names_them(monkeypatch):
    import synapta_tpu_torch.llm.fake as fake

    monkeypatch.setattr(fake, "probe", lambda seed, model="m": (seed, model),
                        raising=False)
    assert harness.make_client({"client": "synapta_tpu_torch.llm.fake:probe",
                                "args": {"model": "x"}}, "cpu", 2 ** 33) == (2 ** 33, "x")
    client = harness.make_client({"client": FAKE, "args": {"enabled": False}}, "cpu", 3)
    assert client.enabled is False


def test_a_span_without_its_target_is_skipped(tmp_path, capsys):
    (tmp_path / "spans").mkdir()
    (tmp_path / "spans/dumps.py").write_text('TARGET = "json:dumps"\n')
    (tmp_path / "spans/no_module.py").write_text('TARGET = "portbench.nowhere:f"\n')
    (tmp_path / "spans/no_attr.py").write_text('TARGET = "json:JSONEncoder.nowhere"\n')
    rec = tracing.Recorder()
    undo = tracing.install(rec, str(tmp_path))
    try:
        json.dumps([1])
    finally:
        for u in undo:
            u()
    err = capsys.readouterr().err.splitlines()
    assert len(undo) == 1 and [s.name for s in rec.spans] == ["dumps"]
    assert len(err) == 2
    assert "spans/no_attr.py skipped: no json:JSONEncoder.nowhere" in err[0]
    assert "spans/no_module.py skipped: no portbench.nowhere:f" in err[1]
    assert not hasattr(json.dumps, "__wrapped__")  # undone
