"""The PyTorch port end to end vs the JAX pipeline, plus the port's rules.

- ``make_test_book(pages=8, seed=11)``, the whole page cycle (text, bar
  chart, line chart, flowchart whose diagram payload counts its connections
  from ``line_pixels``, photo, pie chart, table image, two visuals), through
  the port on the CPU and through the JAX pipeline, both on their default
  routes (one data device): identical segment ids, pages, bboxes, types,
  captions and figure numbers; OCR block texts >= 95% equal (measured on the
  CPU: 77 of 77 blocks); and the two runs' ``*_visual_segments.json`` and
  ``*_visual_summary.csv`` equal key by key and cell by cell, apart from the
  entries of ``chip_smoke.ALLOWED_DIFFERENCES``, each of which this book
  needs.
- ``import synapta_tpu_torch.pipeline`` (fresh process) loads no jax/flax
  and no module of the JAX package; no file of the port and not
  chip_smoke.py imports either (read from the syntax tree).
- Every verbatim host-code copy (functions, the refine knobs and whole
  host modules, the training-line generator and the detector's synthetic
  pages and targets among them) equals its original source, except that ``from
  synapta_tpu`` imports name ``synapta_tpu_torch`` and for the named
  substitutions (the device arguments of collect_tiles, db_detector, the
  evaluations and the book queue; the DB detector's device dispatch; the
  engine binary's path; ``torch_trace`` in the place of ``jax_trace``;
  reference-project files named from its root).
- No silent fallback: "cuda" raises without CUDA. ``line_detector="db"``
  binds the DB detector on the OCR's device.
"""
import ast
import inspect
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from chip_smoke import ALLOWED_DIFFERENCES, allowed_difference, json_differences
from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
from synapta_tpu_torch.config import OCRConfig, PipelineConfig
from synapta_tpu_torch.llm.fake import DisabledClient

from torchfixtures import pin_threads

pin_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    pdf = str(d / "book.pdf")
    make_test_book(pdf, pages=8, seed=11)
    return pdf, d


def _seg_key(s):
    b = s.bbox
    return (s.segment_id, s.page_no, (b.x0, b.y0, b.x1, b.y1),
            str(s.segment_type), s.caption_text, s.figure_number)


@pytest.fixture(scope="module")
def both_runs(book):
    pdf, d = book
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline as TorchPipe

    tp = TorchPipe("tb", pdf, output_dir=str(d / "torch"),
                   config=PipelineConfig(use_vision_llm=False),
                   llm_client=DisabledClient(), resume=False, device="cpu")
    t_segs = tp.process()
    tp.close()

    from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe

    jp = JaxPipe("tb", pdf, output_dir=str(d / "jax"),
                 config=JaxPipelineConfig(use_vision_llm=False, data_devices=1),
                 llm_client=JaxDisabledClient(), resume=False)
    j_segs = jp.process()
    jp.close()
    return tp, t_segs, jp, j_segs


def test_segments_identical(both_runs):
    tp, t_segs, jp, j_segs = both_runs
    assert tp.stats.errors == 0 and jp.stats.errors == 0
    assert len(t_segs) >= 2
    assert [_seg_key(s) for s in t_segs] == [_seg_key(s) for s in j_segs]


def test_ocr_blocks_agree(both_runs):
    _, t_segs, _, j_segs = both_runs
    equal = total = 0
    for ts, js in zip(t_segs, j_segs):
        tb = [b["text"] for b in ts.ocr_result.blocks]
        jb = [b["text"] for b in js.ocr_result.blocks]
        total += max(len(tb), len(jb))
        equal += sum(a == b for a, b in zip(tb, jb))
    assert total > 0 and equal / total >= 0.95, (equal, total)


def test_outputs_written(both_runs, book):
    _, t_segs, _, _ = both_runs
    out = book[1] / "torch"
    payload = json.load(open(out / "tb_visual_segments.json"))
    assert payload["total_segments"] == len(t_segs)
    assert (out / "tb_visual_summary.csv").exists()


def test_segment_json_and_csv_equal_the_jax_pipelines(both_runs, book):
    """The whole payloads the two runs wrote, read back from disk."""
    import csv

    outs = [book[1] / "torch", book[1] / "jax"]
    t_json, j_json = (json.load(open(o / "tb_visual_segments.json")) for o in outs)
    assert t_json["total_segments"] == j_json["total_segments"] == 8
    assert {s["segment_type"] for s in t_json["segments"]} == {
        "chart", "flowchart", "image"}
    flow = [s for s in t_json["segments"] if s["segment_type"] == "flowchart"]
    assert flow and flow[0]["diagram_data"]["connections"]  # from line_pixels
    used, faults = set(), []
    for path, a, b in json_differences(t_json, j_json):
        entry = allowed_difference(path, a, b)
        if entry is None:
            faults.append((path, a, b))
        used.add(entry)
    assert not faults, faults
    # a stale entry goes: each one is needed by this book
    assert used == set(range(len(ALLOWED_DIFFERENCES))), used
    # what the classifier decides from the edge counts is compared, not excused
    for probe in ("segments[0].chart_data.chart_subtype",
                  "segments[0].chart_data.grid_detected",
                  "segments[0].chart_data.estimated_data_points",
                  "segments[2].diagram_data.connections[0].from",
                  "segments[0].segment_type"):
        assert not any(re.fullmatch(p, probe) for p, *_ in ALLOWED_DIFFERENCES)
    t_csv, j_csv = (list(csv.reader(open(o / "tb_visual_summary.csv", newline="")))
                    for o in outs)
    assert t_csv == j_csv and len(t_csv) == 1 + t_json["total_segments"]


def test_cli_runs_on_cpu(book):
    from synapta_tpu_torch.cli import main

    pdf, d = book
    out = d / "cli"
    assert main(["--pdf", pdf, "--book-id", "cli", "--output-dir", str(out),
                 "--device", "cpu", "--no-llm", "--no-resume"]) == 0
    assert (out / "cli_visual_segments.json").exists()


_BANNED = ("synapta_tpu", "jax", "flax", "jaxlib")


def test_import_is_jax_free():
    code = (
        "import sys, synapta_tpu_torch, synapta_tpu_torch.pipeline, "
        "synapta_tpu_torch.cli, synapta_tpu_torch.ops.features, "
        "synapta_tpu_torch.models.detector, synapta_tpu_torch.eval, "
        "synapta_tpu_torch.serve, synapta_tpu_torch.models.train, "
        "synapta_tpu_torch.models.synthdata, synapta_tpu_torch.models.optim, "
        "synapta_tpu_torch.parallel.mesh, synapta_tpu_torch.parallel.launch, "
        "synapta_tpu_torch.parallel.dryrun, synapta_tpu_torch.graft_entry; "
        "print(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {_BANNED!r}))"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert res.stdout.strip() == "[]", res.stdout


def _imported_roots(tree):
    """Top-level package of every import in a module, at any depth
    (including imports inside functions and importlib/__import__ calls
    with a literal name)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_no_jax_import_lines_in_port():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "synapta_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for f in files:
        roots = set(_imported_roots(ast.parse(open(f).read(), f)))
        assert not roots & set(_BANNED), (f, sorted(roots & set(_BANNED)))


# The host modules the port keeps its own copies of, in dependency order.
_HOST_MODULES = (
    "utils.log", "utils.profiler", "schema", "config", "models.charset",
    "io.ingest", "io.writers", "io.xlsx", "io.loader", "vision.captions",
    "vision.detect", "ocr.heuristics", "llm.prompts", "llm.pixtral",
    "llm.fake", "linker.concepts", "io.pdf_writer", "models.synthdata",
)


def _module_subs(name, orig, port):
    """Named substitutions of a whole-module copy, besides the imports."""
    if name == "utils.profiler":
        # StageTimers is the copy; torch_trace (torch.profiler, the same
        # SYNAPTA_TRACE_DIR) stands where jax_trace stood
        return [
            ("``jax_trace`` wraps a\nblock in the JAX profiler",
             "``torch_trace`` wraps a\nblock in the PyTorch profiler"),
            (inspect.getsource(orig.jax_trace),
             inspect.getsource(port.torch_trace)),
        ]
    if name == "io.ingest":  # the engine binary, read by path from the repo root
        return [
            ("# harness to point at an ASan build without touching the "
             "installed lib\n",
             "# harness to point at an ASan build without touching the "
             "installed lib\n"
             "# The port shares the engine binary that native/Makefile builds "
             "into the JAX\n"
             "# package's tree: it is read by file path from the repo root, "
             "never imported.\n"),
            ('    os.path.join(os.path.dirname(__file__), "_pdf_native.so"),\n',
             "    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(\n"
             '        os.path.abspath(__file__)))), "synapta_tpu", "io", '
             '"_pdf_native.so"),\n'),
        ]
    return []


def _copies():
    """(name, port object, original object, [(original text, port text)])."""
    import importlib

    import synapta_tpu.ocr.linedet as jl
    import synapta_tpu.ocr.processor as jp
    import synapta_tpu.ops.cc as jcc
    import synapta_tpu.ops.color as jc
    import synapta_tpu.ops.features as jf
    import synapta_tpu.ops.kmeans as jk
    import synapta_tpu.pipeline as jpipe
    import synapta_tpu.vision.classify as jcls
    import synapta_tpu.vision.local_analysis as jla
    import synapta_tpu_torch.ocr.linedet as tl
    import synapta_tpu_torch.ocr.processor as tp
    import synapta_tpu_torch.ops.cc as tcc
    import synapta_tpu_torch.ops.color as tc
    import synapta_tpu_torch.ops.features as tf
    import synapta_tpu_torch.ops.kmeans as tk
    import synapta_tpu_torch.pipeline as tpipe
    import synapta_tpu_torch.vision.classify as tcls
    import synapta_tpu_torch.vision.local_analysis as tla

    out = [
        ("classify", tcls, jcls, []),
        ("local_analysis", tla, jla, []),
        ("gray_quarter_host", tc.gray_quarter_host, jc.gray_quarter_host, []),
        ("colors_to_hex", tk.colors_to_hex, jk.colors_to_hex, []),
        ("extract_line_boxes", tl.extract_line_boxes, jl.extract_line_boxes, []),
        ("unpack_analysis", tf.unpack_analysis, jf.unpack_analysis, []),
        ("component_stats", tcc.component_stats, jcc.component_stats, []),
    ]
    ocr_subs = {"collect_tiles": [
        ("detect_lines(crops) if", "detect_lines(crops, self.device) if"),
    ]}
    for name in ("_line_tile", "recognize_tiles", "collect_tiles", "_crop_tiles",
                 "_split_long_line", "merge_parts", "gate_blocks",
                 "assemble_results", "process_group", "group_dispatch",
                 "group_sync", "process_batch"):
        out.append((f"ocr.{name}", tp.TorchOCR.__dict__[name],
                    jp.TPUOCR.__dict__[name], ocr_subs.get(name, [])))
    for name in ("close", "__del__", "_prepare_batch", "_scanned_like",
                 "_enrich_finish", "_consume_batch", "_snap_pixels",
                 "_build_segment", "_apply_analysis", "_apply_followup",
                 "_relink_and_update", "_register_analysis_patch",
                 "_register_followups", "_drain_patches", "_heading_path",
                 "_nearby_text"):
        out.append((f"pipeline.{name}",
                    tpipe.VisualSegmentationPipeline.__dict__[name],
                    jpipe.VisualSegmentationPipeline.__dict__[name], []))
    for name in _HOST_MODULES:
        orig = importlib.import_module(f"synapta_tpu.{name}")
        port = importlib.import_module(f"synapta_tpu_torch.{name}")
        out.append((name, port, orig, _module_subs(name, orig, port)))

    import synapta_tpu.eval as jev
    import synapta_tpu.models.detector as jdet
    import synapta_tpu.models.train as jtrain
    import synapta_tpu.serve as jserve
    import synapta_tpu_torch.eval as tev
    import synapta_tpu_torch.models.detector as tdet
    import synapta_tpu_torch.models.train as ttrain
    import synapta_tpu_torch.serve as tserve

    for name in ("unshrink_boxes", "_snap_box_to_ink", "refine_line_boxes",
                 "shrink_box", "render_det_page", "make_det_batch"):
        out.append((f"detector.{name}", getattr(tdet, name),
                    getattr(jdet, name), []))
    out.append(("detector.knobs", _knobs(tdet), _knobs(jdet), []))
    for name in ("_luma", "_views", "detect_lines"):
        out.append((f"detector.DBLineDetector.{name}",
                    tdet.DBLineDetector.__dict__[name],
                    jdet.DBLineDetector.__dict__[name],
                    _DETECT_LINES_SUBS if name == "detect_lines" else []))
    out.append(("ocr.db_detector", tp.TorchOCR.__dict__["db_detector"],
                jp.TPUOCR.__dict__["db_detector"], [
                    ("det_size=self.cfg.crop_size)",
                     "det_size=self.cfg.crop_size, device=self.device)")]))
    out.append(("pipeline._ocr_dispatch",
                tpipe.VisualSegmentationPipeline.__dict__["_ocr_dispatch"],
                jpipe.VisualSegmentationPipeline.__dict__["_ocr_dispatch"], []))
    out.append(("eval.cer", tev.cer, jtrain.cer, []))
    out.append(("train.cer", ttrain.cer, jtrain.cer, []))
    for name in ("norm_text", "_prep_standalone", "_box_iou", "_box_containment",
                 "_best_window_cer", "evaluate_golden_crop", "evaluate_book",
                 "evaluate_scanned"):
        out.append((f"eval.{name}", getattr(tev, name), getattr(jev, name),
                    _EVAL_SUBS.get(name, [])))
    out.append(("serve", tserve, jserve, _SERVE_SUBS))
    return out


def _knobs(module):
    """The refine knobs' block of the detector module's source."""
    m = re.search(r"^# refine knobs.*?^_FLOOR_FRAC = [^\n]*\n",
                  inspect.getsource(module), re.M | re.S)
    return m.group(0)


# DBLineDetector.detect_lines: the device dispatch and the copy back
_DETECT_LINES_SUBS = [
    ("_boxes_device(self.params, chunk, self.prob_thresh))",
     "boxes_device(self.model, chunk, self.prob_thresh))"),
    ("[np.asarray(p) for p in pending]", "[p.cpu().numpy() for p in pending]"),
]


# the evaluations name their device; cer is the module's own copy
_EVAL_SUBS = {
    "evaluate_golden_crop": [
        ('def evaluate_golden_crop(route: str = "production") -> Dict:\n',
         'def evaluate_golden_crop(route: str = "production",\n'
         '                         device="cuda") -> Dict:\n'),
        ("    \"\"\"Feed the reference's golden crop PNG through TPUOCR + the",
         "    \"\"\"Feed the reference's golden crop PNG through TorchOCR + the"),
        ("    from synapta_tpu.models.train import cer\n", ""),
        ("    from synapta_tpu.ocr.processor import TPUOCR\n",
         "    from synapta_tpu.ocr.processor import TorchOCR\n"),
        ("    from synapta_tpu.ops.features import device_analyze\n",
         "    from synapta_tpu.ops.features import (\n"
         "        device_analyze_dispatch,\n"
         "        unpack_analysis,\n"
         "    )\n"),
        ("    feats, boxes = device_analyze(\n"
         "        batch, sizes=np.array([(oh, ow)], np.int32)\n"
         "    )\n",
         "    feats, boxes = unpack_analysis(device_analyze_dispatch(\n"
         "        batch, sizes=np.array([(oh, ow)], np.int32), device=device\n"
         "    ).cpu().numpy(), 1)\n"),
        ("    ocr = TPUOCR(cfg.ocr)\n", "    ocr = TorchOCR(cfg.ocr, device=device)\n"),
    ],
    "evaluate_book": [
        ("def evaluate_book(pages: int = 16, seed: int = 3, use_llm: bool = False) -> Dict:\n",
         "def evaluate_book(pages: int = 16, seed: int = 3, use_llm: bool = False,\n"
         "                  device=\"cuda\") -> Dict:\n"),
        ("    from synapta_tpu.models.train import cer\n", ""),
        ("        resume=False,\n    )\n",
         "        resume=False,\n        device=device,\n    )\n"),
    ],
    "evaluate_scanned": [
        ("def evaluate_scanned(pages: int = 2, seed: int = 1) -> Dict:\n",
         "def evaluate_scanned(pages: int = 2, seed: int = 1,\n"
         "                     device=\"cuda\") -> Dict:\n"),
        ("    from synapta_tpu.models.train import cer\n", ""),
        ("        resume=False,\n    )\n",
         "        resume=False,\n        device=device,\n    )\n"),
    ],
}


# the book queue names its device; usage lines name the port
_SERVE_SUBS = [
    ("    python -m synapta_tpu.serve --books a.pdf b.pdf --output-root out/\n"
     "    python -m synapta_tpu.serve --books-dir shelf/ --output-root out/\n",
     "    python -m synapta_tpu_torch.serve --books a.pdf b.pdf --output-root out/\n"
     "    python -m synapta_tpu_torch.serve --books-dir shelf/ --output-root out/\n"
     "\n"
     "Every book's pipeline runs on ``--device`` (``BookQueue.device``; default\n"
     "``cuda``, which fails without a GPU; ``cpu`` runs the kernels' plain\n"
     "PyTorch twins).\n"),
    ("    llm_client: object = None      # shared fake/real client (None = per-book)\n",
     "    llm_client: object = None      # shared fake/real client (None = per-book)\n"
     "    device: str = \"cuda\"           # torch device of every book's pipeline\n"),
    ("        self._ocr = None           # shared TPUOCR across books\n",
     "        self._ocr = None           # shared TorchOCR across books\n"),
    ("                    ocr=self._ocr,\n                    resume=True,\n",
     "                    ocr=self._ocr,\n                    resume=True,\n"
     "                    device=self.device,\n"),
    ("                help=\"pages per super-batch (default: config's tuned value)\")\n"
     "    args = ap.parse_args(argv)\n",
     "                help=\"pages per super-batch (default: config's tuned value)\")\n"
     "    ap.add_argument(\"--device\", default=\"cuda\",\n"
     "                    help=\"torch device: cuda (default) or cpu\")\n"
     "    args = ap.parse_args(argv)\n"
     "    if argv is None:\n"
     "        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's\n"
     "        # copy where the system has none\n"
     "        from synapta_tpu.hostlibs import ensure_native_engine\n"
     "\n"
     "        ensure_native_engine([\"-m\", \"synapta_tpu_torch.serve\", *sys.argv[1:]])\n"),
    ("        llm_client=DisabledClient() if args.no_llm else None,\n    )\n",
     "        llm_client=DisabledClient() if args.no_llm else None,\n"
     "        device=args.device,\n    )\n"),
]


def _port_text(src):
    """Every ``from synapta_tpu...`` import names the port's package, and
    files of the reference project are named from its root, not by an
    absolute path."""
    src = re.sub(r"/\w+/reference/", "reference/", src)
    return re.sub(r"^(\s*)from synapta_tpu([. ])", r"\1from synapta_tpu_torch\2",
                  src, flags=re.M)


def _source(obj):
    if isinstance(obj, str):  # a block of module-level lines
        return obj
    if isinstance(obj, staticmethod):
        obj = obj.__func__
    elif isinstance(obj, property):
        obj = obj.fget
    return inspect.getsource(obj)


@pytest.mark.parametrize("idx", range(76))
def test_verbatim_copy(idx):
    copies = _copies()
    assert len(copies) == 76
    name, port, orig, subs = copies[idx]
    want = _source(orig)
    for a, b in subs:
        assert want.count(a) == 1, (name, a)
        want = want.replace(a, b)
    assert _source(port) == _port_text(want), name


def test_cuda_device_raises_without_cuda(monkeypatch, book):
    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        VisualSegmentationPipeline("x", book[0], output_dir=str(book[1] / "x"),
                                   device="cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_db_route_binds_detector():
    """line_detector="db" binds the DB detector eagerly on the OCR's device;
    "auto" binds it at first use, from the same process-wide cache."""
    from synapta_tpu_torch.models.detector import DBLineDetector
    from synapta_tpu_torch.ocr.processor import TorchOCR

    eager = TorchOCR(OCRConfig(line_detector="db"), device="cpu")
    assert isinstance(eager._db_detector, DBLineDetector)
    assert eager._db_detector.device.type == "cpu"
    assert next(eager._db_detector.model.parameters()).device.type == "cpu"
    lazy = TorchOCR(OCRConfig(), device="cpu")
    assert lazy._db_detector is None
    assert lazy.db_detector is eager._db_detector
