"""The PyTorch port end to end vs the JAX pipeline, plus the port's rules.

- A 3-page book through the port on the CPU and through the JAX pipeline
  (Pallas edge kernel route, one data device): identical segment ids,
  pages, bboxes, types, captions and figure numbers; OCR block texts >= 95%
  equal (measured on the CPU: 21 of 21 blocks, 100%).
- ``import synapta_tpu_torch.pipeline`` (fresh process) loads no jax/flax
  and no module of the JAX package; no file of the port and not
  chip_smoke.py imports either (read from the syntax tree).
- Every verbatim host-code copy (functions and whole host modules) equals
  its original source, except that ``from synapta_tpu`` imports name
  ``synapta_tpu_torch`` and for the named substitutions (the one device
  argument of collect_tiles, the engine binary's path, the dropped
  ``jax_trace``, reference-project files named from its root).
- No silent fallback: "cuda" raises without CUDA; the DB detector routes
  raise NotImplementedError.
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

from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
from synapta_tpu_torch.config import OCRConfig, PipelineConfig
from synapta_tpu_torch.llm.fake import DisabledClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    pdf = str(d / "book.pdf")
    make_test_book(pdf, pages=3, seed=11)
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

    import synapta_tpu.ops.features as jfeat
    from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe

    mp = pytest.MonkeyPatch()
    mp.setattr(jfeat, "_pallas_wanted", lambda: True)
    try:
        jp = JaxPipe("tb", pdf, output_dir=str(d / "jax"),
                     config=JaxPipelineConfig(use_vision_llm=False,
                                              data_devices=1),
                     llm_client=JaxDisabledClient(), resume=False)
        j_segs = jp.process()
        jp.close()
    finally:
        mp.undo()
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
        "synapta_tpu_torch.cli, synapta_tpu_torch.ops.features; "
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
    "llm.fake", "linker.concepts", "io.pdf_writer",
)


def _module_subs(name, orig):
    """Named substitutions of a whole-module copy, besides the imports."""
    if name == "utils.profiler":  # jax_trace stays behind
        return [
            ("Stage timers aggregate wall time per pipeline stage; ``jax_trace`` "
             "wraps a\nblock in the JAX profiler for TensorBoard-viewable "
             "device traces.\n",
             "Stage timers aggregate wall time per pipeline stage.\n"),
            ("import os\n", ""),
            ("\n\n" + inspect.getsource(orig.jax_trace), ""),
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
    import synapta_tpu.ops.color as jc
    import synapta_tpu.ops.features as jf
    import synapta_tpu.ops.kmeans as jk
    import synapta_tpu.pipeline as jpipe
    import synapta_tpu.vision.classify as jcls
    import synapta_tpu.vision.local_analysis as jla
    import synapta_tpu_torch.ocr.linedet as tl
    import synapta_tpu_torch.ocr.processor as tp
    import synapta_tpu_torch.ops.color as tc
    import synapta_tpu_torch.ops.features as tf
    import synapta_tpu_torch.ops.kmeans as tk
    import synapta_tpu_torch.pipeline as tpipe
    import synapta_tpu_torch.vision.classify as tcls
    import synapta_tpu_torch.vision.local_analysis as tla

    out = [
        ("classify", tcls, jcls,
         [("from synapta_tpu.ops.cc import component_stats\n", "")]),
        ("local_analysis", tla, jla, []),
        ("gray_quarter_host", tc.gray_quarter_host, jc.gray_quarter_host, []),
        ("colors_to_hex", tk.colors_to_hex, jk.colors_to_hex, []),
        ("extract_line_boxes", tl.extract_line_boxes, jl.extract_line_boxes, []),
        ("unpack_analysis", tf.unpack_analysis, jf.unpack_analysis, []),
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
        out.append((name, port, orig, _module_subs(name, orig)))
    return out


def _port_text(src):
    """Every ``from synapta_tpu...`` import names the port's package, and
    files of the reference project are named from its root, not by an
    absolute path."""
    src = re.sub(r"/\w+/reference/", "reference/", src)
    return re.sub(r"^(\s*)from synapta_tpu([. ])", r"\1from synapta_tpu_torch\2",
                  src, flags=re.M)


@pytest.mark.parametrize("idx", range(51))
def test_verbatim_copy(idx):
    copies = _copies()
    assert len(copies) == 51
    name, port, orig, subs = copies[idx]
    unwrap = lambda o: o.__func__ if isinstance(o, staticmethod) else o  # noqa: E731
    want = inspect.getsource(unwrap(orig))
    for a, b in subs:
        assert want.count(a) == 1, (name, a)
        want = want.replace(a, b)
    assert inspect.getsource(unwrap(port)) == _port_text(want), name


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


def test_db_routes_raise(book):
    from synapta_tpu_torch.ocr.processor import TorchOCR

    with pytest.raises(NotImplementedError):
        TorchOCR(OCRConfig(line_detector="db"), device="cpu")
    ocr = TorchOCR(OCRConfig(), device="cpu")
    with pytest.raises(NotImplementedError):
        ocr.db_detector


def test_scanned_like_crop_raises(monkeypatch, book):
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    pdf, d = book
    monkeypatch.setattr(VisualSegmentationPipeline, "_scanned_like",
                        lambda self, region: True)
    pipe = VisualSegmentationPipeline(
        "scan", pdf, output_dir=str(d / "scan"),
        config=PipelineConfig(use_vision_llm=False),
        llm_client=DisabledClient(), resume=False, device="cpu")
    with pytest.raises(NotImplementedError):
        pipe.process()
    pipe.close()
