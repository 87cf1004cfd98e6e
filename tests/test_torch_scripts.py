"""The JAX package's batch-shape sweep on the PyTorch port, on the CPU.

scripts/torch_sweep.py is the counterpart of scripts/sweep_r3.py: the same
six chunk shapes (``CFGS``), the same per-run line and best-of line.

- ``make_test_book(8, seed=11)`` (the whole page cycle) at ``cb32lb256``
  (32-crop analyze chunks, 256-tile recognizer batches) through the port and
  through the JAX pipeline (one data device, as every port parity test runs
  it): the two ``*_visual_segments.json`` are equal key by key and the CSVs
  cell by cell under ``chip_smoke.ALLOWED_DIFFERENCES``.
- The same book through the port at ``cb64lb256`` and at ``base`` (16 crops,
  128 tiles): the same comparison, port against port.
- Each of the three ported scripts (the sweep, scripts/torch_mpl_scale.py,
  scripts/torch_real_corpus.py) raises under ``--device cuda`` without CUDA,
  before it writes anything (the sweep's ``main`` on the CPU runs in
  tests/test_torch_script_books.py, which balances the two files' time).

The analyze pass's plain twins take about a second a crop on one CPU
thread, padding crops included, so the 64-crop chunk is most of this
file's time.
"""
import inspect
import os
import tempfile

import pytest
import torch

from chip_smoke import helper_module, payload_differences
from synapta_tpu.config import OCRConfig as JaxOCRConfig
from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
from synapta_tpu.io.pdf_writer import make_test_book
from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe
from synapta_tpu_torch.llm.fake import DisabledClient
from synapta_tpu_torch.pipeline import VisualSegmentationPipeline as TorchPipe

from torchfixtures import pin_threads

pin_threads()


def load_script(name):
    """scripts/<name>.py as a module (its top level only)."""
    return helper_module(name, "scripts")


sweep = load_script("torch_sweep")
jax_sweep = load_script("sweep_r3")


@pytest.fixture(scope="module")
def book(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sweep")
    pdf = str(d / "book.pdf")
    make_test_book(pdf, pages=8, seed=11)
    return pdf, d


def _port_run(pdf, d, name):
    """The port's run of the book at one sweep configuration -> its output
    directory (book id "tb", as in tests/test_torch_pipeline.py)."""
    out = str(d / f"t_{name}")
    tp = TorchPipe("tb", pdf, output_dir=out, config=sweep.sweep_config(name),
                   llm_client=DisabledClient(), resume=False, device="cpu")
    tp.process()
    tp.close()
    assert tp.stats.errors == 0
    return out, tp


def _assert_same_payloads(out_a, out_b):
    outside, _, csv_equal = payload_differences(out_a, out_b, "tb")
    assert not outside, outside
    assert csv_equal


def test_sweep_configurations_are_the_jax_scripts():
    assert sweep.CFGS == jax_sweep.CFGS
    src = inspect.getsource(jax_sweep.main)
    assert all(f'"{k}"' in src for k in sweep.KEY_STAGES)
    cfg = sweep.sweep_config("cb64lb256")
    assert (cfg.ocr.crop_batch, cfg.ocr.line_batch, cfg.pages_per_batch) == (64, 256, 64)
    assert sweep.sweep_config("ppb32").pages_per_batch == 32


def test_cb32lb256_json_and_csv_equal_the_jax_pipelines(book):
    pdf, d = book
    out, tp = _port_run(pdf, d, "cb32lb256")
    assert tp.mesh.shape == {"data": 1}
    assert (tp.ocr.cfg.crop_batch, tp.ocr.cfg.line_batch) == (32, 256)
    ov = sweep.CFGS["cb32lb256"]
    jp = JaxPipe("tb", pdf, output_dir=str(d / "j_cb32lb256"),
                 config=JaxPipelineConfig(use_vision_llm=False, data_devices=1,
                                          ocr=JaxOCRConfig(**ov)),
                 llm_client=JaxDisabledClient(), resume=False)
    jp.process()
    jp.close()
    assert jp.stats.errors == 0 and jp.stats.segments == tp.stats.segments == 8
    _assert_same_payloads(out, str(d / "j_cb32lb256"))


def test_cb64lb256_json_and_csv_equal_the_ports_base(book):
    pdf, d = book
    base, _ = _port_run(pdf, d, "base")
    wide, tp = _port_run(pdf, d, "cb64lb256")
    assert tp.stats.segments == 8
    _assert_same_payloads(wide, base)


@pytest.mark.parametrize("script", ["torch_sweep", "torch_mpl_scale",
                                    "torch_real_corpus"])
def test_script_cuda_raises_without_cuda(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = {"torch_sweep": ["1", "base"],
            "torch_mpl_scale": ["--pages", "1", "--book", str(tmp_path / "b.pdf"),
                                "--out", str(tmp_path / "out")],
            "torch_real_corpus": ["--out", str(tmp_path / "out")]}[script]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_script(script).main([*argv, "--device", "cuda"])
    assert not os.listdir(tmp_path)  # raised before any book was made
