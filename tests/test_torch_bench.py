"""``python -m synapta_tpu_torch.bench`` on the CPU.

- ``main(["--device", "cpu"])`` over an 8-page book, one rep, into a
  temporary cache directory: the card line first, a line for the book and
  the warmup, one line per rep, and the root bench's contract keys on the
  last line; the book is cached under the root bench's file name (the
  port's generator is a verbatim copy, so its md5 is the JAX package's).
- ``--device cuda`` raises without CUDA: no CPU fallback.
"""
import hashlib
import json
import os
import tempfile

import pytest
import torch

import synapta_tpu.io.pdf_writer as jax_pdf_writer
from synapta_tpu_torch import bench

from torchfixtures import pin_threads

pin_threads()

CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline", "runs", "spread"}


def test_bench_main_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("SYNAPTA_BENCH_PAGES", "8")
    monkeypatch.setenv("SYNAPTA_BENCH_RUNS", "1")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    book, warm, rep, last = (json.loads(ln) for ln in lines[1:])
    with open(jax_pdf_writer.__file__, "rb") as f:
        gen_hash = hashlib.md5(f.read()).hexdigest()[:10]
    assert book["book"] == os.path.join(
        str(tmp_path), "synapta_bench_books", f"textbook_p8_s42_{gen_hash}.pdf")
    assert not book["cached"] and book["gen_s"] > 0 and warm["warmup_s"] > 0
    assert rep["rep"] == 1 and rep["pages"] == 8 and rep["errors"] == 0
    assert rep["segments"] == 8 and rep["stage_s"]["features_dispatch"] > 0
    assert os.path.exists(os.path.join(rep["out"], "textbook_001_visual_segments.json"))
    assert set(last) == CONTRACT_KEYS
    assert last["metric"] == "pages_per_sec_per_chip_end_to_end_textbook_001"
    assert last["unit"] == "pages/s" and last["vs_baseline"] is None
    assert last["runs"] == [round(8 / rep["wall_s"], 3)] and last["spread"] == 0.0
    assert last["value"] == last["runs"][0]


def test_bench_cuda_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda"])
    assert not os.listdir(tmp_path)  # raised before any book was made
