"""synapta_tpu_torch — the PyTorch + CUDA port of synapta_tpu for NVIDIA Hopper.

The JAX package (``synapta_tpu``) stays the reference; this package mirrors
its module names so each counterpart is easy to find:

  - device.py        explicit device resolution (no silent CPU fallback)
  - csrc/            hand-written CUDA kernels (sm_90a), built with nvcc at
                     first use and loaded with ctypes (ops/_build.py)
  - ops/             image ops in plain PyTorch plus the two kernel wrappers
                     (connected components, fused edge statistics)
  - models/          the CTC recognizer and the DB line detector as
                     nn.Modules, their trainers, and a jax-free reader and
                     writer for the flax msgpack weight files
  - ocr/             fused text-line boxes and the batched OCR driver
  - vision/          classification heuristics over the feature batch
  - parallel/        multi-device execution: the data mesh of the pipeline
                     (one process, a stream per shard), the ("data", "model")
                     rank mesh and the dp x tp training step
                     (torch.distributed), and the multi-device dry run
  - pipeline.py      the streaming orchestrator (public entry point)
  - cli.py           ``python -m synapta_tpu_torch.cli``
  - eval.py, serve.py  quality evaluation and the multi-book queue
  - graft_entry.py   ``entry()`` (the recognizer's forward step) and
                     ``dryrun_multichip()``

  - config.py, schema.py, io/, utils/, llm/, linker/, models/charset.py,
    vision/{detect,captions}.py, ocr/heuristics.py
                     the host-only modules, verbatim copies of the JAX
                     package's (tests/test_torch_pipeline.py pins them)

The port imports nothing of ``synapta_tpu``. Two files of its tree are read
by path from the repo root: the native PDF engine binary
(``synapta_tpu/io/_pdf_native.so``, built by ``native/Makefile``) and the
weight files (``synapta_tpu/models/weights/*.msgpack``).
"""

__version__ = "0.1.0"
