"""Multi-device dry run — counterpart of synapta_tpu/parallel/dryrun.py.

Exercises the two multi-device paths the port ships:

  1. the PIPELINE step — the fused crop-analysis dispatch plus recognizer
     inference, both with the batch dim cut over an N-shard data mesh of
     this process;
  2. the dp x tp TRAINING step for the CTC recognizer (batch on 'data',
     wide kernels on 'model') on N spawned ranks;

and then the whole pipeline on a 3-page book on 1 and on N shards, whose
segments must be equal.

Invoke as ``python -m synapta_tpu_torch.parallel.dryrun N [--device cpu|cuda]``.
The data mesh is virtual where there are fewer than N GPUs (the extra shards
are further streams of the GPUs there are; the CPU's shards run in turn),
which takes the place of the JAX package's forced host device count. The N
ranks use NCCL when each has a GPU of its own and gloo when they share GPUs
or run on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def _train_rank(rank: int, world: int, coordinator: str, device: str,
                backend: str, model_axis: int) -> tuple:
    """One rank of part 2: join, build the dp x tp mesh, take one step of
    the sharded CTC trainer on the global batch -> (mesh shape, loss)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models.optim import adamw
    from synapta_tpu_torch.models.recognizer import Recognizer, init_params
    from synapta_tpu_torch.models.synthdata import make_batch
    from synapta_tpu_torch.parallel.mesh import (
        init_distributed,
        make_dp_tp_train_step,
        make_mesh,
        mesh_shape,
        shard_params,
    )

    assert init_distributed(coordinator, world, rank, backend, device) is True
    try:
        ensure_synthdata_fonts()
        mesh = make_mesh(world, model_axis=model_axis, device=device)
        height, width = 32, 128
        model = init_params(
            Recognizer(dim=128, blocks=1, seq_len=width // 4,
                       dtype=torch.float32),
            torch.Generator().manual_seed(0))
        model = shard_params(model.to(device), mesh).train()
        step = make_dp_tp_train_step(model, adamw(model.parameters(), 1e-3), mesh)
        imgs, labels, lens = make_batch(
            np.random.default_rng(0), batch=max(world, 8), height=height,
            width=width, max_label=16)
        return mesh_shape(mesh), float(step(imgs, labels, lens))
    finally:
        dist.destroy_process_group()


def run(n_devices: int, device="cuda") -> None:
    import numpy as np
    import torch

    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.parallel.launch import run_ranks
    from synapta_tpu_torch.parallel.mesh import data_mesh

    dev = resolve_device(device)

    # ---- 1. pipeline inference step over the ('data',) mesh --------------
    dmesh = data_mesh(n_devices, dev, virtual=True)
    from synapta_tpu_torch.ops.features import _pallas_wanted, device_analyze

    rng = np.random.default_rng(0)
    B = max(2 * n_devices, 8)
    canvases = rng.integers(0, 255, (B, 128, 128, 3), dtype=np.uint8)
    sizes = np.full((B, 2), 128, np.int32)
    feats, boxes = device_analyze(canvases, sizes=sizes, mesh=dmesh,
                                  use_pallas=_pallas_wanted())
    assert feats["edge_count"].shape == (B,), feats["edge_count"].shape
    assert np.isfinite(feats["edge_count"]).all()

    from synapta_tpu_torch.models.recognizer import Recognizer, init_params

    tiles = rng.random((B, 1, 32, 128)).astype(np.float32)
    model = init_params(Recognizer(dim=128, blocks=1, seq_len=32),
                        torch.Generator().manual_seed(0)).eval()
    replicas = {d: model.to(d) for d in set(dmesh.devices)}
    with torch.inference_mode():
        logits = dmesh.dispatch(lambda x: replicas[x.device](x), tiles).cpu()
    assert logits.shape[0] == B and bool(torch.isfinite(logits).all())

    # ---- 2. dp x tp training step ----------------------------------------
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    own_gpu = dev.type == "cuda" and n_devices <= torch.cuda.device_count()
    shape, loss = run_ranks(
        _train_rank, n_devices, str(dev), "nccl" if own_gpu else "gloo",
        model_axis)[0]
    assert np.isfinite(loss), f"non-finite loss: {loss}"

    # ---- 3. FULL pipeline, segment-level N-dev == 1-dev ------------------
    # Real rendered pages through VisualSegmentationPipeline on a 1-shard
    # and an n-shard data mesh: the run certifies the production sharding
    # produces identical segments, not just finite losses. Skipped only if
    # recognizer weights are absent (fresh tree).
    seg_note = "segments=skipped(no weights)"
    import os

    from synapta_tpu_torch.models.msgpack_io import WEIGHTS_PATH

    if os.path.exists(WEIGHTS_PATH):
        import hashlib
        import json
        import tempfile

        from synapta_tpu_torch.config import PipelineConfig
        from synapta_tpu_torch.hostlibs import ensure_fixture_fonts
        from synapta_tpu_torch.io.pdf_writer import make_test_book
        from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

        ensure_fixture_fonts()
        with tempfile.TemporaryDirectory() as td:
            pdf = os.path.join(td, "book.pdf")
            make_test_book(pdf, pages=3, seed=7)

            def run_pipe(n_dev: int, out: str):
                pipe = VisualSegmentationPipeline(
                    book_id="dry",
                    pdf_path=pdf,
                    output_dir=os.path.join(td, out),
                    use_mermaid=False,
                    config=PipelineConfig(use_vision_llm=False),
                    resume=False,
                    device=dev,
                )
                pipe.mesh = data_mesh(n_dev, dev, virtual=True)
                pipe.process()
                pipe.close()
                assert pipe.stats.errors == 0, pipe.stats.errors
                assert pipe.mesh.shape == {"data": n_dev}
                with open(os.path.join(td, out,
                                       "dry_visual_segments.json")) as f:
                    payload = json.load(f)
                for s in payload["segments"]:
                    s["image_path"] = os.path.basename(s["image_path"])
                return payload

            a = run_pipe(1, "out1")
            b = run_pipe(n_devices, "outN")
            assert a["total_segments"] == b["total_segments"] > 0, (
                a["total_segments"], b["total_segments"])
            assert a["segments"] == b["segments"], (
                "segment content diverged between 1-dev and "
                f"{n_devices}-dev meshes")
            digest = hashlib.sha256(
                json.dumps(b["segments"], sort_keys=True).encode()
            ).hexdigest()[:16]
            seg_note = (
                f"segments={a['total_segments']} (1dev=={n_devices}dev) "
                f"digest={digest}"
            )

    print(
        f"dryrun_multichip OK: pipeline mesh={dmesh.shape} "
        f"train mesh={shape} crops={B} loss={loss:.3f} "
        f"{seg_note}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if argv is None:
        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's
        # copy where the system has none
        from synapta_tpu_torch.hostlibs import ensure_native_engine

        ensure_native_engine(["-m", "synapta_tpu_torch.parallel.dryrun",
                              *sys.argv[1:]])
    run(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
