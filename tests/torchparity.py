"""Both pipelines on one book, their OCR recorded and judged by the OCR
yardstick of chip_smoke.py (CPU).

``runs(pdf, out_dir, book_id, ...)`` runs the port (``device="cpu"``) and
the JAX pipeline (one data device) with the LLM off, each under a
``chip_smoke.OCRRecorder``. ``evaluated(run)`` evaluates every recorded
recognizer batch and DB chunk with each package's models in bf16 (the
pipeline's own) and in float32 (the same parameters): the port's through
``chip_smoke.port_evaluation``, JAX's here, with the float32 model
``model.clone(dtype=jnp.float32)`` jitted as the pipeline jits its model.
``yardstick(run["jax"], run["port"], book_id)`` applies (a), (b) and (c)
with the JAX run as the reference; ``assert_same_or_excused`` holds two
runs' payloads equal under the table, or else to the yardstick.
``recorder`` and ``evaluate`` serve a test that runs a pipeline its own way
(through a script's ``main``).
"""
import os

import numpy as np
import torch

from chip_smoke import (OCRRecorder, db_yardstick, judge_keys, ocr_yardstick,
                        payload_differences, port_evaluation)


def jax_evaluation(rec):
    """The JAX run's recorded batches with bf16 and float32 logits and the
    bf16 greedy paths of the pipeline's own jitted ``_decode``; its DB
    chunks with bf16 and float32 logits."""
    import jax
    import jax.numpy as jnp

    from synapta_tpu.models import detector as JD

    batches = rec.batches()
    fns = {}
    for b in batches:
        ocr, lb = b["ocr"], b["ocr"].cfg.line_batch
        if id(ocr) not in fns:
            fns[id(ocr)] = [jax.jit(lambda p, x, m=m: m.apply(
                {"params": p}, x.astype(jnp.float32) / 255.0))
                for m in (ocr.model, ocr.model.clone(dtype=jnp.float32))]
        bf16_fn, f32_fn = fns[id(ocr)]
        out = {"bf16": [], "f32": [], "paths": []}
        for start in range(0, b["tiles"].shape[0], lb):
            chunk = b["tiles"][start:start + lb]
            real = chunk.shape[0]
            x = np.concatenate([chunk, np.full((lb - real,) + chunk.shape[1:], 255,
                                               np.uint8)])[..., None]
            out["bf16"].append(np.asarray(bf16_fn(ocr.params, x), np.float32)[:real])
            out["f32"].append(np.asarray(f32_fn(ocr.params, x), np.float32)[:real])
            out["paths"].append(np.asarray(ocr._decode(ocr.params, x))[
                :real, :, 0].astype(np.int64))
        b.update({k: np.concatenate(v) for k, v in out.items()})
    det = [jax.jit(lambda p, v, m=m: m.apply(
        {"params": p}, (v.astype(jnp.float32) / 255.0)[..., None])[..., 0])
        for m in (JD._INFER_MODEL, JD._INFER_MODEL.clone(dtype=jnp.float32))]
    db = [{"views": c["views"], "prob_thresh": c["prob_thresh"],
           "bf16": np.asarray(det[0](c["model"], c["views"]), np.float32),
           "f32": np.asarray(det[1](c["model"], c["views"]), np.float32)}
          for c in rec.db_chunks]
    return batches, db


def recorder(side: str) -> OCRRecorder:
    """An OCRRecorder of the port's (``"port"``) or the JAX package's
    (``"jax"``) OCR class, pipeline class and DB boxes function."""
    if side == "port":
        import synapta_tpu_torch.models.detector as D
        from synapta_tpu_torch.ocr.processor import TorchOCR
        from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

        return OCRRecorder(TorchOCR, VisualSegmentationPipeline, D, "boxes_device")
    import synapta_tpu.models.detector as D
    from synapta_tpu.ocr.processor import TPUOCR
    from synapta_tpu.pipeline import VisualSegmentationPipeline

    return OCRRecorder(TPUOCR, VisualSegmentationPipeline, D, "_boxes_device")


def evaluate(side: str, rec: OCRRecorder):
    """A recorded run's batches and DB chunks with their bf16 and float32
    logits (``chip_smoke.port_evaluation`` or ``jax_evaluation``)."""
    if side == "jax":
        return jax_evaluation(rec)
    from synapta_tpu_torch.models.detector import detector_from_flax, load_det_params
    from synapta_tpu_torch.models.msgpack_io import load_params
    from synapta_tpu_torch.models.recognizer import recognizer_from_flax

    return port_evaluation(
        rec, recognizer_from_flax(load_params(), dtype=torch.float32, device="cpu"),
        detector_from_flax(load_det_params(), dtype=torch.float32, device="cpu"))


def runs(pdf, out_dir, book_id, use_mermaid=False, **cfg):
    """The port's and the JAX pipeline's run of one book, LLM off, each
    recorded -> {"port": {...}, "jax": {...}}, each with its pipeline,
    segments, output directory (``t_<book_id>`` and ``j_<book_id>`` under
    ``out_dir``) and recorder (``evaluated`` adds the batches and DB
    chunks)."""
    from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
    from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
    from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline as TorchPipe

    def pipe(side):
        out = os.path.join(out_dir, {"port": "t_", "jax": "j_"}[side] + book_id)
        if side == "port":
            return out, TorchPipe(
                book_id, pdf, output_dir=out, use_mermaid=use_mermaid,
                config=PipelineConfig(use_vision_llm=False, **cfg),
                llm_client=DisabledClient(), resume=False, device="cpu")
        return out, JaxPipe(
            book_id, pdf, output_dir=out, use_mermaid=use_mermaid,
            config=JaxPipelineConfig(use_vision_llm=False, data_devices=1, **cfg),
            llm_client=JaxDisabledClient(), resume=False)

    run = {}
    for side in ("port", "jax"):
        with recorder(side) as rec:
            out, p = pipe(side)
            segs = p.process()
            p.close()
        run[side] = {"pipe": p, "segments": segs, "out": out, "rec": rec}
    return run


def evaluated(run: dict) -> dict:
    """``run`` with each side's ``batches`` and ``db`` (its recording
    evaluated, once)."""
    for side in ("port", "jax"):
        if "batches" not in run[side]:
            run[side]["batches"], run[side]["db"] = evaluate(side, run[side]["rec"])
    return run


def yardstick(ref, cand, book_id):
    """(a), (b) and (c) on two evaluated runs (dicts with ``out``,
    ``batches`` and ``db``), the JAX run the reference -> (the recognizer
    and DB report, the key verdict)."""
    db = db_yardstick(ref["db"], cand["db"]) if ref["db"] or cand["db"] else None
    report = ocr_yardstick(ref["batches"], cand["batches"], db)
    keys = judge_keys(ref["out"], cand["out"], report, book_id)
    return report, keys


def assert_same_or_excused(run: dict, book_id: str):
    """The two runs' JSON and CSV equal under ALLOWED_DIFFERENCES, or else
    every difference excused by the yardstick (the run is evaluated only
    then) -> the yardstick's report, or None where nothing differed."""
    outside, _, csv_equal = payload_differences(run["port"]["out"],
                                                run["jax"]["out"], book_id)
    if not outside and csv_equal:
        return None
    evaluated(run)
    report, keys = yardstick(run["jax"], run["port"], book_id)
    assert report["ok"], (outside, report)
    assert not keys["faults"], keys["faults"]
    return report
