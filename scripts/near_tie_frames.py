"""Which recognizer frames make a text line differ between the PyTorch port
and the JAX pipeline, and how close each one is to a tie (CPU).

    JAX_PLATFORMS=cpu python scripts/near_tie_frames.py BOOK.pdf
        [--book-id ID] [--config '{"pages_per_batch": 4}']

Runs the port (``device="cpu"``) and the JAX pipeline (one data device) on
the book with the LLM off, recording every batch of line tiles the two OCR
stages hand to ``recognize_dispatch`` (the tiles must be equal). Each batch
is padded to ``line_batch`` as the pipelines pad it and decoded again by
each package's own ``_decode``; for every tile whose greedy texts differ it
prints one JSON line: the two texts, the largest logit difference over the
tile, and for each frame whose argmax differs the two most probable classes
with their softmax probabilities and the logit gap between them, from the
port's model and from the JAX model (jitted, as the pipeline runs it).

The tests pin a line by path only where this shows a near-tie frame
(tests/test_torch_script_books.py::KNIFE_EDGE). Needs the JAX package, so
it is no script of the port's own (scripts/torch_*.py).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("SYNAPTA_LOG_LEVEL", "WARNING")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pdf")
    ap.add_argument("--book-id", default="tie")
    ap.add_argument("--config", default="{}",
                    help="PipelineConfig keywords as JSON, for both pipelines")
    args = ap.parse_args(argv)
    kw = json.loads(args.config)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import synapta_tpu.ocr.processor as jax_proc
    import synapta_tpu_torch.ocr.processor as torch_proc
    from synapta_tpu.config import PipelineConfig as JaxPipelineConfig
    from synapta_tpu.llm.fake import DisabledClient as JaxDisabledClient
    from synapta_tpu.pipeline import VisualSegmentationPipeline as JaxPipe
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.models.charset import BLANK, decode_greedy_batch
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline as TorchPipe

    recorded = {"port": [], "jax": []}

    def recording(cls, side):
        dispatch = cls.recognize_dispatch

        def record(self, tiles):
            recorded[side].append((self, np.array(tiles)))
            return dispatch(self, tiles)

        cls.recognize_dispatch = record

    recording(torch_proc.TorchOCR, "port")
    recording(jax_proc.TPUOCR, "jax")
    tmp = tempfile.mkdtemp(prefix="synapta_ties_")
    tp = TorchPipe(args.book_id, args.pdf, output_dir=os.path.join(tmp, "port"),
                   use_mermaid=False, config=PipelineConfig(use_vision_llm=False, **kw),
                   llm_client=DisabledClient(), resume=False, device="cpu")
    tp.process()
    tp.close()
    jp = JaxPipe(args.book_id, args.pdf, output_dir=os.path.join(tmp, "jax"),
                 use_mermaid=False,
                 config=JaxPipelineConfig(use_vision_llm=False, data_devices=1, **kw),
                 llm_client=JaxDisabledClient(), resume=False)
    jp.process()
    jp.close()

    def char(c):
        return "blank" if c == BLANK else decode_greedy_batch(np.array([[c]]))[0]

    def top2(probs, logits):
        a, b = np.argsort(-probs)[:2]
        return ([[char(a), float(probs[a])], [char(b), float(probs[b])]],
                float(logits[a] - logits[b]))

    n_tiles = 0
    for (t_ocr, t_tiles), (j_ocr, j_tiles) in zip(recorded["port"], recorded["jax"]):
        if not np.array_equal(t_tiles, j_tiles):
            raise SystemExit("the two pipelines cut other line tiles")
        lb = t_ocr.cfg.line_batch
        j_logits_fn = jax.jit(lambda p, x: j_ocr.model.apply(
            {"params": p}, x.astype(jnp.float32) / 255.0))
        for start in range(0, t_tiles.shape[0], lb):
            chunk = t_tiles[start:start + lb]
            real = chunk.shape[0]
            chunk = np.concatenate([chunk, np.full((lb - real,) + chunk.shape[1:],
                                                   255, np.uint8)])
            with torch.no_grad():
                x = torch.from_numpy(chunk)
                t_best = t_ocr._decode(x)[..., 0].numpy().astype(np.int64)
                t_logits = t_ocr.model(x.to(torch.float32)[:, None] / 255.0).float()
            t_probs = torch.softmax(t_logits, -1).numpy()
            t_logits = t_logits.numpy()
            j_best = np.asarray(j_ocr._decode(j_ocr.params, chunk[..., None]))[
                ..., 0].astype(np.int64)
            j_logits = np.asarray(j_logits_fn(j_ocr.params, chunk[..., None]),
                                  np.float32)
            j_probs = np.asarray(jax.nn.softmax(jnp.asarray(j_logits), -1))
            t_text, j_text = decode_greedy_batch(t_best), decode_greedy_batch(j_best)
            for i in range(real):
                if t_text[i] == j_text[i]:
                    continue
                frames = []
                for f in np.nonzero(t_best[i] != j_best[i])[0]:
                    port, port_gap = top2(t_probs[i, f], t_logits[i, f])
                    jx, jax_gap = top2(j_probs[i, f], j_logits[i, f])
                    frames.append({"frame": int(f), "port": port,
                                   "port_logit_gap": port_gap, "jax": jx,
                                   "jax_logit_gap": jax_gap})
                print(json.dumps({
                    "tile": n_tiles + start + i, "port_text": t_text[i],
                    "jax_text": j_text[i],
                    "max_abs_logit_diff": float(np.abs(t_logits[i] - j_logits[i]).max()),
                    "frames": frames}, ensure_ascii=False), flush=True)
        n_tiles += t_tiles.shape[0]
    print(json.dumps({"tiles": n_tiles, "errors": [tp.stats.errors, jp.stats.errors]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
