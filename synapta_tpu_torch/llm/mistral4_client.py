"""The pipeline's vision-LLM client served by Mistral-Small-4-119B-2603 on
the card: ``PixtralClient`` with its HTTP post replaced by the local engine
(``llm/engine.py``). The pipeline's calls, prompts, parsing and fallbacks
are the pinned client's; ``_post`` decodes the payload's prompt and PNG,
submits them to the engine and returns the decoded reply.

No tokenizer can be fetched, so ids come from a stand-in
(``StandInTokenizer``): one id for every 4 bytes of UTF-8 text, about what
a BPE tokenizer gives on English. The image follows Pixtral's layout: the
picture scaled to fit ``IMAGE_SIZE`` and rounded up to whole 2x2 cells of
14-pixel patches, one ``[IMG]`` a merged cell, ``[IMG_BREAK]`` after each
row and ``[IMG_END]`` in place of the last break.

``reply_tokens`` (per call kind, a list of lengths taken in turn in the
order the pipeline submits its calls) makes every reply that long whatever
the end token; without it a reply ends at the end token or the call's
``max_tokens``, as in production. Calls are not retried: the retries of
the pinned client are for a remote API's rate limits. ``stats`` adds, to
the pinned client's counts, the calls of each kind and the prompt and
reply tokens of the calls that were answered.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from synapta_tpu_torch.config import VisionLLMConfig
from synapta_tpu_torch.llm.pixtral import PixtralClient

BOS, INST, INST_END = 1, 3, 4
IMG, IMG_BREAK, IMG_END = 10, 12, 13
SPECIAL = 1000  # ids below are control tokens
KINDS = ("comprehensive", "calculations", "mermaid")
PIECES = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ."
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE_SIZE = 1540  # the longest side a picture is scaled to fit, in pixels


class StandInTokenizer:
    """Deterministic ids for text: each 4-byte chunk of the UTF-8 bytes
    hashes to one id of ``[SPECIAL, vocab)``; an id decodes to a 4-letter
    piece of its own."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, text: str) -> List[int]:
        b = text.encode("utf-8")
        span = self.vocab - SPECIAL
        return [SPECIAL + (int.from_bytes(b[i:i + 4], "little") * 2654435761 + i % 4) % span
                for i in range(0, len(b), 4)]

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for t in ids:
            if t < SPECIAL:
                continue
            v, piece = t - SPECIAL, []
            for _ in range(4):
                v, d = divmod(v, len(PIECES))
                piece.append(PIECES[d])
            out.append("".join(piece))
        return "".join(out)


def image_tokens(rows: int, cols: int) -> List[int]:
    ids = []
    for r in range(rows):
        ids += [IMG] * cols + [IMG_BREAK if r < rows - 1 else IMG_END]
    return ids


def prepare_image(pixels: np.ndarray, image_size: int, cell: int):
    """RGB uint8 (H, W, 3) -> float32 (3, H', W') normalised, H' and W'
    the picture fitted into ``image_size`` and rounded up to multiples of
    ``cell`` (patch x merge), bilinear."""
    import torch
    import torch.nn.functional as F

    h, w = pixels.shape[:2]
    r = max(h / image_size, w / image_size, 1.0)
    h, w = int(h / r), int(w / r)
    H, W = -(-h // cell) * cell, -(-w // cell) * cell
    x = torch.from_numpy(np.array(pixels, dtype=np.uint8)).permute(2, 0, 1)[None].float() / 255.0
    x = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False)[0]
    mean = torch.tensor(MEAN).view(3, 1, 1)
    std = torch.tensor(STD).view(3, 1, 1)
    return (x - mean) / std


class Mistral4Client(PixtralClient):
    """``PixtralClient`` whose calls go to ``engine`` on ``pool`` threads."""

    def __init__(self, engine, cfg: VisionLLMConfig = VisionLLMConfig(), pool: int = 32,
                 reply_tokens: Optional[Dict[str, List[int]]] = None):
        super().__init__(dataclasses.replace(cfg, max_concurrent=int(pool)),
                         api_key="local")
        from synapta_tpu_torch.llm.engine import Request

        self._request_cls = Request
        self.engine = engine
        mcfg = engine.model.cfg
        self.tokenizer = StandInTokenizer(mcfg.vocab_size)
        self.cell = mcfg.vision.patch_size * mcfg.vision.spatial_merge_size
        self.reply_tokens = {k: [int(n) for n in v] for k, v in (reply_tokens or {}).items()}
        unknown = set(self.reply_tokens) - set(KINDS)
        if unknown:
            raise ValueError(f"reply_tokens for unknown call kinds {sorted(unknown)}")
        self._turns = {k: 0 for k in KINDS}
        self._tls = threading.local()

    # ------------------------------------------------------------ lengths

    def _next_length(self, kind: str) -> Optional[int]:
        lengths = self.reply_tokens.get(kind)
        if not lengths:
            return None
        with self._lock:
            n = lengths[self._turns[kind] % len(lengths)]
            self._turns[kind] += 1
        return n

    def _as(self, kind: str, length: Optional[int], fn, *args):
        self._tls.call = (kind, length)
        try:
            return fn(*args)
        finally:
            self._tls.call = None

    def submit_comprehensive(self, pixels, ocr):
        return self._pool.submit(self._as, "comprehensive",
                                 self._next_length("comprehensive"),
                                 self.analyze_comprehensive, pixels, ocr)

    def submit_mermaid(self, pixels, visual_type, ocr):
        return self._pool.submit(self._as, "mermaid", self._next_length("mermaid"),
                                 self.extract_mermaid, pixels, visual_type, ocr)

    def submit_calculations(self, pixels, ocr, nearby):
        return self._pool.submit(self._as, "calculations",
                                 self._next_length("calculations"),
                                 self.extract_calculations, pixels, ocr, nearby)

    # ------------------------------------------------------------ the post

    def request(self, payload: Dict, length: Optional[int] = None):
        """The engine's request for one chat payload: the user turn's text,
        then its image."""
        from PIL import Image

        ids, image, rows = [BOS, INST], None, []
        for part in payload["messages"][0]["content"]:
            if part["type"] == "text":
                ids += self.tokenizer.encode(part["text"])
            elif part["type"] == "image_url":
                png = base64.b64decode(part["image_url"].split(",", 1)[1])
                pixels = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
                image = prepare_image(pixels, IMAGE_SIZE, self.cell)
                toks = image_tokens(image.shape[1] // self.cell, image.shape[2] // self.cell)
                rows = [len(ids) + j for j, t in enumerate(toks) if t == IMG]
                ids += toks
        ids.append(INST_END)
        return self._request_cls(ids=ids, image=image, image_rows=rows,
                                 max_tokens=int(payload.get("max_tokens", 256)),
                                 length=length,
                                 temperature=float(payload.get("temperature", 0.0)))

    def _post(self, payload: Dict, timeout: float) -> Optional[str]:
        kind, length = getattr(self._tls, "call", None) or ("other", None)
        with self._lock:
            self.stats["calls"] += 1
        req = None
        try:
            req = self.request(payload, length)
            out = self.engine.submit(req).result(timeout=timeout)
        except Exception:
            if req is not None:  # no one waits for it any more
                self.engine.cancel(req)
            with self._lock:
                self.stats["failures"] += 1
            return None
        with self._lock:
            for key, n in ((f"calls_{kind}", 1), ("prompt_tokens", len(req.ids)),
                           ("out_tokens", len(out))):
                self.stats[key] = self.stats.get(key, 0) + n
        return self.tokenizer.decode(out)

    def shutdown(self) -> None:
        """Finish the pool, stop the engine and drop its weights."""
        self._pool.shutdown(wait=True)
        if self.engine is not None:
            self.engine.shutdown()
            self.engine = None


def make_client(device: str = "cuda", seed: int = 0, pool: int = 32,
                reply_tokens: Optional[Dict[str, List[int]]] = None,
                held: Optional[List[int]] = None, max_len: int = 4096,
                config: Optional[dict] = None, dtype: str = "bfloat16") -> Mistral4Client:
    """The client of a configuration's ``vision_llm``: the model's weights
    built from ``seed`` on ``device`` (``held``: the routed experts this
    card holds; ``config``: fields of ``Mistral4Config`` that differ from
    the published ones), an engine with one cache slot a pool thread."""
    import torch

    from synapta_tpu_torch.device import resolve_device
    from synapta_tpu_torch.llm.engine import Engine
    from synapta_tpu_torch.models.mistral4 import Mistral4, Mistral4Config

    dev = resolve_device(device)
    cfg = Mistral4Config.from_dict(config or {})
    model = Mistral4(cfg, seed, dev, held=held, dtype=getattr(torch, dtype))
    engine = Engine(model, slots=int(pool), max_len=max_len, seed=seed)
    return Mistral4Client(engine, pool=pool, reply_tokens=reply_tokens)
