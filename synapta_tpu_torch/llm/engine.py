"""A continuous-batching engine for ``models/mistral4.py``: one thread owns
the card's model and its latent cache and serves requests from any number
of client threads.

Each turn of its loop admits queued requests and prefills them (their
images through the vision encoder, then the packed prompts through the
expanded attention path, each prompt's latents written to a cache slot),
then runs one decode step over every request in flight (the absorbed path
over the latent cache). The running requests hold slots 0..B-1 of the
cache; a request that leaves hands its slot to the one in the highest slot.

On a card a decode step is one CUDA graph, captured when the engine is
built for each bucket of (sequences, attended positions) in ``B_BUCKETS`` x
``L_BUCKETS``: the step's rows beyond its sequences are padding that
attends one position and goes to no routed expert, and the head's
sampling runs after the graph. Prefill runs eagerly.

The loop never waits for the step it has just launched: each step's
sampled tokens (and its expert counts) are copied to pinned host memory
behind an event, and read one step later. A request ends at a length set
by its caller (``Request.length``: the traffic's reply length, whatever
the end token), else at the end token or ``max_tokens``, or where its
cache slot is full; ``cancel`` drops one whose caller gave up.

Spans (``utils/profiler.py::TIMERS``, on the engine's thread):
``vision_encode`` (images, patches), ``llm_prefill`` (seqs, tokens, the sum
of the prompts' squared lengths ``tokens_sq``, images) with one ``moe`` a
layer inside (held_tokens: assignments to held experts; experts: held
experts with at least one; the shared expert in neither), and ``llm_decode`` (seqs, rows: the graph's
bucket, context: the cache positions its sequences attend, and the step's
``held_tokens`` and ``experts`` summed over the layers, its expert layers
running inside the graph). Counts are filled in once the step's copy has
landed.
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from synapta_tpu_torch.models.mistral4 import MoeCounts, Mistral4
from synapta_tpu_torch.utils.profiler import TIMERS

EOS = 2
CAPTURE_STEPS = 8  # decode steps whose logits a captured request keeps
PREFILL_TOKENS = 8192  # a prefill packs prompts up to this many (at least one)
B_BUCKETS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)
L_BUCKETS = (1024, 2048, 4096, 8192)


@dataclass(eq=False)
class Request:
    """One generation: the prompt's ids (``image_rows``: the positions of
    its image tokens, which take the image's embeddings in order), an
    optional normalised image (3, H, W), and how it ends. ``capture``, set
    by a comparison before ``submit``, makes the engine keep the request's
    logits at ``capture["positions"]`` of the prompt and at its first
    decode steps, its routing at every layer, and its image embeddings."""
    ids: List[int]
    image: Optional[torch.Tensor] = None
    image_rows: List[int] = field(default_factory=list)
    max_tokens: int = 256
    length: Optional[int] = None
    temperature: float = 0.0
    capture: Optional[dict] = None
    future: Future = field(default_factory=Future)
    out: List[int] = field(default_factory=list)
    # engine state
    slot: int = -1
    cache_len: int = 0
    scheduled: int = 0
    target: int = 0
    stopped: bool = False   # no further token will be scheduled
    ended: bool = False     # the end token has landed
    cancelled: bool = False


class DecodeStep:
    """One decode step at a bucket of ``rows`` sequences attending up to
    ``positions`` cache positions: static inputs (ids, positions, cache
    rows, which rows are sequences), and the logits, chosen experts
    (layers, rows, k) and the tokens of each held expert (layers, held) it
    leaves. On a card it is a CUDA graph captured at construction; on the
    CPU it runs eagerly."""

    def __init__(self, engine: "Engine", rows: int, positions: int):
        dev = engine.device
        self.engine, self.rows, self.positions = engine, rows, positions
        self.ids = torch.zeros(rows, dtype=torch.long, device=dev)
        self.pos = torch.zeros(rows, dtype=torch.long, device=dev)
        self.cache_rows = torch.zeros(rows, dtype=torch.long, device=dev)
        self.valid = torch.zeros(rows, dtype=torch.bool, device=dev)
        self.graph = None
        if engine.cuda:
            self.cache_rows.copy_(torch.arange(rows, device=dev) * engine.max_len)
            self.out = self._run()  # warm-up: workspaces and kernels chosen
            torch.cuda.current_stream().synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run()

    def _run(self):
        e = self.engine
        mask = torch.arange(self.positions, device=e.device)[None, :] <= self.pos[:, None]
        counts, tap = MoeCounts(), []
        h = e.model.decode(self.ids, self.pos, self.cache_rows, mask, e.kv, counts,
                           tap, None, self.valid, span=False)
        return e.model.logits(h), torch.stack(tap), torch.stack(counts.rows)

    def __call__(self):
        if self.graph is None:
            self.out = self._run()
        else:
            self.graph.replay()
        return self.out


class Engine:
    """Serves ``Request``s on ``model`` with ``slots`` cache slots of
    ``max_len`` positions."""

    def __init__(self, model: Mistral4, slots: int = 32, max_len: int = 4096,
                 seed: int = 0):
        cfg = model.cfg
        self.model, self.device = model, model.device
        self.slots, self.max_len = slots, max_len
        L = cfg.num_hidden_layers
        self.kv = torch.zeros(L, slots, max_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                              dtype=model.dtype, device=self.device)
        self.last = torch.zeros(slots, dtype=torch.long, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) & ((1 << 63) - 1))
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.steps = {}
        with self._on_stream(), torch.inference_mode():
            for b in sorted({b for b in B_BUCKETS if b < slots} | {slots}):
                for n in sorted({n for n in L_BUCKETS if n < max_len} | {max_len}):
                    self.steps[b, n] = DecodeStep(self, b, n)
        self.queue: deque = deque()
        self.running: List[Request] = []
        self.inflight: deque = deque()
        self.cv = threading.Condition()
        self._stop = False
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._loop, name="mistral4-engine",
                                       daemon=True)
        self.thread.start()

    # ------------------------------------------------------------ clients

    def submit(self, req: Request) -> Future:
        if len(req.ids) >= self.max_len:
            req.future.set_exception(ValueError(
                f"prompt of {len(req.ids)} ids does not fit {self.max_len} positions"))
            return req.future
        with self.cv:
            if self._stop:
                req.future.set_exception(RuntimeError("engine stopped"))
                return req.future
            self.queue.append(req)
            self.cv.notify()
        return req.future

    def cancel(self, req: Request) -> None:
        """Drop ``req`` (its caller gave up): it leaves at the next turn."""
        req.cancelled = True
        with self.cv:
            self.cv.notify()

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def shutdown(self) -> None:
        """Stop the loop, fail what is left, and drop the model and cache."""
        with self.cv:
            self._stop = True
            self.cv.notify()
        self.thread.join()
        for r in list(self.queue) + self.running:
            if not r.future.done():
                r.future.set_exception(RuntimeError("engine stopped"))
        self.queue.clear()
        self.running, self.inflight = [], deque()
        self.steps = {}
        self.model.free()
        self.model = self.kv = self.last = None

    # ------------------------------------------------------------ loop

    def _loop(self) -> None:
        with self._on_stream(), torch.inference_mode():
            while True:
                with self.cv:
                    while not (self._stop or self.queue or self.running or self.inflight):
                        self.cv.wait()
                    if self._stop:
                        if self.cuda:
                            self.stream.synchronize()
                        return
                try:
                    self._turn()
                except BaseException as e:  # fail every request, keep serving
                    self.error = e
                    for r in list(self.queue) + self.running:
                        if not r.future.done():
                            r.future.set_exception(e)
                    with self.cv:
                        self.queue.clear()
                    self.running, self.inflight = [], deque()

    def _turn(self) -> None:
        launched = 0
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
            launched += 1
        self._compact()
        if self.running:
            self._decode()
            launched += 1
        # keep the newest launch in flight; land the older ones
        while len(self.inflight) > (1 if launched else 0):
            self._land(self.inflight.popleft())

    def _admit(self) -> List[Request]:
        out, tokens = [], 0
        with self.cv:
            while (self.queue and len(self.running) + len(out) < self.slots
                   and (not out or tokens + len(self.queue[0].ids) <= PREFILL_TOKENS)):
                r = self.queue.popleft()
                if r.cancelled:
                    r.future.set_exception(TimeoutError("cancelled by its caller"))
                    continue
                tokens += len(r.ids)
                out.append(r)
        return out

    def _h2d(self, values, dtype=torch.long) -> torch.Tensor:
        t = torch.tensor(values, dtype=dtype)
        if not self.cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _sample(self, logits: torch.Tensor, reqs: List[Request]) -> torch.Tensor:
        temps = [r.temperature for r in reqs]
        if all(t <= 0 for t in temps):
            return logits.argmax(-1)
        t = self._h2d([max(t, 1e-6) for t in temps], torch.float32)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        tok = torch.multinomial(probs, 1, generator=self.gen).squeeze(1)
        greedy = [i for i, x in enumerate(temps) if x <= 0]
        if greedy:
            g = self._h2d(greedy)
            tok[g] = logits[g].argmax(-1)
        return tok

    def _send(self, tok: torch.Tensor, reqs: List[Request], counts: MoeCounts) -> None:
        """Copy the step's tokens and expert counts to the host behind an
        event; ``_land`` reads them."""
        cnt = torch.stack(counts.rows) if counts.rows else None
        if self.cuda:
            host_tok = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
            host_tok.copy_(tok, non_blocking=True)
            host_cnt = None
            if cnt is not None:
                host_cnt = torch.empty(cnt.shape, dtype=cnt.dtype, pin_memory=True)
                host_cnt.copy_(cnt, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        else:
            host_tok, host_cnt, ev = tok, cnt, None
        self.inflight.append((ev, host_tok, list(reqs), host_cnt, counts.attrs))

    def _land(self, entry) -> None:
        ev, host_tok, reqs, host_cnt, attrs = entry
        if ev is not None:
            ev.synchronize()
        if host_cnt is not None:
            for a, n in zip(attrs, host_cnt.tolist()):
                a["held_tokens"], a["experts"] = sum(n), sum(t > 0 for t in n)
        for r, t in zip(reqs, host_tok.tolist()):
            if r.ended or r.future.done():
                continue
            r.out.append(int(t))
            if r.length is None and t == EOS:
                r.ended = r.stopped = True
            if r.stopped and (r.ended or len(r.out) >= r.scheduled):
                self._finish(r)

    def _finish(self, r: Request) -> None:
        if r.capture is not None:
            r.capture["out"] = list(r.out[:CAPTURE_STEPS + 1])
        r.future.set_result(list(r.out))

    def _compact(self) -> None:
        """Requests with no token left to schedule leave the batch; the
        highest slots move into their holes."""
        for r in self.running:
            if r.cancelled and not r.stopped:
                r.stopped = True
                if not r.future.done():
                    r.future.set_exception(TimeoutError("cancelled by its caller"))
        keep = [r for r in self.running if not r.stopped]
        if len(keep) == len(self.running):
            return
        n = len(keep)
        holes = sorted(r.slot for r in self.running if r.stopped and r.slot < n)
        movers = sorted((r for r in keep if r.slot >= n), key=lambda r: r.slot)
        for h, r in zip(holes, movers):
            m = r.cache_len
            self.kv[:, h, :m].copy_(self.kv[:, r.slot, :m])
            self.last[h] = self.last[r.slot]
            r.slot = h
        self.running = sorted(keep, key=lambda r: r.slot)

    # ------------------------------------------------------------ passes

    def _prefill(self, reqs: List[Request]) -> None:
        model, D = self.model, self.model.cfg.hidden_size
        b0 = len(self.running)
        for i, r in enumerate(reqs):
            r.slot, r.cache_len = b0 + i, len(r.ids)
            cap = self.max_len - len(r.ids) + 1
            r.target = max(1, min(r.length if r.length is not None else r.max_tokens, cap))
        images = [r.image for r in reqs if r.image is not None]
        emb = None
        if images:
            n_patch = sum((im.shape[1] // model.cfg.vision.patch_size)
                          * (im.shape[2] // model.cfg.vision.patch_size) for im in images)
            with TIMERS.stage("vision_encode", images=len(images), patches=n_patch):
                stack = torch.stack(images)
                if self.cuda:
                    stack = stack.pin_memory()
                emb = model.vision(stack.to(self.device, non_blocking=True))
        seg = [len(r.ids) for r in reqs]
        counts = MoeCounts()
        with TIMERS.stage("llm_prefill", seqs=len(reqs), tokens=sum(seg),
                          tokens_sq=sum(n * n for n in seg), images=len(images)):
            ids, pos, rows, img_rows, taps = [], [], [], [], []
            at = 0
            for r, n in zip(reqs, seg):
                ids += r.ids
                pos += range(n)
                rows += range(r.slot * self.max_len, r.slot * self.max_len + n)
                img_rows += [at + j for j in r.image_rows]
                if r.capture is not None:
                    taps += range(at, at + n)
                at += n
            x = model.embed_tokens(
                self._h2d(ids), self._h2d(img_rows) if img_rows else None,
                emb.reshape(-1, D) if emb is not None else None)
            tap = [] if taps else None
            tap_rows = self._h2d(taps) if taps else None
            h = model.prefill(x, self._h2d(pos), seg, self._h2d(rows), self.kv, counts, tap,
                              tap_rows)
            ends = [sum(seg[:i + 1]) - 1 for i in range(len(seg))]
            logits = model.logits(h[self._h2d(ends)])
            tok = self._sample(logits, reqs)
            self.last[b0:b0 + len(reqs)] = tok
            # what a comparison keeps of its requests
            at, k = 0, 0
            for i, (r, n) in enumerate(zip(reqs, seg)):
                if r.capture is not None:
                    c = r.capture
                    want = self._h2d([at + p for p in c["positions"]])
                    c["prefill_logits"] = model.logits(h[want]).to(model.dtype)
                    c["prefill_routes"] = torch.stack([t[k:k + n] for t in tap]).to(torch.uint8)
                    c["decode_logits"], c["decode_routes"] = [], []
                    k += n
                    if r.image is not None:
                        j = sum(q.image is not None for q in reqs[:i])
                        c["vision"] = emb[j].clone()
                at += n
        for r in reqs:
            r.scheduled = 1
            r.stopped = r.target <= 1
        self.running += reqs
        self._send(tok, reqs, counts)

    def _decode(self) -> None:
        model, reqs = self.model, self.running
        B = len(reqs)
        pos = [r.cache_len for r in reqs]
        step = self._step(B, max(pos) + 1)
        pad = step.rows - B
        caps = [i for i, r in enumerate(reqs)
                if r.capture is not None and len(r.capture["decode_logits"]) < CAPTURE_STEPS]
        with TIMERS.stage("llm_decode", seqs=B, rows=step.rows, context=sum(pos) + B) as attrs:
            host = self._h2d([pos + [0] * pad,
                              [r.slot * self.max_len + p for r, p in zip(reqs, pos)]
                              + [(B + j) * self.max_len for j in range(pad)],
                              [1] * B + [0] * pad])
            step.ids.copy_(self.last[:step.rows])
            step.pos.copy_(host[0])
            step.cache_rows.copy_(host[1])
            step.valid.copy_(host[2].bool())
            logits, routes, counts = step()
            tok = self._sample(logits[:B], reqs)
            self.last[:B] = tok
            for i in caps:
                c = reqs[i].capture
                c["decode_logits"].append(logits[i].to(model.dtype))
                c["decode_routes"].append(routes[:, i].to(torch.uint8))
        for r in reqs:
            r.cache_len += 1
            r.scheduled += 1
            if r.scheduled >= r.target:
                r.stopped = True
        summed = MoeCounts()
        summed.rows, summed.attrs = [counts.flatten()], [attrs]
        self._send(tok, reqs, summed)

    def _step(self, seqs: int, positions: int) -> DecodeStep:
        """The smallest captured step that holds ``seqs`` sequences and
        ``positions`` positions."""
        return min((s for (b, n), s in self.steps.items() if b >= seqs and n >= positions),
                   key=lambda s: (s.rows, s.positions))
