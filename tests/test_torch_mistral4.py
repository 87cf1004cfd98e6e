"""The port's Mistral-Small-4-119B-2603 (``models/mistral4.py``), its engine
(``llm/engine.py``) and client (``llm/mistral4_client.py``) against the
plain float32 reference ``tests/mistral4_plain.py``, on the CPU at a tiny
size with seeded random weights: 2 layers, hidden 64, 8 routed experts of
which 4 are held, a 2-layer vision encoder. The program runs in float32
here, so it agrees with the reference to float32 rounding; the chip's bf16
run is held to the same reference by the benchmark's comparison."""
import json
import os
import threading

import numpy as np
import pytest
import torch

import mistral4_plain as P
import torchfixtures  # noqa: F401  (one intra-op thread)
from synapta_tpu_torch.llm import engine as E
from synapta_tpu_torch.llm.mistral4_client import (IMG, Mistral4Client, image_tokens,
                                                   make_client)
from synapta_tpu_torch.models import mistral4 as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
            v_head_dim=16, moe_intermediate_size=32, n_routed_experts=8,
            vision=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=64))
SEED = 3_000_000_123
HELD = [0, 1, 2, 3]
TOL = 2e-5


def cfgs():
    return M.Mistral4Config.from_dict(TINY), P.config(**TINY)


def model(held=HELD, **over):
    cfg = M.Mistral4Config.from_dict(dict(TINY, **over))
    return M.Mistral4(cfg, SEED, "cpu", held=held, dtype=torch.float32)


def prompt(n_text=12, rows=2, cols=3, seed=0):
    """(ids, image (3, 28 rows, 28 cols), image rows) in the client's
    layout: text ids, then the image's tokens, then [/INST]."""
    g = torch.Generator().manual_seed(seed)
    ids = [1, 3] + torch.randint(1000, 2048, (n_text,), generator=g).tolist()
    toks = image_tokens(rows, cols)
    img_rows = [len(ids) + j for j, t in enumerate(toks) if t == IMG]
    ids = ids + toks + [4]
    return ids, torch.randn(3, 28 * rows, 28 * cols, generator=g), img_rows


def cache(m, slots=1, max_len=128):
    c = m.cfg
    return torch.zeros(c.num_hidden_layers, slots, max_len,
                       c.kv_lora_rank + c.qk_rope_head_dim)


def close(a, b, tol=TOL):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_prefill_then_decode_through_the_cache_agrees_with_the_full_forward():
    m, (_, c) = model(), cfgs()
    ids, img, rows = prompt()
    vis = m.vision(img[None])[0]
    n = len(ids)
    kv = cache(m)
    h = m.prefill(m.embed_tokens(torch.tensor(ids), torch.tensor(rows), vis),
                  torch.arange(n), [n], torch.arange(n), kv)
    got = [m.logits(h)]
    toks = [int(got[0][-1].argmax())]
    for j in range(6):  # greedy steps through the latent cache
        pos = torch.tensor([n + j])
        mask = torch.arange(n + j + 1)[None, :] <= pos[:, None]
        hd = m.decode(torch.tensor([toks[-1]]), pos, pos, mask, kv)
        got.append(m.logits(hd))
        toks.append(int(got[-1][0].argmax()))
    ref = P.forward(c, SEED, ids + toks[:-1], held=HELD, image_rows=rows,
                    image_embeds=P.vision(c, SEED, img[None])[0])
    assert close(torch.cat(got), ref)


def test_absorbed_decode_equals_the_expanded_path():
    m = model()
    ids = prompt()[0][:20]
    n = len(ids)
    x = m.embed_tokens(torch.tensor(ids))
    full = m.prefill(x, torch.arange(n), [n], torch.arange(n), cache(m))
    kv = cache(m)
    m.prefill(x[:-1], torch.arange(n - 1), [n - 1], torch.arange(n - 1), kv)
    pos = torch.tensor([n - 1])
    last = m.decode(torch.tensor(ids[-1:]), pos, pos, torch.ones(1, n, dtype=torch.bool),
                    kv)
    assert close(last[0], full[-1])


def test_two_ranks_expert_shares_add_up_to_the_uncut_layer():
    _, c = cfgs()
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(4))
    shares = [model(held=h).moe(model(held=h).layers[1], x) for h in ([0, 1, 2, 3], [4, 5, 6, 7])]
    shared = P.moe_layer(c, SEED, 1, x, held=[])  # what every rank computes alike
    whole = P.moe_layer(c, SEED, 1, x, held=None)
    assert close(shares[0] + shares[1] - shared, whole)
    # and each share is the reference's own share
    assert close(shares[0], P.moe_layer(c, SEED, 1, x, held=HELD))


def test_yarn_and_llama4_scales_across_8192():
    cfg, c = M.Mistral4Config(), P.config()
    pos = torch.tensor([0, 1, 8191, 8192, 8193, 16383, 16384, 24576, 10 ** 6])
    want = 1 + 0.1 * np.log1p(np.floor(pos.numpy() / 8192))
    assert np.allclose(M.llama4_scale(cfg, pos).numpy(), want, rtol=1e-6)
    assert np.allclose(P.llama4_query_scale(c, pos).numpy(), want, rtol=1e-6)
    assert M.llama4_scale(cfg, pos)[2] == 1.0 and M.llama4_scale(cfg, pos)[3] > 1.0
    # the correction range of beta 32 / 1 at dim 64 is [12, 25]: pairs 0-12
    # keep the original frequency, pairs 25 on are divided by the factor 128
    inv = M.yarn_inv_freq(cfg)
    base = 1.0 / 10000 ** (torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    assert torch.allclose(inv[:13], base[:13]) and torch.allclose(inv[25:], base[25:] / 128)
    assert (inv[13:25] < base[13:25]).all() and (inv[13:25] > base[13:25] / 128).all()
    assert M.softmax_scale(cfg) == pytest.approx((0.1 * np.log(128) + 1) ** 2 / np.sqrt(128))
    # the whole attention, queries across 8192 (scaled) against the reference
    m, (_, ct) = model(), cfgs()
    x = torch.randn(24, 64, generator=torch.Generator().manual_seed(5))
    p = torch.arange(8180, 8204)
    rot, qs = m.positions(p)
    got = m.attn_prefill(m.layers[0], x, rot, qs, [24])[0]
    ref = P.attention(ct, P.layer_weights(ct, SEED, 0, HELD, "cpu"), x, p)
    assert close(got, ref)
    # without the llama-4 scale the two would differ past 8192
    m.cfg = M.Mistral4Config.from_dict(dict(TINY, llama_4_scaling_beta=0.0))
    rot, qs = m.positions(p)
    assert not close(m.attn_prefill(m.layers[0], x, rot, qs, [24])[0], ref)


def test_vision_encoder_matches_the_reference():
    m, (_, c) = model(), cfgs()
    imgs = torch.randn(2, 3, 56, 84, generator=torch.Generator().manual_seed(6))
    got, ref = m.vision(imgs), P.vision(c, SEED, imgs)
    assert got.shape == (2, 6, 64)
    assert close(got, ref)


def run_engine(reqs, submit_later=None, slots=4):
    """Serve ``reqs`` on a fresh engine; ``submit_later`` goes in when the
    first request has ended, while the others decode."""
    eng = E.Engine(model(), slots=slots, max_len=128, seed=1)
    try:
        if submit_later is not None:
            reqs[0].future.add_done_callback(lambda f: eng.submit(submit_later))
        for r in reqs:
            eng.submit(r)
        outs = [r.future.result(timeout=120) for r in reqs]
        if submit_later is not None:
            outs.append(submit_later.future.result(timeout=120))
    finally:
        eng.shutdown()
    return outs


def request(seed, n_text, length, image=True):
    ids, img, rows = prompt(n_text=n_text, seed=seed)
    if not image:
        ids, img, rows = [t for t in ids if t not in (IMG, 12, 13)], None, []
    return E.Request(ids=ids, image=img, image_rows=rows, length=length,
                     capture={"positions": list(range(len(ids)))})


def test_mixed_batches_give_each_request_its_own_logits():
    specs = [(1, 10, 6, True), (2, 25, 12, True), (3, 4, 9, False), (4, 17, 8, True)]
    mixed = [request(*s) for s in specs]
    outs = run_engine(mixed[:3], submit_later=mixed[3])
    for spec, r, out in zip(specs, mixed, outs):
        alone = request(*spec)
        assert run_engine([alone]) == [out]
        assert len(out) == spec[2]
        a, b = r.capture, alone.capture
        assert close(a["prefill_logits"], b["prefill_logits"])
        assert close(torch.stack(a["decode_logits"]), torch.stack(b["decode_logits"]))
        assert torch.equal(a["prefill_routes"], b["prefill_routes"])


def test_reply_lengths_are_exact_and_otherwise_the_end_token_stops(monkeypatch):
    # the traffic's lengths, whatever the end token
    outs = run_engine([request(7, 8, n) for n in (1, 2, 5, 13)])
    assert [len(o) for o in outs] == [1, 2, 5, 13]
    # without a length: the end token, forced at the fourth token, stops
    # the request there; max_tokens stops one that never meets it
    orig = M.Mistral4.logits
    calls = {"n": 0}

    def logits(self, h):
        out = orig(self, h)
        calls["n"] += 1
        if calls["n"] == 4:
            out[:, E.EOS] = out.max() + 10.0
        return out

    monkeypatch.setattr(M.Mistral4, "logits", logits)
    r = request(8, 8, None)
    r.capture, r.max_tokens = None, 50
    out = run_engine([r])[0]
    assert len(out) == 4 and out[-1] == E.EOS
    calls["n"] = -10 ** 6
    r = request(9, 8, None)
    r.capture, r.max_tokens = None, 7
    assert len(run_engine([r])[0]) == 7


def test_the_reference_copies_are_byte_identical():
    a = open(os.path.join(REPO, "tests", "mistral4_plain.py"), "rb").read()
    b = open(os.path.join(REPO, "portbench", "reference", "mistral4.py"), "rb").read()
    assert a == b


def test_the_client_takes_the_reply_lengths_in_turn():
    client = make_client(device="cpu", seed=SEED, pool=2, config=TINY, dtype="float32",
                         held=HELD, max_len=2048,
                         reply_tokens={"comprehensive": [3, 5], "mermaid": [2]})
    seen = []
    orig = client.engine.submit

    def submit(req):
        fut = orig(req)
        seen.append((req.length, fut))
        return fut

    client.engine.submit = submit
    try:
        pixels = np.zeros((60, 90, 3), np.uint8)
        futs = [client.submit_comprehensive(pixels, None) for _ in range(4)]
        assert all(f.result(timeout=120)["method"] == "fallback_heuristic" for f in futs)
        assert sorted(n for n, _ in seen) == [3, 3, 5, 5]
        assert all(len(f.result()) == n for n, f in seen)
        assert client.stats["calls_comprehensive"] == 4 and client.stats["failures"] == 0
        assert client.stats["out_tokens"] == 16
    finally:
        client.shutdown()
    assert client.engine is None


def test_book_queue_with_the_client_writes_complete_books(tmp_path):
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.pdf_writer import make_test_book
    from synapta_tpu_torch.schema import VisualType
    from synapta_tpu_torch.serve import BookQueue

    books = []
    for i, pages in enumerate((5, 4)):
        path = str(tmp_path / f"b{i}.pdf")
        make_test_book(path, pages=pages, seed=20 + i)
        books.append(path)
    client = make_client(device="cpu", seed=SEED, pool=4, config=TINY, dtype="float32",
                         held=HELD, max_len=2048,
                         reply_tokens={"comprehensive": [4, 6], "calculations": [3],
                                       "mermaid": [2]})
    try:
        q = BookQueue(output_root=str(tmp_path / "out"),
                      config=PipelineConfig(use_vision_llm=True, use_mermaid=True),
                      llm_client=client, device="cpu")
        for i, path in enumerate(books):
            q.add(path, book_id=f"book{i}")
        q.run()
        stats = dict(client.stats)
    finally:
        client.shutdown()
    segs = []
    for j in q.jobs:
        assert j.status == "done" and j.errors == 0
        d = tmp_path / "out" / j.book_id
        for name in (f"{j.book_id}_visual_segments.json", f"{j.book_id}_visual_summary.csv",
                     f".{j.book_id}_segments.jsonl"):
            assert (d / name).is_file()
        with open(d / f"{j.book_id}_visual_segments.json") as f:
            book = json.load(f)["segments"]
        assert book and all(os.path.isfile(s["image_path"]) for s in book)
        segs += book
    # no reply is JSON: every segment keeps the heuristic analysis, and the
    # follow-ups go where its types send them
    assert all(s["classification_method"] == "heuristic" for s in segs)
    types = [s["segment_type"] for s in segs]
    assert stats["calls_comprehensive"] == len(segs)
    assert stats.get("calls_calculations", 0) == types.count(VisualType.IMAGE.value)
    assert stats.get("calls_mermaid", 0) == sum(
        t in (VisualType.DIAGRAM.value, VisualType.FLOWCHART.value) for t in types)
    assert stats.get("calls_calculations", 0) + stats.get("calls_mermaid", 0) > 0
    assert stats["failures"] == 0
