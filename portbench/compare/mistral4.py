"""mistral4: the vision LLM served on the card, held to the float32 plain
reference (``reference/mistral4.py``).

During the window a reservoir drawn from the seed keeps 6 of the engine's
requests (``Engine.submit``), each marked before it runs so that the engine
keeps its input ids and image, its logits at a block of ``BLOCK`` prompt
positions drawn from the seed and at the last one, the logits of its first
8 decode steps, its experts at every layer and position, and its image
embeddings. Once the program is freed, the reference rebuilds the same
seeded weights on the card one layer at a time and runs the whole forward
pass over each prompt and its first 8 decoded ids, following the
program's choice of experts (which ``llm_route_gap`` judges):

- ``llm_prefill_gap``: largest |program - reference| logit over the sampled
  prompt positions, over the reference logits' RMS there;
- ``llm_decode_gap``: the same over the decode steps through the cache;
- ``vision_gap``: the same over the image embeddings;
- ``llm_route_gap``: widest distance, in the reference's router logits, by
  which an expert the program chose lies below the reference's fourth best.

With ``control`` the reference in fp8 (e4m3) stands in the program's
place: its own vision embeddings, logits and experts, read by the float32
reference in the same way.
"""
from __future__ import annotations

import math
import threading

import numpy as np

from portbench.check import Reservoir

BLOCK = 64
# the shape the reference is built at: None is the published one (a test
# sets a small one)
CONFIG_OVERRIDE = None


def install(seed, k):
    from synapta_tpu_torch.llm.engine import Engine

    ss = np.random.SeedSequence([seed, 22])
    r_res, r_pos = (np.random.default_rng(s) for s in ss.spawn(2))
    res = Reservoir(k, r_res)
    owner, lock = {}, threading.Lock()
    orig = Engine.__dict__["submit"]

    def submit(engine, req):
        i = res.slot()
        if i is None:
            return orig(engine, req)
        n = len(req.ids)
        with lock:
            s0 = int(r_pos.integers(0, max(1, n - BLOCK + 1)))
            ticket = object()
            owner[i] = ticket
        req.capture = {"positions": sorted(set(range(s0, min(n, s0 + BLOCK))) | {n - 1}),
                       "seed": engine.model.seed, "held": list(engine.model.held)}

        def done(fut):
            if fut.exception() is None:
                with lock:
                    mine = owner.get(i) is ticket
                if mine:
                    res.put(i, req)

        fut = orig(engine, req)
        fut.add_done_callback(done)
        return fut

    Engine.submit = submit
    return res, [lambda: setattr(Engine, "submit", orig)]


def to_host(res):
    """Every kept request's inputs and the program's outputs on the host."""
    import torch

    out = []
    for req in res.items:
        if req is None:
            continue
        c = req.capture
        nd = min(len(c["decode_logits"]), len(c["out"]) - 1)
        out.append({
            "ids": list(req.ids), "image_rows": list(req.image_rows),
            "image": None if req.image is None else req.image.cpu(),
            "positions": list(c["positions"]), "seed": c["seed"], "held": c["held"],
            "decoded": list(c["out"][:nd]),
            "prefill_logits": c["prefill_logits"].float().cpu(),
            "decode_logits": (torch.stack(c["decode_logits"][:nd]).float().cpu()
                              if nd else None),
            "routes": torch.cat([c["prefill_routes"].long()]
                                + [r.long()[:, None] for r in c["decode_routes"][:nd]],
                                dim=1).cpu(),
            "vision": None if c.get("vision") is None else c["vision"].float().cpu(),
        })
    return out


def _gap(prog, ref) -> float:
    r = float(ref.pow(2).mean().sqrt())
    d = (prog.to(ref.device) - ref).abs().max()
    d = float(d)
    if not math.isfinite(d) or r == 0:
        return math.inf
    return d / r


def numbers(items, device, control):
    import torch

    from portbench.reference import mistral4 as R

    names = ("llm_prefill_gap", "llm_decode_gap", "vision_gap", "llm_route_gap")
    if not items:
        return dict.fromkeys(names)
    c = R.config(**(CONFIG_OVERRIDE or {}))
    out = dict.fromkeys(names, 0.0)
    seed, held = items[0]["seed"], items[0]["held"]
    # vision: the reference's embeddings feed its own text pass; pictures
    # of one size go through together
    ref_vis, served_vis = [None] * len(items), [None] * len(items)
    shapes = {}
    for i, it in enumerate(items):
        if it["image"] is not None:
            shapes.setdefault(tuple(it["image"].shape), []).append(i)
    for idx in shapes.values():
        imgs = torch.stack([items[i]["image"] for i in idx])
        ref = R.vision(c, seed, imgs, device=device)
        ctrl = R.vision(c, seed, imgs, fp8=True, device=device) if control else None
        for j, i in enumerate(idx):
            ref_vis[i] = ref[j]
            served_vis[i] = ctrl[j] if control else items[i]["vision"]
            out["vision_gap"] = max(out["vision_gap"], _gap(served_vis[i], ref_vis[i]))
    seqs = []
    for it, v in zip(items, served_vis if control else ref_vis):
        ids = it["ids"] + it["decoded"]
        n = len(it["ids"])
        at = it["positions"] + list(range(n, n + len(it["decoded"])))
        seqs.append({"ids": ids, "image_rows": it["image_rows"], "image_embeds": v,
                     "routes": None if control else it["routes"], "at": at})
    served = None
    if control:  # the fp8 reference's own logits and experts
        served = R.forward_many(c, seed, seqs, held, fp8=True, device=device)
        for s, sv, v in zip(seqs, served, ref_vis):
            s["routes"], s["image_embeds"] = sv["routes"], v
    ref = R.forward_many(c, seed, seqs, held, device=device)
    for i, (it, r) in enumerate(zip(items, ref)):
        k = len(it["positions"])
        pl = served[i]["logits"][:k] if control else it["prefill_logits"]
        out["llm_prefill_gap"] = max(out["llm_prefill_gap"], _gap(pl, r["logits"][:k]))
        if it["decoded"]:
            dl = served[i]["logits"][k:] if control else it["decode_logits"]
            out["llm_decode_gap"] = max(out["llm_decode_gap"], _gap(dl, r["logits"][k:]))
        out["llm_route_gap"] = max(out["llm_route_gap"], r["route_gap"])
    return out
