#!/usr/bin/env python3
"""Op-by-op bfloat16 parity of the port's two models against flax, on the CPU.

    JAX_PLATFORMS=cpu python scripts/bf16_op_parity.py [--model detector|recognizer|both]
        [--json PATH] [--xla-order] [--float32] [--views PATH] [--tiles PATH]

Runs flax's model (the JAX package's modules and shipped weights, in
bfloat16, jitted as the JAX package runs it) with ``capture_intermediates``
and every module's input sown beside its output, then feeds each op of the
port (``synapta_tpu_torch.models``) the JAX input of that op, so that one
op's rounding shows on its own. For each op it prints the elements, how
many differ from JAX's output and by how many steps of the output's
bfloat16 spacing at most, and it names the first op that differs. A line
``whole`` runs both models end to end on the same input.

Inputs, drawn by the repo's own generators:
  - detector: canvas 0 of ``make_scanned_book(pages=2, seed=2)`` (the
    scanned fixture of tests/test_torch_detector.py);
  - recognizer: the line tiles of the text blocks that the two pipelines
    score differently on ``make_test_book(8, seed=11)`` (segment 6, block
    12) and ``make_scanned_book(2, seed=2)`` (segment 1, block 18), cut by
    the port's pipeline on the CPU (``--tiles`` takes an .npy of uint8
    (N, 32, 384) tiles instead).

``--float32`` runs the detector in float32 on both sides (the float32 part
of the OCR yardstick, chip_smoke.py). ``--views`` takes an .npy of uint8
(B, S, S) DB views instead of the scanned canvas, for example those that
``scripts/near_tie_frames.py --save-views`` records from a book's run.

``--xla-order`` adds, for each ConvBlock, the block computed from XLA's own
float32 conv of the same operands (``jax.lax.conv_general_dilated``) and
with GroupNorm's sums taken in XLA's CPU order (each 32 × 32 × C/G window in
sequence, then the windows in sequence): what is left then is not rounding.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

BF16 = torch.bfloat16


def _t(a, nchw=True) -> torch.Tensor:
    """A captured JAX array as a float32 torch tensor (NHWC -> NCHW)."""
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.permute(0, 3, 1, 2) if nchw and t.dim() == 4 else t


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Elements, how many differ, and the largest difference in steps of
    the bfloat16 spacing (float32 outputs: of float32's) at the larger of
    the two values."""
    got = got.detach().float()
    want = want.float()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    diff = got != want
    bits = 23 if "f32" in name else 7
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(big)) - bits)
    steps = ((got - want).abs() / spacing)[diff]
    return {"op": name, "n": want.numel(), "differ": int(diff.sum()),
            "max_steps": float(steps.max()) if steps.numel() else 0.0,
            "max_abs_diff": float((got - want).abs().max()),
            "max_abs": float(want.abs().max())}


def _sow_inputs(next_fun, args, kwargs, context):
    if context.method_name == "__call__" and args:
        context.module.sow("intermediates", "__in__", args[0])
    return next_fun(*args, **kwargs)


def flax_capture(module, params, x):
    """(output, intermediates) of a jitted apply that sows every module's
    input (``__in__``) beside its output (``__call__``)."""
    import flax.linen as nn
    import jax

    def run(p, x):
        with nn.intercept_methods(_sow_inputs):
            return module.apply({"params": p}, x, capture_intermediates=True,
                                mutable=["intermediates"])

    out, state = jax.jit(run)(params, x)
    plain = jax.jit(lambda p, x: module.apply({"params": p}, x))(params, x)
    # the capture must not change what XLA computes
    assert np.array_equal(np.asarray(out), np.asarray(plain))
    return np.asarray(out), jax.tree.map(np.asarray, state["intermediates"])


# ------------------------------------------------------------------ detector


def scanned_canvas0() -> np.ndarray:
    """Canvas 0 of the scanned fixture as a (1, 512, 512) uint8 luma."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.io.ingest import open_pdf
    from synapta_tpu_torch.io.loader import prepare_batch
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book
    from synapta_tpu_torch.models.detector import DBLineDetector
    from synapta_tpu_torch.vision.detect import DetectionEngine

    pdf = os.path.join(tempfile.mkdtemp(prefix="bf16ops_"), "scan.pdf")
    make_scanned_book(pdf, pages=2, seed=2)
    cfg = PipelineConfig()
    doc = open_pdf(pdf)
    engine = DetectionEngine(open_pdf(pdf), cfg.detection, pixels_doc=doc)
    prepared = prepare_batch(engine, doc, cfg.detection.render_dpi,
                             cfg.ocr.crop_size, range(1))
    return np.stack([DBLineDetector._luma(c) for c in prepared[1]])


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum along the last axis in sequence."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def _group_norm_xla_order(c, blk) -> torch.Tensor:
    """A ConvBlock's GroupNorm + relu with XLA's CPU order of summation."""
    B, C, H, W = c.shape
    G = blk.groups
    k = C // G
    hb, wb = max(H // 32, 1), max(W // 32, 1)
    xs = c.to(BF16).float()
    v = xs.reshape(B, G, k, hb, H // hb, wb, W // wb).permute(0, 1, 3, 5, 4, 6, 2)
    v = v.reshape(B, G, hb * wb, -1)
    inv = torch.tensor(1.0 / (k * H * W))
    mean = (_seq_sum(_seq_sum(v)) * inv)[..., None]
    var = (_seq_sum(_seq_sum(v * v)) * inv)[..., None] - mean * mean
    mul = torch.rsqrt(var.clamp_min(0) + 1e-6).repeat_interleave(k, 1)
    mul = mul.reshape(B, C, 1, 1) * blk.gn_scale.float().reshape(1, C, 1, 1)
    y = (c - mean.repeat_interleave(k, 1).reshape(B, C, 1, 1)) * mul
    return F.relu((y + blk.gn_bias.float().reshape(1, C, 1, 1)).to(BF16))


def _xla_conv(conv, x) -> torch.Tensor:
    """XLA's float32 'SAME' conv of x and the kernel cast to x's dtype."""
    import jax

    s = conv.stride[0]
    w = conv.weight.to(x.dtype).float().permute(2, 3, 1, 0).numpy()
    y = jax.lax.conv_general_dilated(
        x.float().permute(0, 2, 3, 1).numpy(), w, (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return _t(np.asarray(y))


def detector_ops(gray: np.ndarray, xla_order: bool = False,
                 float32: bool = False) -> list:
    """The op rows of the DB detector on (B, S, S) uint8 luma ``gray``;
    ``float32``: both models in float32 (each ConvBlock's row then also
    gives the smallest var / mean² of a GroupNorm group over its input, the
    conditioning of flax's fast variance E[x²] - E[x]²)."""
    import jax.numpy as jnp

    from synapta_tpu.models import detector as jdet
    from synapta_tpu_torch.models import detector as tdet

    dt, tag = (torch.float32, "f32 ") if float32 else (BF16, "")
    tree = tdet.load_det_params()
    x = (gray.astype(np.float32) / 255.0)[..., None]
    want, cap = flax_capture(jdet.Detector(dtype=jnp.float32 if float32 else
                                           jnp.bfloat16), tree, jnp.asarray(x))
    m = tdet.detector_from_flax(tree, dtype=dt, device="cpu")
    rows = []
    with torch.no_grad():
        for i in range(len(tdet.Detector.BLOCKS)):
            b, blk = cap[f"ConvBlock_{i}"], m.blocks[i]
            xin = _t(b["__in__"][0]).to(dt)
            c = tdet.same_conv(blk.conv, xin, out_dtype=torch.float32)
            want_c = _t(b["Conv_0"]["__call__"][0])
            rows.append(compare(f"{tag}ConvBlock_{i}.conv", c.to(dt), want_c))
            rows.append(compare(f"{tag}ConvBlock_{i} (conv sum + GroupNorm + relu)",
                                blk(xin), _t(b["__call__"][0])))
            if float32:
                g = want_c.double().reshape(want_c.shape[0], blk.groups, -1)
                rows[-1]["gn_var_over_mean2_min"] = float(
                    (g.var(-1, unbiased=False) / g.mean(-1).square()).min())
            if xla_order and not float32:  # the bf16 model's XLA order
                rows.append(compare(
                    f"ConvBlock_{i} with XLA's conv sum and summation order",
                    _group_norm_xla_order(_xla_conv(blk.conv, xin), blk),
                    _t(b["__call__"][0])))
        # the laterals (Conv_0..3 read c3, c4, c2, c1) and the merges
        block_out = {i: _t(cap[f"ConvBlock_{i}"]["__call__"][0]) for i in range(11)}
        lat_src = {0: block_out[5], 1: block_out[7], 2: block_out[3], 3: block_out[1]}
        lat = {}
        for i, src in lat_src.items():
            lat[i] = _t(cap[f"Conv_{i}"]["__call__"][0])
            rows.append(compare(f"{tag}Conv_{i} (lateral)",
                                tdet.same_conv(m.lat[i], src.to(dt)), lat[i]))
        for name, a, up_src, like, into in (
                ("p3", 0, _t(cap["Conv_1"]["__call__"][0]), block_out[5], 8),
                ("p2", 2, block_out[8], block_out[3], 9),
                ("p1", 3, block_out[9], block_out[1], 10)):
            got = lat[a].to(dt) + tdet.upsample_like(up_src.to(dt), like)
            rows.append(compare(f"{tag}{name} = lateral + upsample",
                                got, _t(cap[f"ConvBlock_{into}"]["__in__"][0])))
        rows.append(compare("Conv_4 (head, f32)",
                            tdet.same_conv(m.head, block_out[10]),
                            _t(cap["Conv_4"]["__call__"][0])))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    whole = compare("whole (logits, f32)", got, _t(want))
    thresh = float(np.log(0.3 / 0.7))
    whole["prob_side_flips"] = int(((got[:, 0] > thresh)
                                    != (_t(want)[:, 0] > thresh)).sum())
    return rows + [whole]


# ---------------------------------------------------------------- recognizer


def pipeline_tiles(pdf: str, which) -> np.ndarray:
    """The tiles the port's pipeline (CPU) cuts for the named blocks of its
    segment JSON: ``which`` = [(segment, block), ...]."""
    from synapta_tpu_torch.config import PipelineConfig
    from synapta_tpu_torch.llm.fake import DisabledClient
    from synapta_tpu_torch.ocr.processor import TorchOCR
    from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

    seen, tiles_of = [], {}
    dispatch, sync = TorchOCR.recognize_dispatch, TorchOCR.recognize_sync

    def recording_dispatch(self, tiles):
        pending = dispatch(self, tiles)
        tiles_of[id(pending)] = np.asarray(tiles)
        return pending

    def recording_sync(pending):
        recs = sync(pending)
        seen.extend(zip(tiles_of.pop(id(pending)), [r["text"] for r in recs]))
        return recs

    out = tempfile.mkdtemp(prefix="bf16ops_")
    TorchOCR.recognize_dispatch = recording_dispatch
    TorchOCR.recognize_sync = staticmethod(recording_sync)
    try:
        pipe = VisualSegmentationPipeline(
            "ops", pdf, output_dir=out, use_mermaid=False,
            config=PipelineConfig(use_vision_llm=False),
            llm_client=DisabledClient(), resume=False, device="cpu")
        pipe.process()
        pipe.close()
    finally:
        TorchOCR.recognize_dispatch = dispatch
        TorchOCR.recognize_sync = staticmethod(sync)
    with open(os.path.join(out, "ops_visual_segments.json")) as f:
        segs = json.load(f)["segments"]
    tiles = []
    for s, b in which:
        text = segs[s]["ocr_result"]["blocks"][b]["text"]
        # a long line is cut into parts: take every tile whose text is in it
        tiles += [t for t, txt in seen if txt.strip() and txt.strip() in text]
    return np.stack(tiles)


def named_tiles() -> np.ndarray:
    from synapta_tpu_torch.io.pdf_writer import make_scanned_book, make_test_book

    d = tempfile.mkdtemp(prefix="bf16ops_")
    book, scan = os.path.join(d, "book.pdf"), os.path.join(d, "scan.pdf")
    make_test_book(book, pages=8, seed=11)
    make_scanned_book(scan, pages=2, seed=2)
    return np.concatenate([pipeline_tiles(book, [(6, 12)]),
                           pipeline_tiles(scan, [(1, 18)])])


def recognizer_ops(tiles: np.ndarray) -> list:
    """The op rows of the recognizer on (N, 32, W) uint8 line tiles."""
    import jax.numpy as jnp

    from synapta_tpu.models import recognizer as jrec
    from synapta_tpu_torch.models import recognizer as trec
    from synapta_tpu_torch.models.msgpack_io import load_params

    tree = load_params()
    x = tiles[..., None].astype(np.float32) / 255.0
    want, cap = flax_capture(jrec.Recognizer(), tree, jnp.asarray(x))
    m = trec.recognizer_from_flax(tree, dtype=BF16, device="cpu")
    rows = []

    def c(path):
        node = cap
        for p in path.split("/"):
            node = node[p]
        return _t(node[0], nchw=False)

    with torch.no_grad():
        for i, conv in enumerate(m.convs):
            xin = _t(cap[f"Conv_{i}"]["__in__"][0]).to(BF16)
            sh, sw = m.strides[i]
            ph = trec._same_pad(xin.shape[2], sh)
            pw = trec._same_pad(xin.shape[3], sw)
            rows.append(compare(f"Conv_{i} (+ bias)",
                                trec._conv(conv, F.pad(xin, (*pw, *ph))),
                                _t(cap[f"Conv_{i}"]["__call__"][0])))
        s = m.collapse(F.relu(_t(cap["Conv_4"]["__call__"][0]).to(BF16)))
        rows.append(compare("height mean + pos_embed", s.to(BF16),
                            c("EncoderBlock_0/__in__")))
        for j, blk in enumerate(m.blocks):
            p = f"EncoderBlock_{j}"
            att = f"{p}/MultiHeadDotProductAttention_0"
            rows.append(compare(f"{p}.LayerNorm_0 (of the unrounded sum)",
                                trec._layer_norm(blk.ln0, s, BF16),
                                c(f"{p}/LayerNorm_0/__call__")))
            h = c(f"{att}/query/__in__").to(BF16)
            qkv = {}
            for name in ("query", "key", "value"):
                want_p = c(f"{att}/{name}/__call__")  # (B, T, heads, hd)
                got = trec._dense(getattr(blk, name), h).view(want_p.shape)
                rows.append(compare(f"{p}.{name}", got, want_p))
                qkv[name] = want_p.to(BF16).transpose(1, 2)
            hd = qkv["query"].shape[-1]
            scale = torch.tensor(float(np.sqrt(hd)), dtype=BF16)
            core = trec.attention_core(qkv["query"], qkv["key"], qkv["value"],
                                       scale)
            rows.append(compare(f"{p} attention (scale, softmax, values)",
                                core.transpose(1, 2), c(f"{att}/out/__in__")))
            a_in = c(f"{att}/out/__in__").to(BF16)
            B, T = a_in.shape[:2]
            rows.append(compare(f"{p}.out",
                                trec._dense(blk.out, a_in.reshape(B, T, -1)),
                                c(f"{att}/out/__call__")))
            r1 = c(f"{p}/__in__").to(BF16).float() + c(f"{att}/__call__")
            rows.append(compare(f"{p}.LayerNorm_1 (of the unrounded sum)",
                                trec._layer_norm(blk.ln1, r1, BF16),
                                c(f"{p}/LayerNorm_1/__call__")))
            fc0_in = c(f"{p}/Dense_0/__in__").to(BF16)
            rows.append(compare(f"{p}.Dense_0", trec._dense(blk.fc0, fc0_in),
                                c(f"{p}/Dense_0/__call__")))
            gelu_in = c(f"{p}/Dense_0/__call__").to(BF16)
            rows.append(compare(f"{p} gelu", trec.gelu_tanh(gelu_in),
                                c(f"{p}/Dense_1/__in__")))
            fc1_in = c(f"{p}/Dense_1/__in__").to(BF16)
            fc1 = c(f"{p}/Dense_1/__call__")
            rows.append(compare(f"{p}.Dense_1", trec._dense(blk.fc1, fc1_in), fc1))
            s = r1.to(BF16).float() + fc1
            rows.append(compare(f"{p} output", s.to(BF16), c(f"{p}/__call__")))
        rows.append(compare("LayerNorm_0 (final, of the unrounded sum)",
                            trec._layer_norm(m.norm, s, BF16),
                            c("LayerNorm_0/__call__")))
        rows.append(compare("Dense_0 (head, f32)",
                            trec._dense(m.head, c("Dense_0/__in__").float()),
                            c("Dense_0/__call__")))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = _t(want, nchw=False)
    whole = compare("whole (logits, f32)", got, want)
    whole["argmax_differ"] = int((got.argmax(-1) != want.argmax(-1)).sum())
    return rows + [whole]


def report(model: str, rows: list) -> None:
    first = next((r["op"] for r in rows[:-1] if r["differ"]), None)
    for r in rows:
        extra = {k: v for k, v in r.items()
                 if k not in ("op", "n", "differ", "max_steps", "max_abs_diff", "max_abs")}
        print(f"{model:10s} {r['op']:58s} n={r['n']:9d} differ={r['differ']:7d} "
              f"max_steps={r['max_steps']:.3g} {extra or ''}")
    print(f"{model:10s} first op whose output differs: {first}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("detector", "recognizer", "both"),
                    default="both")
    ap.add_argument("--tiles", help=".npy of uint8 (N, 32, 384) line tiles")
    ap.add_argument("--xla-order", action="store_true")
    ap.add_argument("--float32", action="store_true",
                    help="the detector in float32 on both sides")
    ap.add_argument("--views", help=".npy of uint8 (B, S, S) DB views")
    ap.add_argument("--json", help="write the rows here")
    args = ap.parse_args(argv)
    out = {}
    if args.model in ("detector", "both"):
        gray = np.load(args.views) if args.views else scanned_canvas0()
        out["detector"] = detector_ops(gray, args.xla_order, args.float32)
        report("detector", out["detector"])
    if args.model in ("recognizer", "both"):
        tiles = np.load(args.tiles) if args.tiles else named_tiles()
        out["recognizer"] = recognizer_ops(tiles)
        report("recognizer", out["recognizer"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
