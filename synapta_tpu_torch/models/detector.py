"""DB-style text-line detector and its trainer — counterpart of
synapta_tpu/models/detector.py.

A tiny FPN over a 512² page raster predicts a shrunk-text probability map
at half resolution; inference binarizes it, closes word gaps, labels the
line blobs with the CC kernel (its fifth call site) and reduces them to the
same compact (B, 128, 5) ``[x0, y0, x1+1, y1+1, area]`` tensor as the
heuristic path, which the host unshrinks, filters and refines.

Parity with the flax module (each pinned by a test):
  - flax ``SAME`` on a stride-2 conv of an even axis pads (0, 1): every
    conv pads explicitly (``_same_pad``) and runs with padding=0;
  - GroupNorm: groups min(8, C), eps 1e-6, statistics in float32 with
    flax's fast variance max(0, E[x²] - E[x]²), affine in float32, the
    result cast back to the compute dtype;
  - ``jax.image.resize(.., "bilinear")`` upsampling equals
    ``F.interpolate(bilinear, align_corners=False)``, borders included;
  - the trunk runs in ``dtype`` (bfloat16 in production), the head conv in
    float32 with a bias. Parameters are stored in ``param_dtype`` (float32
    for training, as flax keeps them; ``detector_from_flax`` stores the
    convs in the compute dtype for inference) and each conv kernel is cast
    to the compute dtype where flax casts it.

Rounding. In bfloat16 the model rounds where XLA rounds flax's model on the
CPU (its compiled HLO, read op by op with ``scripts/bf16_op_parity.py``):
a ConvBlock's GroupNorm takes its statistics from the conv's output rounded
to bfloat16 but normalises the conv's float32 sum, so the block's conv runs
in float32 on the bfloat16 operands (exact products, float32 sums); the
upsample resizes rows, rounds, then columns, and rounds; the laterals and
each merge's sum are rounded as flax writes them.

The convs go to cuDNN, as the JAX package leaves them to XLA. The host
code (``unshrink_boxes``, the refine knobs, ``_snap_box_to_ink``,
``refine_line_boxes`` and DBLineDetector's ``_luma``, ``_views`` and
``detect_lines``) is a verbatim copy of the original; a test pins each copy.

Training (``train_detector``, ``python -m synapta_tpu_torch.models.detector
--device cuda``): the synthetic pages and their targets (``shrink_box``,
``render_det_page``, ``make_det_batch``) are verbatim copies; ``db_loss``
is the DB loss with 3:1 hard-negative mining, on a full stable sort where
the JAX package takes ``lax.top_k`` of every pixel; the optimiser is
``optim.adamw`` over a warmup-cosine schedule. Checkpoints are flax msgpack
files that the JAX package reads, written under
``synapta_tpu_torch/_build/weights/`` unless ``--out`` names another path.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from synapta_tpu_torch.device import resolve_device
from synapta_tpu_torch.models.recognizer import _same_pad, flax_init_

# The port shares the JAX package's weight files: they are read by file path
# from the repo root (<repo>/synapta_tpu/models/weights/), never imported.
DET_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "synapta_tpu", "models", "weights", "detector.msgpack",
)
# Where the port's trainer writes (git-ignored); never the shared files above.
DET_OUT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "weights", "detector.msgpack",
)


def group_norm(x: torch.Tensor, groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-6,
               dtype: torch.dtype = None) -> torch.Tensor:
    """flax ``nn.GroupNorm`` on an NCHW tensor as XLA computes it:
    statistics in at least float32 with the fast variance
    max(0, E[x²] - E[x]²) (the mean as the sum times 1/n), the scale folded
    into the reciprocal standard deviation, the result in ``dtype`` (default
    x's). ``x`` may be a conv's float32 sum whose output flax rounds to
    ``dtype``: the statistics read x rounded to it, the normalisation reads
    x itself, as XLA keeps the conv's sum unrounded there."""
    B, C, H, W = x.shape
    dtype = x.dtype if dtype is None else dtype
    acc = torch.promote_types(dtype, torch.float32)
    xs = x.to(dtype).to(acc).reshape(B, groups, -1)
    inv = 1.0 / xs.shape[-1]
    mean = xs.sum(dim=-1, keepdim=True) * inv
    var = ((xs * xs).sum(dim=-1, keepdim=True) * inv - mean * mean).clamp_min(0.0)
    k = C // groups
    mul = torch.rsqrt(var + eps).repeat_interleave(k, dim=1)
    mul = mul.reshape(B, C, 1, 1) * scale.reshape(1, C, 1, 1)
    y = x.to(acc) - mean.repeat_interleave(k, dim=1).reshape(B, C, 1, 1)
    return (y * mul + bias.reshape(1, C, 1, 1)).to(dtype)


def same_conv(conv: nn.Conv2d, x: torch.Tensor,
              out_dtype: torch.dtype = None) -> torch.Tensor:
    """A padding=0 conv with flax 'SAME' padding applied explicitly, its
    parameters cast to x's dtype as flax casts them to the compute dtype.
    ``out_dtype=torch.float32`` on a bfloat16 x returns the float32 sum of
    those products unrounded (the conv runs in float32 on x and the kernel
    as they are in bfloat16, whose products float32 holds exactly), as XLA
    computes a bfloat16 conv on the CPU before GroupNorm reads it."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph = _same_pad(x.shape[2], sh, kh)
    pw = _same_pad(x.shape[3], sw, kw)
    w = conv.weight.to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    x = F.pad(x, (*pw, *ph))
    if out_dtype is not None and out_dtype != x.dtype:
        x, w = x.to(out_dtype), w.to(out_dtype)
        bias = None if bias is None else bias.to(out_dtype)
    return F.conv2d(x, w, bias, conv.stride)


def upsample_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(t, like's H and W, "bilinear")`` for an upsample
    as XLA computes it: one axis at a time, rows first, each pass rounded to
    t's dtype. Half-pixel centres, edge taps clamped (jax drops the
    out-of-range tap and renormalises, which gives the same value)."""
    h, w = like.shape[2:]
    rows = F.interpolate(t, size=(h, t.shape[3]), mode="bilinear",
                         align_corners=False, antialias=False).to(t.dtype)
    return F.interpolate(rows, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=False).to(t.dtype)


class ConvBlock(nn.Module):
    """3x3 conv (no bias) + GroupNorm + relu, as flax's ConvBlock: the conv's
    sum (float32, or x's dtype if wider) goes to ``group_norm`` unrounded,
    the result in x's dtype."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3, stride=stride, bias=False,
                              dtype=param_dtype)
        self.groups = min(8, features)
        self.gn_scale = nn.Parameter(torch.ones(features))
        self.gn_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = same_conv(self.conv, x,
                      out_dtype=torch.promote_types(x.dtype, torch.float32))
        return F.relu(group_norm(c, self.groups, self.gn_scale, self.gn_bias,
                                 dtype=x.dtype))


class Detector(nn.Module):
    """Tiny FPN + DB head. (B, 1, S, S) float in [0, 1] -> (B, 2, S/2, S/2)
    float32 logits: channel 0 prob, channel 1 thresh."""

    # (in, out, stride) of flax's ConvBlock_0..10, in flax's naming order:
    # 0-7 the backbone, 8 p3 -> 32, 9 p2 -> 16, 10 the head block
    BLOCKS = ((1, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2),
              (64, 64, 1), (64, 96, 2), (96, 96, 1), (64, 32, 1), (32, 16, 1),
              (16, 16, 1))
    # (in, out) of the 1x1 laterals Conv_0..3: c3, c4, c2, c1 (flax names
    # them in call order, and `lat(c3) + up(lat(c4))` evaluates left first)
    LATERALS = ((64, 64), (96, 64), (32, 32), (16, 16))

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList(ConvBlock(i, o, s, param_dtype)
                                    for i, o, s in self.BLOCKS)
        self.lat = nn.ModuleList(nn.Conv2d(i, o, 1, bias=False,
                                           dtype=param_dtype)
                                 for i, o in self.LATERALS)
        self.head = nn.Conv2d(16, 2, 3, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, lat = self.blocks, self.lat
        x = x.to(self.dtype)
        c1 = b[1](b[0](x))   # 1/2
        c2 = b[3](b[2](c1))  # 1/4
        c3 = b[5](b[4](c2))  # 1/8
        c4 = b[7](b[6](c3))  # 1/16
        # top-down merge (FPN): lateral 1x1 + upsample-add
        p3 = same_conv(lat[0], c3) + upsample_like(same_conv(lat[1], c4), c3)
        p2 = same_conv(lat[2], c2) + upsample_like(b[8](p3), c2)
        p1 = same_conv(lat[3], c1) + upsample_like(b[9](p2), c1)
        h = b[10](p1)  # 1/2 resolution head
        return same_conv(self.head, h.to(torch.float32))


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax detector tree (numpy leaves) -> Detector's state_dict (float32).
    Conv kernels HWIO -> OIHW."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def conv(k):
        return t(np.transpose(k, (3, 2, 0, 1)))

    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(Detector.BLOCKS)):
        blk = tree[f"ConvBlock_{i}"]
        sd[f"blocks.{i}.conv.weight"] = conv(blk["Conv_0"]["kernel"])
        sd[f"blocks.{i}.gn_scale"] = t(blk["GroupNorm_0"]["scale"])
        sd[f"blocks.{i}.gn_bias"] = t(blk["GroupNorm_0"]["bias"])
    for i in range(len(Detector.LATERALS)):
        sd[f"lat.{i}.weight"] = conv(tree[f"Conv_{i}"]["kernel"])
    sd["head.weight"] = conv(tree["Conv_4"]["kernel"])
    sd["head.bias"] = t(tree["Conv_4"]["bias"])
    return sd


def params_to_flax(sd) -> Dict:
    """The exact inverse of ``params_from_flax``: a Detector state_dict ->
    the flax tree (float32 numpy leaves), keys in flax's creation order."""
    def a(key):
        return np.ascontiguousarray(
            sd[key].detach().to("cpu", torch.float32).numpy())

    def conv(key):
        return np.ascontiguousarray(a(key).transpose(2, 3, 1, 0))

    def block(i):
        return {"Conv_0": {"kernel": conv(f"blocks.{i}.conv.weight")},
                "GroupNorm_0": {"scale": a(f"blocks.{i}.gn_scale"),
                                "bias": a(f"blocks.{i}.gn_bias")}}

    # flax creates the backbone, then c3's and c4's laterals, the p3 block,
    # c2's lateral, the p2 block, c1's lateral, the head block, the head
    order = [f"ConvBlock_{i}" for i in range(8)] + [
        "Conv_0", "Conv_1", "Conv_2", "ConvBlock_8", "Conv_3", "ConvBlock_9",
        "ConvBlock_10", "Conv_4"]
    tree: Dict = {}
    for name in order:
        i = int(name.rsplit("_", 1)[1])
        if name.startswith("ConvBlock_"):
            tree[name] = block(i)
        elif i < len(Detector.LATERALS):
            tree[name] = {"kernel": conv(f"lat.{i}.weight")}
        else:
            tree[name] = {"kernel": conv("head.weight"), "bias": a("head.bias")}
    return tree


def init_params(model: Detector, generator: torch.Generator) -> Detector:
    """flax's initialisers on ``model`` in place: lecun_normal conv kernels,
    a zero head bias, GroupNorm ones and zeros."""
    flax_init_(model, generator)
    for blk in model.blocks:
        nn.init.ones_(blk.gn_scale)
        nn.init.zeros_(blk.gn_bias)
    return model


def detector_from_flax(tree, dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> Detector:
    """Build a Detector from the flax tree, load it, and put it in eval mode
    on ``device``. Conv weights are stored in ``dtype`` (inference);
    GroupNorm's affine and the head stay float32, as flax keeps them."""
    model = Detector(dtype=dtype, param_dtype=dtype)
    model.load_state_dict(params_from_flax(tree))
    return model.to(device).eval()


def load_det_params(path: str = DET_WEIGHTS_PATH):
    """The detector checkpoint as a nested dict of numpy arrays."""
    from synapta_tpu_torch.models.msgpack_io import msgpack_restore

    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---------------------------------------------------------------- targets


def shrink_box(x0, y0, x1, y1, ratio: float = 0.3) -> Tuple[int, int, int, int]:
    """Shrink an axis-aligned line box by d = ratio * min(w, h).

    DB's polygon offset d = A(1-r^2)/L nearly collapses thin text lines
    (w >> h gives d ~ 0.42h, leaving 16% of the height) and has no
    stable inverse there. Text lines in this corpus are axis-aligned
    rects, so a min-side-proportional offset is used instead: it keeps
    40% of the line height (separating adjacent lines at any leading
    >= 1.1em) and inverts exactly — unshrink with r' = r/(1-2r)."""
    w, h = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
    d = ratio * min(w, h)
    return (
        int(round(x0 + d)), int(round(y0 + d)),
        int(round(x1 - d)), int(round(y1 - d)),
    )



def render_det_page(
    rng: np.random.Generator, size: int = 512,
    sheet_frac: float = 0.25, dense_frac: float = 0.4,
) -> Tuple[np.ndarray, List[List[float]]]:
    """One synthetic page raster + its text-line pixel boxes.

    Pages mix body text, tiny tick labels, and the graphic distractors the
    detector must NOT fire on (rules, bars, circles, polylines) — rendered
    through the native engine so the glyph rasterization matches inference.
    """
    from synapta_tpu_torch.io.ingest import Document
    from synapta_tpu_torch.io.pdf_writer import SyntheticBook
    from synapta_tpu_torch.models.synthdata import fit_text, random_text

    pw = ph = 360.0
    book = SyntheticBook(width=pw, height=ph)
    c = book.new_page()
    boxes_pdf: List[Tuple[float, float, float, float]] = []
    # spreadsheet/screenshot mode (25%): full-page cell grid, grey fills,
    # tiny number-heavy cell text — the golden-crop domain where the r4
    # detector fragmented words and missed rows (eval --golden r5 first
    # measurement: containment recall 0.52)
    sheet = rng.random() < sheet_frac
    if sheet:
        from synapta_tpu_torch.models.synthdata import _screenshot_text

        col_w = float(rng.uniform(34, 72))
        row_h = float(rng.uniform(10, 16))
        g = float(rng.uniform(0.55, 0.82))
        x_off = float(rng.uniform(0.0, col_w))
        y_off = float(rng.uniform(0.0, row_h))
        gx = x_off
        while gx < pw:
            c.line(gx, 0, gx, ph, width=0.5, color=(g, g, g))
            gx += col_w
        gy = y_off
        while gy < ph:
            c.line(0, gy, pw, gy, width=0.5, color=(g, g, g))
            gy += row_h
        for _ in range(int(rng.integers(0, 5))):  # grey panels / fills
            fx0 = rng.uniform(0, pw - 110)
            fy0 = rng.uniform(0, ph - 60)
            f = float(rng.uniform(0.78, 0.94))
            c.rect(fx0, fy0, fx0 + rng.uniform(30, 110),
                   fy0 + rng.uniform(10, 60), fill=(f, f, f), stroke=None)
        n_rows = max(int(ph / row_h), 1)
        n_cols = max(int(pw / col_w), 1)
        used: set = set()
        for _ in range(int(rng.integers(28, 70))):
            rr = int(rng.integers(0, n_rows))
            kk = int(rng.integers(0, n_cols))
            if (rr, kk) in used:
                continue
            sz = row_h * float(rng.uniform(0.5, 0.72))
            x = x_off + kk * col_w + float(rng.uniform(1, 5))
            y = y_off + rr * row_h + float(rng.uniform(0.5, 2.5))
            bb = c.text(x, y, _screenshot_text(rng), size=sz, record=False)
            if bb is None or bb[2] >= pw or bb[3] >= ph:
                continue
            # skip cell texts whose boxes collide (a wide string spilling
            # into the neighbor cell would create overlapping truth)
            if any(
                not (bb[2] <= o[0] or o[2] <= bb[0]
                     or bb[3] <= o[1] or o[3] <= bb[1])
                for o in boxes_pdf
            ):
                continue
            used.add((rr, kk))
            boxes_pdf.append(bb)
        for _ in range(int(rng.integers(0, 3))):  # title-size lines
            sz = float(rng.uniform(9, 14))
            bb = c.text(
                rng.uniform(10, pw * 0.4), rng.uniform(4, ph * 0.3),
                fit_text(random_text(rng), 36), size=sz, record=False,
            )
            if bb is not None and bb[2] < pw and bb[3] < ph and not any(
                not (bb[2] <= o[0] or o[2] <= bb[0]
                     or bb[3] <= o[1] or o[3] <= bb[1])
                for o in boxes_pdf
            ):
                boxes_pdf.append(bb)
    # graphic distractors first (text draws over them like real charts)
    for _ in range(int(rng.integers(0, 4)) if not sheet else 0):
        kind = rng.integers(0, 4)
        x0, y0 = rng.uniform(10, pw - 80), rng.uniform(10, ph - 80)
        w, h = rng.uniform(20, 120), rng.uniform(20, 100)
        if kind == 0:
            c.rect(x0, y0, x0 + w, y0 + h,
                   fill=None if rng.random() < 0.5 else
                   tuple(rng.uniform(0.2, 0.9, 3)))
        elif kind == 1:
            c.line(x0, y0, x0 + w, y0 + (0 if rng.random() < 0.5 else h),
                   width=float(rng.uniform(0.5, 2.0)))
        elif kind == 2:
            c.circle(x0 + w / 2, y0 + h / 2, min(w, h) / 2,
                     fill=None if rng.random() < 0.5 else
                     tuple(rng.uniform(0.2, 0.9, 3)))
        else:
            pts = [(x0 + w * t / 6.0,
                    y0 + h * rng.random()) for t in range(7)]
            c.polyline(pts, width=float(rng.uniform(0.8, 1.6)))
    # dense-paragraph mode (40%): full-width lines at tight leading — the
    # scanned-textbook distribution where round-3's sparse training pages
    # left the probability map weak (measured ~0.1-0.3 on true lines of
    # the make_scanned_book fixture -> fragmented word boxes, missed rows)
    dense = (not sheet) and rng.random() < dense_frac
    if sheet:
        n_lines = 0
    else:
        n_lines = int(rng.integers(24, 40)) if dense else int(rng.integers(6, 22))
    y = rng.uniform(8, 24)
    for _ in range(n_lines):
        if y > ph - 16:
            break
        tiny = (not dense) and rng.random() < 0.25
        if dense:
            sz = float(rng.uniform(6, 10))
            # long full-width prose lines (2-3 generator draws joined)
            text = fit_text(
                " ".join(random_text(rng) for _ in range(3)), 72
            )
            x = rng.uniform(6, 20)
        else:
            sz = float(rng.uniform(5, 8)) if tiny else float(rng.uniform(8, 16))
            text = fit_text(random_text(rng), 40 if not tiny else 8)
            x = rng.uniform(6, pw * 0.5)
        bb = c.text(x, y, text, size=sz, bold=bool(rng.random() < 0.2),
                    record=False)
        if bb is not None:
            boxes_pdf.append(bb)
        y += sz * (rng.uniform(1.15, 1.5) if dense else rng.uniform(1.3, 2.6))
    doc = Document(data=book.tobytes())
    scale = size / pw
    if sheet and rng.random() < 0.5:
        # the golden crop's canvas is a ~0.74x box-downscale of an
        # already-antialiased screenshot: render high then box-downscale
        # so the detector sees that double-softened glyph profile too
        from synapta_tpu_torch.io.ingest import box_downscale

        f = float(rng.uniform(1.15, 1.5))
        hi = doc.render(0, dpi=72.0 * scale * f)
        page = box_downscale(
            hi, int(round(hi.shape[0] / f)), int(round(hi.shape[1] / f))
        )
    else:
        page = doc.render(0, dpi=72.0 * scale)
    doc.close()
    gray = (
        0.299 * page[..., 0] + 0.587 * page[..., 1] + 0.114 * page[..., 2]
    ).astype(np.float32) / 255.0
    canvas = np.ones((size, size), np.float32)
    canvas[: min(size, gray.shape[0]), : min(size, gray.shape[1])] = gray[
        :size, :size
    ]
    # scanned-style degradation (50%; always for dense pages): grey paper,
    # noise, skew, JPEG ringing — the domain where this detector earns its
    # keep over the heuristic. Matches make_scanned_book's pipeline
    # (grey bg 235, sigma-5 noise, 0.004 row-shift skew, JPEG embedding).
    skew_shift = None
    if sheet:
        # screenshots embed as JPEG but are never skewed or paper-grey
        if rng.random() < 0.6:
            from PIL import Image as _I
            import io as _io

            bio = _io.BytesIO()
            _I.fromarray((canvas * 255).astype(np.uint8)).save(
                bio, format="JPEG", quality=int(rng.integers(70, 95))
            )
            bio.seek(0)
            canvas = np.asarray(_I.open(bio)).astype(np.float32) / 255.0
        if rng.random() < 0.4:
            canvas = np.clip(
                canvas + rng.normal(0, rng.uniform(0.005, 0.02),
                                    canvas.shape), 0, 1
            ).astype(np.float32)
    elif dense or rng.random() < 0.5:
        canvas = canvas * rng.uniform(0.82, 0.95) + rng.uniform(0.02, 0.08)
        if rng.random() < 0.6:  # scanner skew: integer row shifts
            slope = rng.uniform(-0.012, 0.012)
            skew_shift = (np.arange(size) * slope).astype(int)
            for r in range(size):
                if skew_shift[r]:
                    canvas[r] = np.roll(canvas[r], skew_shift[r])
        if rng.random() < 0.5:  # JPEG round trip (block artifacts)
            from PIL import Image as _I
            import io as _io

            bio = _io.BytesIO()
            _I.fromarray((canvas * 255).astype(np.uint8)).save(
                bio, format="JPEG", quality=int(rng.integers(70, 92))
            )
            bio.seek(0)
            canvas = np.asarray(_I.open(bio)).astype(np.float32) / 255.0
        canvas = np.clip(
            canvas + rng.normal(0, rng.uniform(0.01, 0.04), canvas.shape), 0, 1
        ).astype(np.float32)
    px_boxes = []
    for b in boxes_pdf:
        if not (b[2] > b[0] and b[3] > b[1] and b[0] * scale < size
                and b[1] * scale < size):
            continue
        x0, y0, x1, y1 = (v * scale for v in b)
        if skew_shift is not None:  # labels follow the row-shifted glyphs
            yc = min(max(int((y0 + y1) / 2), 0), size - 1)
            x0 += skew_shift[yc]
            x1 += skew_shift[yc]
        px_boxes.append([x0, y0, x1, y1])
    return canvas, px_boxes



def make_det_batch(
    rng: np.random.Generator, batch: int = 8, size: int = 512,
    sheet_frac: float = 0.25, dense_frac: float = 0.4,
):
    """-> (images (B,S,S,1), prob* (B,S/2,S/2), band (B,S/2,S/2),
    thresh* (B,S/2,S/2)) — targets at half resolution."""
    half = size // 2
    imgs = np.zeros((batch, size, size, 1), np.float32)
    prob_t = np.zeros((batch, half, half), np.float32)
    band = np.zeros((batch, half, half), np.float32)
    thr_t = np.zeros((batch, half, half), np.float32)
    for i in range(batch):
        canvas, boxes = render_det_page(rng, size, sheet_frac, dense_frac)
        imgs[i, :, :, 0] = canvas
        for b in boxes:
            hx0, hy0, hx1, hy1 = (v / 2.0 for v in b)
            sx0, sy0, sx1, sy1 = shrink_box(hx0, hy0, hx1, hy1)
            sx0, sy0 = max(sx0, 0), max(sy0, 0)
            sx1, sy1 = min(sx1, half), min(sy1, half)
            if sx1 > sx0 and sy1 > sy0:
                prob_t[i, sy0:sy1, sx0:sx1] = 1.0
            # border band: expanded minus shrunk; thresh target high at
            # the true border, falling to background outside (constant
            # approximation of DB's distance-normalized map — exact for
            # the axis-aligned line geometry this corpus has)
            ex0 = max(int(hx0 - 2), 0)
            ey0 = max(int(hy0 - 2), 0)
            ex1 = min(int(np.ceil(hx1 + 2)), half)
            ey1 = min(int(np.ceil(hy1 + 2)), half)
            if ex1 > ex0 and ey1 > ey0:
                band[i, ey0:ey1, ex0:ex1] = 1.0
                thr_t[i, ey0:ey1, ex0:ex1] = 0.7
        inner = prob_t[i] > 0
        band[i][inner] = 1.0
        thr_t[i][inner] = 0.3
    return imgs, prob_t, band, thr_t


# ------------------------------------------------------------------ loss


def db_loss(model: Detector, imgs: torch.Tensor, prob_t: torch.Tensor,
            band: torch.Tensor, thr_t: torch.Tensor) -> torch.Tensor:
    """The DB loss of ``model`` on (B, 1, S, S) images against (B, S/2, S/2)
    targets: BCE on the probability map with 3:1 online hard-negative
    mining, L1 on the threshold map inside the border band, and the dice of
    the differentiable binarization."""
    out = model(imgs)
    p_logit = out[:, 0]
    t_pred = torch.sigmoid(out[:, 1])
    # BCE with online hard-negative mining, 3:1 neg:pos (DB recipe)
    bce = optax_sigmoid_bce(p_logit, prob_t)
    pos = prob_t > 0.5
    n_pos = pos.sum().clamp_min(1)
    # torch.where, never a multiply by a mask: the positives are -inf here
    neg_bce = torch.where(pos, -torch.inf, bce)
    k = torch.minimum(3 * n_pos, bce.numel() - n_pos)
    # lax.top_k over every pixel is a full descending sort. Uniform
    # background gives exactly tied values, and which of them fall inside k
    # decides where the gradient lands: a stable sort keeps ties in index
    # order, the lower index first, as XLA's top_k does
    topk = torch.sort(neg_bce.reshape(-1), descending=True, stable=True).values
    idx = torch.arange(topk.numel(), device=topk.device)
    neg_sum = torch.where(
        idx < k, torch.where(torch.isfinite(topk), topk, 0.0), 0.0).sum()
    l_prob = (torch.where(pos, bce, 0.0).sum() + neg_sum) / (n_pos + k)
    # threshold map L1 inside the border band
    l_thr = (torch.abs(t_pred - thr_t) * band).sum() / band.sum().clamp_min(1.0)
    # differentiable binarization dice
    b_hat = torch.sigmoid(50.0 * (torch.sigmoid(p_logit) - t_pred))
    inter = (b_hat * prob_t).sum()
    l_bin = 1.0 - 2.0 * inter / (b_hat.sum() + prob_t.sum() + 1e-6)
    return l_prob + 10.0 * l_thr + l_bin


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_p = F.logsigmoid(logits)
    log_np = F.logsigmoid(-logits)
    return -(labels * log_p + (1.0 - labels) * log_np)


# ------------------------------------------------------------- training


def save_det_params(params, path: str = DET_OUT_PATH) -> None:
    """Write a detector parameter tree (flax layout) as a flax msgpack file."""
    from synapta_tpu_torch.models.msgpack_io import write_params

    write_params(params, path)


def make_det_train_step(model: Detector, tx):
    """step(imgs, prob_t, band, thr_t) -> loss on a ``make_det_batch``
    batch: one update of ``model`` by ``tx``, the loss left on the device."""
    from synapta_tpu_torch.models.train import make_step

    return make_step(model, tx, db_loss)


def train_detector(
    steps: int = 400,
    batch: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    size: int = 512,
    out: str = DET_OUT_PATH,
    init_from: str | None = None,
    log_every: int = 50,
    sheet_frac: float = 0.25,
    dense_frac: float = 0.4,
    device="cuda",
) -> Dict:
    """Train the detector on synthetic pages on ``device`` (bfloat16 compute
    on the GPU, float32 on the CPU: ``train.compute_dtype``), from scratch
    or from the checkpoint ``init_from``, with adamw over a 50-step warmup
    and a cosine
    decay to ``steps`` (optax raises when steps <= 50, and so does this).
    Writes the float32 parameters to ``out`` every ``log_every`` steps and
    at the end. Returns the run: the trained model, per-step losses, and
    the wall, host data, host step and device step seconds (the last on
    CUDA only: CUDA-event spans of each step's work)."""
    from synapta_tpu_torch.hostlibs import ensure_synthdata_fonts
    from synapta_tpu_torch.models.optim import adamw, warmup_cosine_decay_schedule
    from synapta_tpu_torch.models.train import compute_dtype, run_steps

    dev = resolve_device(device)
    ensure_synthdata_fonts()
    model = Detector(dtype=compute_dtype(dev), param_dtype=torch.float32)
    if init_from:
        model.load_state_dict(params_from_flax(load_det_params(init_from)))
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    tx = adamw(model.parameters(),
               warmup_cosine_decay_schedule(0.0, lr, 50, steps))
    step_fn = make_det_train_step(model, tx)
    run = run_steps(
        step_fn, lambda rng: make_det_batch(rng, batch, size, sheet_frac,
                                            dense_frac),
        np.random.default_rng(seed), steps, log_every, dev,
        lambda: save_det_params(params_to_flax(model.state_dict()), out))
    save_det_params(params_to_flax(model.state_dict()), out)
    print(f"saved -> {out}")
    run["model"] = model.eval()
    return run



# ------------------------------------------------------------------ host


def unshrink_boxes(boxes: np.ndarray, ratio: float = 0.75) -> np.ndarray:
    """Exact inverse of shrink_box: d' = r/(1-2r) * min(w', h')."""
    out = boxes.copy().astype(np.float32)
    w = np.maximum(boxes[..., 2] - boxes[..., 0], 1.0)
    h = np.maximum(boxes[..., 3] - boxes[..., 1], 1.0)
    d = ratio * np.minimum(w, h)
    out[..., 0] -= d
    out[..., 1] -= d
    out[..., 2] += d
    out[..., 3] += d
    return out


# ------------------------------------------------------------ inference


@torch.inference_mode()
def db_logits(model: Detector, gray_u8) -> torch.Tensor:
    """(B, S, S) uint8 (host numpy or tensor) -> (B, S/2, S/2) float32
    probability logits on the model's device. uint8 crosses H2D at 1/4 the
    float cost."""
    if not isinstance(gray_u8, torch.Tensor):
        gray_u8 = torch.from_numpy(np.ascontiguousarray(gray_u8))
    g = gray_u8.to(model.head.weight.device, non_blocking=True)
    gray = g.to(torch.float32)[:, None] / 255.0
    return model(gray)[:, 0]


@torch.inference_mode()
def closed_mask(logits: torch.Tensor, prob_thresh: float) -> torch.Tensor:
    """prob > thresh, then a horizontal closing: the shrunk-text map goes
    quiet in word gaps (they ARE background in the DB target), so close
    gaps up to ~1.5x the typical half-res line height before CC — standard
    DB box-forming merges word fragments into line boxes the same way."""
    from synapta_tpu_torch.ops.filters import dilate, erode

    mask = (torch.sigmoid(logits) > prob_thresh).to(torch.float32)
    return erode(dilate(mask, 1, 9), 1, 9).contiguous()


@torch.inference_mode()
def mask_boxes(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) closed mask -> (B, 128, 5) [x0, y0, x1+1, y1+1, area] of
    the 128 largest components. A CUDA mask runs the CC kernel."""
    from synapta_tpu_torch.ops.cc import (
        component_stats_device,
        connected_components,
    )

    labels = connected_components(mask, max_iters=10)
    stats = component_stats_device(labels, k=128)
    return torch.stack(
        [stats["x0"], stats["y0"], stats["x1"] + 1.0, stats["y1"] + 1.0,
         stats["area"]],
        dim=-1,
    )


def boxes_device(model: Detector, gray_u8, prob_thresh: float) -> torch.Tensor:
    """(B, S, S) uint8 -> (B, 128, 5) boxes on the model's device, enqueued
    without waiting (counterpart of the JAX module's ``_boxes_device``).
    Stage ``db_post``: the post stage, with the real views (not all white,
    as padding is) of a host batch while a profiler records."""
    from synapta_tpu_torch.utils.profiler import TIMERS, recording

    logits = db_logits(model, gray_u8)
    with TIMERS.stage("db_post") as attrs:
        if recording() and isinstance(gray_u8, np.ndarray):
            attrs["views"] = int(
                (gray_u8.reshape(gray_u8.shape[0], -1).min(axis=1) < 255).sum())
        return mask_boxes(closed_mask(logits, prob_thresh))


# refine knobs (module-level so eval sweeps can probe alternatives; the
# defaults are the measured-best configuration on the scanned fixture +
# golden crop)
_SNAP_FIRST = True   # snap fragments before row-merging
_ROW_FRAC = 0.03     # row-ink on-threshold as a fraction of box width
_V_CAP = 1.6         # max vertical growth of a snap, in line heights
_FLOOR_FRAC = 0.06   # valley floor as a fraction of the row-ink peak


def _snap_box_to_ink(gray: np.ndarray, box: List[int]) -> List[int]:
    """Snap one line box to the ink it covers (host, numpy).

    The DB probability map is trained on SHRUNK line targets; unshrinking
    recovers the nominal box but the map fades at faint strokes, so raw
    boxes clip ascenders/descenders and first/last characters (measured
    on the scanned fixture: 'allocation' -> 'allocati'). Within a padded
    window around the box, threshold ink against the local background and
    (a) re-fit the vertical span to the inky rows connected to the box
    center, (b) extend the horizontal span outward over ink runs whose
    gaps stay below a word gap (~0.3 line heights), then tighten to the
    outermost inky columns."""
    H, W = gray.shape
    x0, y0, x1, y1 = (int(v) for v in box)
    h = max(y1 - y0, 1)
    # wide horizontal window: prob-map fade can clip 1-2 characters
    # (~0.5-1.5 line heights) off a line end; the extension loop below is
    # still bounded by the first word gap it meets
    px = max(4, int(round(2.0 * h)))
    py = max(2, int(round(0.4 * h)))
    X0, X1 = max(0, x0 - px), min(W, x1 + px)
    Y0, Y1 = max(0, y0 - py), min(H, y1 + py)
    if X1 - X0 < 2 or Y1 - Y0 < 2:
        return [x0, y0, x1, y1]
    win = gray[Y0:Y1, X0:X1]
    lo = float(np.percentile(win, 2))
    hi = float(np.percentile(win, 98))
    if hi - lo < 30.0:  # no contrast: blank window, keep the box
        return [x0, y0, x1, y1]
    # ink = decisively darker than background: anchored at the DARK end so
    # light-grey furniture (spreadsheet grid rules at ~0.55-0.8 grey) stays
    # background — a bg-relative cut classified grid lines as ink and the
    # snap crawled along them
    ink = win < (lo + 0.45 * (hi - lo))
    # vertical: follow the row-ink profile out from the box center. Two
    # regimes must both work: scanned print, whose antialiased first/last
    # rows taper 60 -> 20 -> 8 -> 3 -> 0 and BELONG to the line (a fixed
    # on-threshold clips them, costing glyph tops at the hires tile cut),
    # and dense screenshots, whose inter-row gaps carry JPEG ringing of
    # 1-3 px ink that must NOT bridge to the next row. Valley logic
    # handles both: keep growing through solid ink (>= floor) or down a
    # decreasing tail, stop the moment the profile RISES from below the
    # floor (the far side of the inter-row valley).
    row_ink = ink[:, max(x0 - X0, 0):max(x1 - X0, 1)].sum(axis=1)
    peak = float(np.percentile(row_ink, 95))
    floor = max(2.0, _FLOOR_FRAC * peak)
    cy = min(max((y0 + y1) // 2 - Y0, 0), row_ink.shape[0] - 1)
    if row_ink[cy] < floor:
        near = np.nonzero(row_ink >= floor)[0]
        if near.size == 0:
            return [x0, y0, x1, y1]
        cy = int(near[np.argmin(np.abs(near - cy))])

    def grow(i: int, step: int, last: int) -> int:
        while 0 <= i + step <= last:
            nxt = float(row_ink[i + step])
            if nxt >= floor and float(row_ink[i]) >= floor:
                i += step          # solid ink
            elif 1.0 <= nxt < float(row_ink[i]):
                i += step          # decreasing antialias tail
            else:
                break              # valley floor / far-side rise
        # sub-floor tail walk: descender/ascender STEMS are constant-width,
        # so their row profile plateaus (4,4,3,3,0) and the strictly-
        # decreasing rule above clips them at the baseline — measured as
        # y->v, p->o, g->q substitutions on the scanned fixture. Walk
        # through low flat ink with a bounded depth budget; abort back to
        # the valley cut if the profile rises to the floor again (that is
        # the far side of an inter-row valley — screenshot JPEG ringing —
        # not a descender).
        budget = max(2, int(round(0.4 * max(h, 3))))
        j, walked = i, 0
        while 0 <= j + step <= last and walked < budget:
            nxt = float(row_ink[j + step])
            if nxt >= floor:
                return i           # rising into a neighbor row
            if nxt < 1.0:
                break              # true blank: tail fully captured
            j += step
            walked += 1
        return j

    last = row_ink.shape[0] - 1
    ry0 = grow(cy, -1, last)
    ry1 = grow(cy, +1, last)
    ny0, ny1 = Y0 + ry0, Y0 + ry1 + 1
    if ny1 - ny0 > _V_CAP * max(h, 3):
        # ink run far taller than the detected line: rows are touching
        # (dense screenshot grids) — trust the detector's vertical extent
        ny0, ny1 = y0, y1
    # horizontal: column ink inside the snapped row band
    col_ink = ink[ry0:ry1 + 1].sum(axis=0)
    cols_on = col_ink >= 1
    gap_tol = max(2, int(round(0.3 * max(ny1 - ny0, 1))))
    cx0 = max(x0 - X0, 0)
    cx1 = min(max(x1 - X0, 1), cols_on.shape[0])
    # extend left/right across sub-word-gap breaks (recovers clipped chars)
    gap = 0
    i = cx0 - 1
    while i >= 0 and gap <= gap_tol:
        if cols_on[i]:
            cx0 = i
            gap = 0
        else:
            gap += 1
        i -= 1
    gap = 0
    i = cx1
    while i < cols_on.shape[0] and gap <= gap_tol:
        if cols_on[i]:
            cx1 = i + 1
            gap = 0
        else:
            gap += 1
        i += 1
    on = np.nonzero(cols_on[cx0:cx1])[0]
    if on.size:  # tighten to outermost ink
        cx1 = cx0 + int(on[-1]) + 1
        cx0 = cx0 + int(on[0])
    return [X0 + cx0, ny0, X0 + cx1, ny1]


def refine_line_boxes(
    gray: np.ndarray, rows: List[List[int]], merge_gap_heights: float = 1.2
) -> List[List[int]]:
    """Row-merge + ink-snap post-pass over raw DB boxes for one crop.

    DB fragments a text row wherever the probability map drops below
    threshold mid-line; the standard DB box-forming answer is wider
    closing, but that also bridges adjacent ROWS on dense scans. Host-side
    row logic is exact instead: group boxes sharing >=50% vertical overlap
    into text rows, merge same-row fragments whose horizontal gap is under
    ``merge_gap_heights`` line heights (recognition is merge-tolerant —
    over-long lines re-split at whitespace valleys with space joins,
    processor._split_long_line), then snap every merged box to its ink."""
    if not rows:
        return rows
    # snap FIRST, while each fragment's window is narrow: a fragment's own
    # column span usually has a clean inter-row gap, where a merged
    # multi-column row often doesn't (neighbor-row descenders / ringing)
    if _SNAP_FIRST:
        rows = [_snap_box_to_ink(gray, b) for b in rows]
    ordered = sorted(rows, key=lambda b: ((b[1] + b[3]) / 2.0, b[0]))
    groups: List[List[List[int]]] = []
    for b in ordered:
        placed = False
        for g in groups:
            gy0 = min(x[1] for x in g)
            gy1 = max(x[3] for x in g)
            ov = min(gy1, b[3]) - max(gy0, b[1])
            if ov > 0.5 * min(gy1 - gy0, b[3] - b[1]):
                g.append(b)
                placed = True
                break
        if not placed:
            groups.append([b])
    # gap bridging: when the probability map fades mid-line, whole words
    # between two fragments are never boxed at all (measured: 'The return'
    # dropped from the scanned fixture's first row). The words' INK is
    # still on the page — if the gap band between two same-row fragments
    # carries ink across a meaningful fraction of its columns, merge the
    # fragments so recognition reads the full row (over-long lines re-split
    # at whitespace valleys downstream). A blank gap (true column gutter /
    # table cell boundary) stays split.
    def _gap_has_ink(cur: List[int], b: List[int]) -> bool:
        gx0, gx1 = int(cur[2]), int(b[0])
        if gx1 - gx0 < 2:
            return False
        gy0 = int(min(cur[1], b[1]))
        gy1 = int(max(cur[3], b[3]))
        band = gray[gy0:gy1, gx0:gx1]
        if band.size == 0:
            return False
        # ink threshold from the union of gap band + fragment pixels (the
        # fragments anchor the dark end; the band alone may be all
        # background, the fragments alone may be all ink)
        allpx = np.concatenate([
            band.ravel(),
            gray[gy0:gy1, max(int(cur[0]), 0):int(cur[2])].ravel(),
            gray[gy0:gy1, int(b[0]):int(b[2])].ravel(),
        ])
        lo = float(np.percentile(allpx, 2))
        hi = float(np.percentile(allpx, 98))
        if hi - lo < 30.0:
            return False  # flat window: no text-like contrast anywhere
        cols_on = (band < (lo + 0.45 * (hi - lo))).any(axis=0)
        return float(cols_on.mean()) >= 0.3

    out: List[List[int]] = []
    for g in groups:
        g.sort(key=lambda b: b[0])
        h_med = float(np.median([b[3] - b[1] for b in g]))
        cur = list(g[0])
        for b in g[1:]:
            if (b[0] - cur[2] <= merge_gap_heights * h_med
                    or _gap_has_ink(cur, b)):
                cur[2] = max(cur[2], b[2])
                cur[1] = min(cur[1], b[1])
                cur[3] = max(cur[3], b[3])
            else:
                out.append(cur)
                cur = list(b)
        out.append(cur)
    if not _SNAP_FIRST:
        out = [_snap_box_to_ink(gray, b) for b in out]
    # merging can land two boxes on the same ink: drop exact containments
    keep: List[List[int]] = []
    for b in out:
        contained = any(
            k[0] <= b[0] and k[1] <= b[1] and k[2] >= b[2] and k[3] >= b[3]
            for k in keep
        )
        if not contained and b[2] > b[0] and b[3] > b[1]:
            keep.append(b)
    return keep


_DETECTOR_CACHE: dict = {}


def get_line_detector(weights_path: str = DET_WEIGHTS_PATH,
                      det_size: int = 512,
                      prob_thresh: float = 0.3,
                      refine: bool = True,
                      device="cuda") -> "DBLineDetector":
    """Process-wide DBLineDetector per device (weights load + device
    placement once, shared across pipelines)."""
    dev = resolve_device(device)
    key = (weights_path, det_size, float(prob_thresh), bool(refine), str(dev))
    if key not in _DETECTOR_CACHE:
        _DETECTOR_CACHE[key] = DBLineDetector(weights_path, det_size,
                                              prob_thresh, refine, dev)
    return _DETECTOR_CACHE[key]


class DBLineDetector:
    """Drop-in alternative to ocr/linedet.detect_lines: probability map ->
    device CC -> compact (B, K, 5) boxes -> host unshrink + filtering."""

    def __init__(self, weights_path: str = DET_WEIGHTS_PATH,
                 det_size: int = 512, prob_thresh: float = 0.3,
                 refine: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.model = detector_from_flax(load_det_params(weights_path),
                                        dtype=torch.bfloat16,
                                        device=self.device)
        self.det_size = det_size
        self.prob_thresh = prob_thresh
        self.refine = refine

    CHUNK = 16  # fixed device batch: every chunk has one shape, however
    # many crops a super-batch flags

    MAX_SIDE = 960  # PaddleOCR det_limit_side_len: native-res detection
    # caps the longest side at 960 before tiling

    @staticmethod
    def _luma(rgb: np.ndarray) -> np.ndarray:
        # integer luma (ITU-R 601, 8.8 fixed point) — uint8 end to end
        s16 = rgb.astype(np.uint16)
        return (
            (77 * s16[..., 0] + 150 * s16[..., 1] + 29 * s16[..., 2]) >> 8
        ).astype(np.uint8)

    def _views(self, g: np.ndarray):
        """512² windows covering a det-scale image (stride 448: a line cut
        at a seam reappears whole-ish in the neighbor view and the refine
        row-merge unions the pieces)."""
        s = self.det_size
        stride = s - 64
        ys = list(range(0, max(g.shape[0] - 64, 1), stride))
        xs = list(range(0, max(g.shape[1] - 64, 1), stride))
        views = []
        for oy in ys:
            for ox in xs:
                tile = np.full((s, s), 255, np.uint8)
                sub = g[oy:oy + s, ox:ox + s]
                tile[: sub.shape[0], : sub.shape[1]] = sub
                views.append((ox, oy, tile))
        return views

    def detect_lines(
        self, rgb_batch: np.ndarray, hires=None
    ) -> List[List[List[int]]]:
        """(B, H, W, 3) uint8 -> per-crop reading-ordered [x0,y0,x1,y1]
        in input pixel coordinates (same contract as linedet.detect_lines).

        ``hires``: optional per-crop (image, ratio) pairs — the native-
        resolution source the input crop was box-downscaled from (the
        pipeline's render_ctx). When present, detection runs on 512² tiles
        of the native image (longest side capped at MAX_SIDE, PaddleOCR's
        det_limit_side_len policy) instead of the squeezed analysis
        canvas: a 694px-wide screenshot's 9px rows collapse to ~4.5px of
        half-res probability map on the canvas — physically unresolvable —
        but stay cleanly separated at native scale."""
        b, h, w = rgb_batch.shape[:3]
        s = self.det_size
        from PIL import Image

        # per crop: (gray_ref, [(ox, oy, tile)...], fx, fy, native) —
        # native: boxes/refine live at det scale, then scale to canvas by
        # (fx, fy); legacy: boxes map straight to input coords
        entries = []
        for i in range(b):
            hx = hires[i] if hires is not None else None
            # native-res detection pays off where the downscale is mild —
            # screenshot/figure crops whose absolute text is tiny (the
            # golden-crop domain: rows unresolvable in the canvas's
            # half-res map). Page-scale scans (ratio ~2.7-3.2 at 150 DPI)
            # keep the canvas path: their text survives the box_downscale
            # and measured scanned CER is 3x better there (the canvas's
            # area-exact downscale beats detect-at-960 + coordinate
            # re-rounding for tightly-leaded prose)
            if (hx is not None and hx[0] is not None
                    and 1.05 < hx[1] <= 2.0):
                img, ratio = hx
                g = self._luma(np.ascontiguousarray(img[..., :3]))
                # normalize the longest side TOWARD MAX_SIDE (upscale
                # capped 2x): the DB head emits a HALF-resolution map, so
                # 9px rows at 10px pitch (dense screenshots) need the 2x
                # headroom to stay separable; PaddleOCR's det only caps
                # the max side because its map is full-resolution
                q = min(2.0, self.MAX_SIDE / float(max(g.shape)))
                if abs(q - 1.0) > 1e-3:
                    g = np.asarray(
                        Image.fromarray(g).resize(
                            (max(1, int(g.shape[1] * q)),
                             max(1, int(g.shape[0] * q))),
                            Image.BILINEAR,
                        )
                    )
                f = 1.0 / (q * ratio)
                entries.append((g, self._views(g), f, f, True))
            else:
                g = self._luma(rgb_batch[i])
                if (h, w) != (s, s):
                    g_det = np.asarray(
                        Image.fromarray(g).resize((s, s), Image.BILINEAR))
                else:
                    g_det = g
                # refine reads ink at input resolution (legacy behavior)
                entries.append((g, [(0, 0, g_det)], w / float(s),
                                h / float(s), False))
        # dispatch-all then materialize (overlaps H2D with compute)
        flat = [t for e in entries for t in e[1]]
        pending = []
        for st in range(0, len(flat), self.CHUNK):
            chunk = np.stack([t[2] for t in flat[st:st + self.CHUNK]])
            pad = self.CHUNK - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.full((pad, s, s), 255, np.uint8)])
            pending.append(
                boxes_device(self.model, chunk, self.prob_thresh))
        boxes = np.concatenate(
            [p.cpu().numpy() for p in pending])[: len(flat)]
        out: List[List[List[int]]] = []
        vi = 0
        for i in range(b):
            g_ref, views, fx, fy, native = entries[i]
            rows = []
            for ox, oy, _tile in views:
                valid = boxes[vi][boxes[vi][:, 4] > 4.0]
                vi += 1
                if not len(valid):
                    continue
                un = unshrink_boxes(valid[:, :4])
                for x0, y0, x1, y1 in un:
                    if native:  # half-res map -> det scale (+ tile offset)
                        bx = [
                            int(max(x0 * 2 + ox, 0)),
                            int(max(y0 * 2 + oy, 0)),
                            int(min(x1 * 2 + ox, g_ref.shape[1])),
                            int(min(y1 * 2 + oy, g_ref.shape[0])),
                        ]
                    else:  # half-res map -> input res
                        bx = [
                            int(max(x0 * 2 * fx, 0)),
                            int(max(y0 * 2 * fy, 0)),
                            int(min(x1 * 2 * fx, w)),
                            int(min(y1 * 2 * fy, h)),
                        ]
                    bw, bh = bx[2] - bx[0], bx[3] - bx[1]
                    if self.refine:
                        # fragments survive to the merge pass; only
                        # sub-glyph specks drop here
                        if bw < 2 or bh < 3 or bh > 64:
                            continue
                    elif bw < 6 or bh < 5 or bh > 64 or bw < bh * 0.6:
                        continue
                    rows.append(bx)
            if self.refine and rows:
                rows = refine_line_boxes(g_ref, rows)
            if native:  # det-scale coords -> canvas coords
                rows = [
                    [int(bx[0] * fx), int(bx[1] * fy),
                     int(np.ceil(bx[2] * fx)), int(np.ceil(bx[3] * fy))]
                    for bx in rows
                ]
            if self.refine:
                rows = [
                    bx for bx in rows
                    if not (bx[2] - bx[0] < 6 or bx[3] - bx[1] < 5
                            or bx[3] - bx[1] > 64
                            or bx[2] - bx[0] < (bx[3] - bx[1]) * 0.6)
                ]
            rows.sort(key=lambda bb: (bb[1], bb[0]))
            out.append(rows)
        return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=DET_OUT_PATH)
    ap.add_argument("--init-from", default=None)
    ap.add_argument("--sheet-frac", type=float, default=0.25)
    ap.add_argument("--dense-frac", type=float, default=0.4)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args()
    # the synthetic pages are drawn by the native PDF engine, which needs
    # libjpeg.so.62; re-exec with Pillow's copy where the system has none
    from synapta_tpu_torch.hostlibs import ensure_native_engine

    ensure_native_engine(["-m", "synapta_tpu_torch.models.detector", *sys.argv[1:]])
    train_detector(args.steps, args.batch, args.lr, args.seed, args.size,
                   args.out, args.init_from,
                   sheet_frac=args.sheet_frac, dense_frac=args.dense_frac,
                   device=args.device)
