"""The yardstick's arithmetic: the card's peaks, and the bytes, operations
and FLOPs of a call computed from its shapes.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its 700 W limit
(dense): 3.35 TB/s of HBM, 989 TFLOP/s in bfloat16, 67 TFLOP/s in float32
outside the tensor cores (the port keeps TF32 off). A kernel's least time is
the larger of its bytes over the memory rate (each input byte read once,
each output byte written once) and its operations over the float32 rate,
the arithmetic of ``chip_smoke.py::bound`` and of PERF.md's kernel table.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def least_s(nbytes: float, ops: float = 0.0) -> float:
    """Seconds the card needs at least: bytes at the memory rate against
    operations at the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def cc_least_s(B: int, H: int, W: int, connectivity: int = 8) -> float:
    """Connected components of a (B, H, W) float32 mask: the mask in, int32
    labels and the (B,) rounds out; one propagation round of 32-bit compares
    and maxes a pixel (8 for the 3x3 max, 2 for each of four scans), the
    least any input needs."""
    nbytes = B * H * W * 8 + B * 4
    ops = B * H * W * ((8 if connectivity == 8 else 0) + 8)
    return least_s(nbytes, ops)


def edge_stats_least_s(B: int, H: int, W: int, counts: int = 6) -> float:
    """Fused edge statistics of (B, H, W) float32 gray: the gray in, the
    (B, counts) float32 counts out; 60 float32 operations a pixel (the
    Pallas kernel's CostEstimate)."""
    return least_s(B * H * W * 4 + B * counts * 4, 60.0 * B * H * W)


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def recognizer_flops(rec: dict) -> float:
    """Multiply-add FLOPs (2 a MAC) of the recognizer on one (32, W) tile:
    the conv stack ('SAME', strides from ``convs``: [cin, cout, sh, sw]),
    then ``blocks`` encoder blocks over T = W / 4 frames (q, k, v and out
    projections, scores and weighted values, the MLP) and the CTC head."""
    h, w = rec["tile"]
    f = 0.0
    for cin, cout, sh, sw in rec["convs"]:
        h, w = math.ceil(h / sh), math.ceil(w / sw)
        f += conv_flops(cin, cout, 3, h, w)
    T, D = w, rec["dim"]
    block = (4 * 2 * T * D * D + 2 * 2 * T * T * D
             + 2 * 2 * T * D * D * rec["mlp_ratio"])
    return f + rec["blocks"] * block + 2 * T * D * rec["classes"]


# the DB detector: (cin, cout, stride) of ConvBlock_0..10 (3x3, the
# block convs run in float32), the 1x1 laterals (bfloat16) at the scale
# they read, and the float32 3x3 head
DET_BLOCKS = ((1, 16, 2), (16, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2),
              (64, 64, 1), (64, 96, 2), (96, 96, 1), (64, 32, 1), (32, 16, 1),
              (16, 16, 1))
# block i reads the output of scale DET_SCALE[i] (as a divisor of the view)
DET_SCALE = (2, 2, 4, 4, 8, 8, 16, 16, 8, 4, 2)
DET_LATERALS = ((64, 64, 8), (96, 64, 16), (32, 32, 4), (16, 16, 2))


def detector_flops(size: int) -> tuple:
    """(float32 FLOPs, bfloat16 FLOPs) of the DB detector on one
    (size, size) view."""
    f32 = 0.0
    for (cin, cout, _), d in zip(DET_BLOCKS, DET_SCALE):
        f32 += conv_flops(cin, cout, 3, size // d, size // d)
    f32 += conv_flops(16, 2, 3, size // 2, size // 2)  # head
    bf16 = sum(conv_flops(cin, cout, 1, size // d, size // d)
               for cin, cout, d in DET_LATERALS)
    return f32, bf16


def page_step_s(rec: dict, det_size: int, tiles: int, views: int) -> float:
    """Seconds the two models' FLOPs on ``tiles`` real tiles and ``views``
    real DB views take at the peak of the precision each runs in."""
    f32, bf16 = detector_flops(det_size)
    return (tiles * recognizer_flops(rec) / BF16_FLOPS
            + views * (f32 / F32_FLOPS + bf16 / BF16_FLOPS))
