"""Text-line detection over crop batches — counterpart of
synapta_tpu/ocr/linedet.py.

Binarized ink -> fused text-line mask (strokes, rules and solids erased,
glyphs closed into line blobs) -> connected components at half resolution
-> per-line boxes, all on the crop batch's device. Only a compact (B, K, 5)
box tensor goes to the host.
"""
from __future__ import annotations

import torch

from portbench.reference.cc import component_stats_device, connected_components
from portbench.reference.filters import (
    binarize_ink,
    diagonal_run_mask,
    dilate,
    downsample2,
    erode,
)

MAX_LINES = 128


def fuse_text_mask(ink: torch.Tensor, merge_x: int = 7) -> torch.Tensor:
    """Ink -> fused text-line mask. Long diagonal runs, 40px+ horizontal /
    vertical rules and solid regions are erased first (glyph strokes never
    form them), then glyphs close horizontally into line blobs."""
    diag = diagonal_run_mask(ink > 0, 12) | diagonal_run_mask(ink > 0, 12, anti=True)
    h_rule = dilate(erode(ink, 1, 41), 1, 45)
    v_rule = dilate(erode(ink, 41, 1), 45, 1)
    solid = dilate(erode(ink, 5, 5), 9, 9)
    strokes = dilate(diag.to(torch.float32), 3, 3)
    kill = torch.maximum(torch.maximum(strokes, solid), torch.maximum(h_rule, v_rule))
    ink = ink * (1.0 - kill)
    fused = erode(dilate(ink, 1, merge_x), 1, max(merge_x - 2, 1))
    fused = erode(dilate(fused, 2, 1), 1, 1)
    return fused


def line_boxes_from_ink(ink: torch.Tensor, merge_x: int = 7,
                        k: int = MAX_LINES) -> torch.Tensor:
    """Ink (B, H, W) -> (B, k, 5) [x0, y0, x1, y1, area] float32,
    largest-first. Labels at half resolution with a 10-round CC budget."""
    half = downsample2(fuse_text_mask(ink, merge_x))
    stats = component_stats_device(connected_components(half, max_iters=10), k=k)
    # stats are in half-res pixels: scale boxes x2, areas x4
    return torch.stack(
        [
            stats["x0"] * 2.0,
            stats["y0"] * 2.0,
            (stats["x1"] + 1.0) * 2.0,
            (stats["y1"] + 1.0) * 2.0,
            stats["area"] * 4.0,
        ],
        dim=-1,
    )
