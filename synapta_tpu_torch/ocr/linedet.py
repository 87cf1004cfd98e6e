"""Text-line detection over crop batches — counterpart of
synapta_tpu/ocr/linedet.py.

Binarized ink -> fused text-line mask (strokes, rules and solids erased,
glyphs closed into line blobs) -> connected components at half resolution
-> per-line boxes, all on the crop batch's device. Only a compact (B, K, 5)
box tensor goes to the host.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from synapta_tpu_torch.ops.cc import component_stats_device, connected_components
from synapta_tpu_torch.ops.color import rgb_to_gray
from synapta_tpu_torch.ops.filters import (
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


@torch.inference_mode()
def line_boxes_device(rgb: torch.Tensor, merge_x: int = 7,
                      ink_thresh: float = 200.0,
                      k: int = MAX_LINES) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, k, 5) line boxes (standalone path)."""
    ink = binarize_ink(rgb_to_gray(rgb), ink_thresh)
    return line_boxes_from_ink(ink, merge_x, k)


def extract_line_boxes(
    boxes: np.ndarray,
    min_w: int = 6,
    min_h: int = 5,
    max_h: int = 64,
    min_area: int = 24,
) -> List[List[int]]:
    """One crop's (K, 5) device boxes -> reading-ordered [x0, y0, x1, y1]
    line boxes. Components taller than max_h (drawings, bars) and smaller
    than the minima (specks) are rejected; same-row fragments merge."""
    out = []
    for x0, y0, x1, y1, area in np.asarray(boxes):
        if area < min_area:
            continue
        w, h = x1 - x0, y1 - y0
        if w < min_w or h < min_h or h > max_h:
            continue
        if w < h * 0.6:  # text lines are wider than tall
            continue
        if area < 0.25 * w * h:  # reject sparse frames (outline boxes)
            continue
        out.append([int(x0), int(y0), int(x1), int(y1)])
    out.sort(key=lambda b: (b[1], b[0]))
    merged: List[List[int]] = []
    for b in out:
        if merged:
            m = merged[-1]
            same_row = abs(b[1] - m[1]) < 0.6 * (m[3] - m[1])
            close = b[0] - m[2] < 1.2 * (m[3] - m[1])
            if same_row and close and b[0] >= m[0]:
                m[2] = max(m[2], b[2])
                m[1] = min(m[1], b[1])
                m[3] = max(m[3], b[3])
                continue
        merged.append(list(b))
    merged.sort(key=lambda b: (b[1], b[0]))
    return merged


def detect_lines(rgb_batch: np.ndarray, device) -> List[List[List[int]]]:
    """HOST crop batch -> per-crop reading-ordered line boxes, computed on
    ``device`` (one compact device-to-host copy for the whole batch)."""
    x = torch.from_numpy(np.ascontiguousarray(rgb_batch)).to(device)
    boxes = line_boxes_device(x).cpu().numpy()
    return [extract_line_boxes(boxes[i]) for i in range(boxes.shape[0])]
