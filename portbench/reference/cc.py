"""Connected components and per-component statistics: a frozen copy of the
port's plain twin (``synapta_tpu_torch/ops/cc.py``), the reference of the
benchmark's comparison. ``connected_components`` runs the plain propagation
on any device. Labels: each ink pixel gets its component's max initial id
(y*W + x + 1); background is 0.
"""
from __future__ import annotations

from typing import Dict

import torch

_BIG = 1 << 32  # segment offset for the int64 segmented scans (> any value)


def _seg_cummax(values: torch.Tensor, seg: torch.Tensor, dim: int):
    """Running max of ``values`` (int64, 0 <= v < _BIG) along ``dim`` that
    restarts wherever ``seg`` (non-decreasing along dim) steps up."""
    key = seg * _BIG + values
    return torch.cummax(key, dim=dim).values - seg * _BIG


def _seg_max_scan(values: torch.Tensor, m: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Segmented running max along ``dim``: resets wherever m == 0."""
    if reverse:
        values, m = values.flip(dim), m.flip(dim)
    out = _seg_cummax(values, torch.cumsum(1 - m, dim=dim), dim) * m
    return out.flip(dim) if reverse else out


def _neighbor_max(lbl: torch.Tensor) -> torch.Tensor:
    """In-bounds 3x3 max (labels are >= 0, so a zero border is neutral)."""
    B, H, W = lbl.shape
    p = torch.nn.functional.pad(lbl, (1, 1, 1, 1))
    out = lbl
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, p[:, dy : dy + H, dx : dx + W])
    return out


def connected_components_reference(mask: torch.Tensor, max_iters: int = 64,
                                   connectivity: int = 8,
                                   return_rounds: bool = False):
    """Plain twin of the CC kernel. (B, H, W) {0,1} mask -> int32 labels.

    Runs step(init) and then at most ``max_iters`` more rounds, stopping at
    a fixed point like the JAX while_loop (and like the kernel, which stops
    each map at its own). With ``return_rounds`` also the (B,) int32 rounds
    each map took: 1 + the rounds up to and including the first that left
    it unchanged, or max_iters + 1."""
    B, H, W = mask.shape
    m = (mask != 0).to(torch.int64)
    ids = torch.arange(1, H * W + 1, dtype=torch.int64,
                       device=mask.device).view(1, H, W)

    def step(lbl):
        if connectivity == 8:
            lbl = _neighbor_max(lbl) * m
        lbl = _seg_max_scan(lbl, m, 2, False)
        lbl = _seg_max_scan(lbl, m, 2, True)
        lbl = _seg_max_scan(lbl, m, 1, False)
        lbl = _seg_max_scan(lbl, m, 1, True)
        return lbl

    lbl = step(ids * m)
    rounds = torch.full((B,), max_iters + 1, dtype=torch.int32)
    for i in range(max_iters):
        new = step(lbl)
        same = (new == lbl).flatten(1).all(1).cpu()
        rounds = torch.where(same & (rounds > i + 2), i + 2, rounds)
        if bool(same.all()):
            break
        lbl = new
    lbl = lbl.to(torch.int32)
    return (lbl, rounds) if return_rounds else lbl


def connected_components(mask: torch.Tensor, max_iters: int = 64,
                         connectivity: int = 8) -> torch.Tensor:
    """8- (or 4-) connected labeling of a (B, H, W) {0,1} float mask.

    The plain propagation (max_iters + 1 rounds at most) on the mask's
    device."""
    return connected_components_reference(mask, max_iters, connectivity)


def component_stats_device(labels: torch.Tensor, k: int = 128):
    """Per-component stats from a (B, H, W) label map, on its device.

    Returns (B, k) float32 arrays — x0, y0, x1, y1 (inclusive), area — for
    the k largest components, plus the full (B, H*W) per-position arrays
    the censuses reduce over. As in the JAX version the labels are sorted
    (stably) and the stats are RUNNING values within each run of equal
    labels, so a run's last position holds its complete stats; area is 0
    everywhere else. Ties in area keep the lower position first, as
    ``lax.top_k`` does (a stable descending sort, not ``torch.topk``)."""
    B, H, W = labels.shape
    N = H * W
    flat = labels.reshape(B, N).to(torch.int64)
    ids_s, perm = torch.sort(flat, dim=1, stable=True)
    xs = perm % W
    ys = perm // W
    start = torch.ones_like(ids_s, dtype=torch.bool)
    start[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    run = torch.cumsum(start.to(torch.int64), dim=1)
    pos = torch.arange(N, device=labels.device).expand(B, N)
    run_start = torch.cummax(torch.where(start, pos, 0), dim=1).values
    cnt = (pos - run_start + 1).to(torch.float32)
    x1 = _seg_cummax(xs, run, 1).to(torch.float32)
    y1 = _seg_cummax(ys, run, 1).to(torch.float32)
    x0 = (W - _seg_cummax(W - xs, run, 1)).to(torch.float32)
    y0 = (H - _seg_cummax(H - ys, run, 1)).to(torch.float32)
    end = torch.ones_like(start)
    end[:, :-1] = start[:, 1:]
    area = torch.where(end & (ids_s > 0), cnt, 0.0)
    top_idx = torch.sort(area, dim=1, descending=True, stable=True).indices[:, :k]
    return {
        "area": torch.gather(area, 1, top_idx),
        "x0": torch.gather(x0, 1, top_idx),
        "y0": torch.gather(y0, 1, top_idx),
        "x1": torch.gather(x1, 1, top_idx),
        "y1": torch.gather(y1, 1, top_idx),
        "_full_area": area,
        "_full_x0": x0,
        "_full_x1": x1,
        "_full_y0": y0,
        "_full_y1": y1,
    }


def census_counts(stats, pred):
    """Count components (per image) satisfying ``pred(area, w, h, x0, y0,
    x1, y1)`` over the FULL per-position stats."""
    area = stats["_full_area"]
    w = stats["_full_x1"] - stats["_full_x0"] + 1
    h = stats["_full_y1"] - stats["_full_y0"] + 1
    mask = (area > 0) & pred(
        area, w, h,
        stats["_full_x0"], stats["_full_y0"],
        stats["_full_x1"], stats["_full_y1"],
    )
    return mask.to(torch.float32).sum(dim=1)
