"""Sobel edges and separable morphology — counterpart of
synapta_tpu/ops/filters.py.

All functions take (B, H, W) tensors and return results on the same device.
Parity notes where the JAX semantics bite:
  - ``_shift`` replicates edges (Sobel taps), but the NMS neighbours in
    ``sobel_edges`` and the runs in ``diagonal_run_mask`` use ``jnp.roll``,
    which wraps around; ``torch.roll`` is the same;
  - ``reduce_window(..., "SAME")`` pads (k-1)//2 low and the rest high, so
    ``dilate(e, 2, 2)`` pads (0, 1); the windows pad with -inf (+inf for
    erode) and max-pool at stride 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicating shift: out[:, y, x] = a[:, clamp(y-dy), clamp(x-dx)]."""
    B, H, W = a.shape
    p = F.pad(a[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return p[:, 1 - dy : 1 - dy + H, 1 - dx : 1 - dx + W]


def sobel_gradients(gray: torch.Tensor):
    """-> (gx, gy) float32, same shape as input (8 shifted adds)."""
    tl = _shift(gray, -1, -1)
    t = _shift(gray, -1, 0)
    tr = _shift(gray, -1, 1)
    l = _shift(gray, 0, -1)
    r = _shift(gray, 0, 1)
    bl = _shift(gray, 1, -1)
    b = _shift(gray, 1, 0)
    br = _shift(gray, 1, 1)
    gx = (tr + 2 * r + br) - (tl + 2 * l + bl)
    gy = (bl + 2 * b + br) - (tl + 2 * t + tr)
    return gx, gy


def _degree_sectors(theta: torch.Tensor):
    """NMS sectors of a gradient direction in radians, quantized in degrees as
    the JAX package does -> (is_h, is_d1, is_v); what is left is the other
    diagonal. The JAX source writes (deg + 180) % 180; the sum is left out
    here (the remainder is the same number) because it costs the bits that
    decide a boundary: the integer gradient (-408, 985) lies 1.8e-5 degrees
    under 112.5, and 292.49998 rounds to 292.5 in float32. Without it every
    integer gradient uint8 luma can give lands in the JAX package's sector
    (tests/test_torch_edge_stats.py enumerates them)."""
    adeg = torch.remainder(theta * (180.0 / math.pi), 180.0)
    is_h = (adeg < 22.5) | (adeg >= 157.5)
    is_d1 = (adeg >= 22.5) & (adeg < 67.5)
    is_v = (adeg >= 67.5) & (adeg < 112.5)
    return is_h, is_d1, is_v


def sobel_edges(gray: torch.Tensor, low: float = 50.0, high: float = 150.0):
    """Canny-equivalent edge map: gradient magnitude, NMS along the
    quantized gradient direction, double threshold with one grow round.
    Returns (edges bool, magnitude, orientation_radians)."""
    gx, gy = sobel_gradients(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)

    def shift(a, dy, dx):  # jnp.roll: wraps around
        return torch.roll(a, shifts=(dy, dx), dims=(1, 2))

    is_h, is_d1, is_v = _degree_sectors(theta)
    n1 = torch.where(
        is_h, shift(mag, 0, 1),
        torch.where(is_d1, shift(mag, 1, 1),
                    torch.where(is_v, shift(mag, 1, 0), shift(mag, 1, -1))),
    )
    n2 = torch.where(
        is_h, shift(mag, 0, -1),
        torch.where(is_d1, shift(mag, -1, -1),
                    torch.where(is_v, shift(mag, -1, 0), shift(mag, -1, 1))),
    )
    local_max = (mag >= n1) & (mag >= n2)
    strong = local_max & (mag >= high)
    weak = local_max & (mag >= low)
    grown = dilate(strong.to(torch.float32), 3, 3) > 0
    edges = strong | (weak & grown)
    return edges, mag, theta


def _window_max(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """SAME-padded (-inf) stride-1 max over a kh x kw window."""
    ph, pw = kh - 1, kw - 1
    p = F.pad(img[:, None], (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
              value=-math.inf)
    return F.max_pool2d(p, (kh, kw), stride=1)[:, 0]


def erode(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W) min-filter with a kh x kw window (SAME padding)."""
    return -_window_max(-img, kh, kw)


def dilate(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    return _window_max(img, kh, kw)


def morph_open(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    return dilate(erode(img, kh, kw), kh, kw)


def binarize_ink(gray: torch.Tensor, thresh: float = 200.0) -> torch.Tensor:
    """Dark-ink mask for documents rendered on white (1.0 = ink)."""
    return (gray < thresh).to(torch.float32)


def diagonal_run_mask(edges: torch.Tensor, length: int, anti: bool = False):
    """Pixels on a diagonal run of at least ``length`` edge pixels
    (log-doubling run-length erosion along the diagonal, wrapping shifts)."""
    e = dilate(edges.to(torch.float32), 2, 2)
    sign = -1 if anti else 1

    def shift(a, d):  # jnp.roll: wraps around
        return torch.roll(a, shifts=(d, sign * d), dims=(1, 2))

    acc = e
    run = 1
    target = max(int(length), 1)
    while run * 2 <= target:
        acc = acc * shift(acc, run)
        run *= 2
    if run < target:
        acc = acc * shift(acc, target - run)
    return acc > 0


def box_count(mask: torch.Tensor) -> torch.Tensor:
    """Per-image pixel count of a (B, H, W) mask."""
    return mask.to(torch.float32).sum(dim=(1, 2))


def downsample2(mask: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool downsample (VALID)."""
    return F.max_pool2d(mask[:, None], 2, stride=2)[:, 0]


def downsample2_min(mask: torch.Tensor) -> torch.Tensor:
    """2x2 MIN-pool downsample — keeps 1px gaps between components."""
    return -F.max_pool2d(-mask[:, None], 2, stride=2)[:, 0]
