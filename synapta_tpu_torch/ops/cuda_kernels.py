"""Fused edge statistics: the CUDA kernel's wrapper (csrc/edge_stats.cu) and
its plain PyTorch twin.

Replaces synapta_tpu/ops/pallas_kernels.py::fused_edge_stats. Per crop:
Sobel with replicated borders, 4-sector NMS without atan2, a (high, high/3)
double threshold with one clamped 3x3 grow, then one-sided 1-D opens with
windows 2*line_k-1 (vertical, horizontal) and 2*grid_k-1 (grid horizontal,
vertical). Output: (B, 5) float32 counts [edges, v_open, h_open, grid_h,
grid_v]. These are the Pallas kernel's semantics, not ops/filters.py's (the
opens here are one-sided, and the NMS neighbours clamp instead of wrapping).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from synapta_tpu_torch.ops import _build
from synapta_tpu_torch.ops.filters import _shift, dilate, sobel_gradients


def _window1d(a: torch.Tensor, k: int, dim: int, erode: bool) -> torch.Tensor:
    """Pallas ``_erode1d``/``_dilate1d`` along ``dim`` (1 = rows of a
    column, 2 = along a row): out[i] = min/max of a over
    [i - k//2, i - k//2 + k) within [0, n) for i >= k//2, and 0 below.
    Out-of-range lanes are neutral: +inf for min, 0 for max (a >= 0)."""
    n = a.shape[dim]
    h = k // 2
    if h >= n:
        return torch.zeros_like(a)
    window = (1, k) if dim == 2 else (k, 1)
    tail = (0, k - 1) if dim == 2 else (0, 0, 0, k - 1)
    if erode:
        p = -F.pad(a, tail, value=math.inf)
        win = -F.max_pool2d(p[:, None], window, stride=1)[:, 0]
    else:
        p = F.pad(a, tail, value=0.0)
        win = F.max_pool2d(p[:, None], window, stride=1)[:, 0]
    win = win.narrow(dim, 0, n - h)
    pad = (h, 0) if dim == 2 else (0, 0, h, 0)
    return F.pad(win, pad, value=0.0)


def _open1d(a: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    return _window1d(_window1d(a, k, dim, True), k, dim, False)


def fused_edge_stats_reference(gray: torch.Tensor, line_k: int = 20,
                               grid_k: int = 25,
                               high: float = 150.0) -> torch.Tensor:
    """Plain twin of the kernel: (B, H, W) float32 gray -> (B, 5) float32."""
    gx, gy = sobel_gradients(gray)  # same edge-replicated taps as _shift2
    mag = torch.sqrt(gx * gx + gy * gy)
    ax, ay = gx.abs(), gy.abs()
    is_h = ay < 0.41421356 * ax
    is_v = ay > 2.41421356 * ax
    is_d1 = ~is_h & ~is_v & (gx * gy >= 0.0)
    n1 = torch.where(
        is_h, _shift(mag, 0, 1),
        torch.where(is_d1, _shift(mag, 1, 1),
                    torch.where(is_v, _shift(mag, 1, 0), _shift(mag, 1, -1))),
    )
    n2 = torch.where(
        is_h, _shift(mag, 0, -1),
        torch.where(is_d1, _shift(mag, -1, -1),
                    torch.where(is_v, _shift(mag, -1, 0), _shift(mag, -1, 1))),
    )
    local_max = (mag >= n1) & (mag >= n2)
    strong = local_max & (mag >= high)
    weak = local_max & (mag >= high / 3.0)
    # the clamped 3x3 grow == the in-bounds 3x3 max
    grown = dilate(strong.to(torch.float32), 3, 3) > 0
    edges = (strong | (weak & grown)).to(torch.float32)

    ekl, ekg = 2 * line_k - 1, 2 * grid_k - 1  # iterations=2 equivalence
    opens = [
        _open1d(edges, ekl, 1),  # v_open
        _open1d(edges, ekl, 2),  # h_open
        _open1d(edges, ekg, 2),  # grid_h
        _open1d(edges, ekg, 1),  # grid_v
    ]
    counts = [edges.sum(dim=(1, 2))]
    counts += [(o > 0).to(torch.float32).sum(dim=(1, 2)) for o in opens]
    return torch.stack(counts, dim=1)


def fused_edge_stats_cuda(gray: torch.Tensor, line_k: int = 20,
                          grid_k: int = 25, high: float = 150.0) -> torch.Tensor:
    """Launch the kernel on the current stream: (B, H, W) float32 contiguous
    CUDA gray -> (B, 5) float32. Raises on any launch error."""
    if not gray.is_cuda:
        raise ValueError("fused_edge_stats_cuda needs a CUDA tensor")
    if gray.dtype != torch.float32 or gray.dim() != 3:
        raise ValueError(
            f"expected (B, H, W) float32 gray, got {tuple(gray.shape)} "
            f"{gray.dtype}"
        )
    if not gray.is_contiguous():
        raise ValueError("gray must be contiguous")
    if line_k < 1 or grid_k < 1:
        raise ValueError("window sizes must be >= 1")
    B, H, W = gray.shape
    dev = gray.device
    out = torch.empty((B, 5), dtype=torch.float32, device=dev)
    # the edge map, bit-packed: bit x % 32 of word x // 32 of each row
    edge_bits = torch.empty((B, H, (W + 31) // 32), dtype=torch.int32,
                            device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.synapta_edge_stats(
            gray.data_ptr(), out.data_ptr(), edge_bits.data_ptr(),
            B, H, W, line_k, grid_k, float(high), float(high / 3.0), stream,
        )
    _build.check(err, "synapta_edge_stats")
    fused_edge_stats_cuda.launches += 1
    return out


fused_edge_stats_cuda.launches = 0


def fused_edge_stats(gray: torch.Tensor, line_k: int = 20, grid_k: int = 25,
                     high: float = 150.0) -> torch.Tensor:
    """(B, H, W) gray -> (B, 5) counts. A CUDA tensor runs the kernel, a CPU
    tensor the plain twin; any other device raises."""
    if gray.is_cuda:
        return fused_edge_stats_cuda(gray, line_k, grid_k, high)
    if gray.device.type != "cpu":
        raise ValueError(f"fused_edge_stats: unsupported device {gray.device}")
    return fused_edge_stats_reference(gray, line_k, grid_k, high)
