"""Fused edge statistics: the CUDA kernel's wrapper (csrc/edge_stats.cu) and
its plain PyTorch twins.

Replaces synapta_tpu/ops/pallas_kernels.py::fused_edge_stats, and carries
both routes of the JAX package's ``_core_features`` under its own switch,
``use_pallas``. Per crop, on both routes: Sobel with replicated borders,
4-sector NMS, a (high, high/3) double threshold with one in-bounds 3x3 grow,
then 1-D opens with windows 2*line_k-1 (vertical, horizontal) and 2*grid_k-1
(grid horizontal, vertical).

- ``use_pallas=False``, the default, is the JAX default route (XLA ops:
  ``sobel_edges`` -> ``_open_iter2`` -> ``box_count``): the NMS neighbours wrap
  around the image (``jnp.roll``), the opens are centred and ignore lanes
  outside the image (``reduce_window`` with SAME padding). Output: (B, 6)
  float32 counts [edges, v_open, h_open, grid_h, grid_v, |v_open U h_open|].
  The twin takes its NMS sectors from ``atan2`` in degrees, the kernel from
  two ratio tests: the two agree on every integer gradient but (0, 0), whose
  magnitude is 0, so the kernel is exact for integer-valued gray (uint8 luma,
  what the analyze pass feeds it) and only for that.
- ``use_pallas=True`` is the Pallas kernel: the NMS neighbours clamp, the opens
  lose the first k//2 lanes of their axis in the erosion and again in the
  dilation. Output: (B, 5), the first five counts.

A CUDA tensor launches the kernel on either route, a CPU tensor runs the
route's twin.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from synapta_tpu_torch.ops import _build
from synapta_tpu_torch.ops.filters import (
    _shift,
    box_count,
    dilate,
    sobel_edges,
    sobel_gradients,
)


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


def _ratio_sectors(gx: torch.Tensor, gy: torch.Tensor):
    """The kernels' NMS sectors without atan2 -> (is_h, is_d1, is_v); what is
    left is the other diagonal."""
    ax, ay = gx.abs(), gy.abs()
    is_h = ay < 0.41421356 * ax
    is_v = ay > 2.41421356 * ax
    is_d1 = ~is_h & ~is_v & (gx * gy >= 0.0)
    return is_h, is_d1, is_v


def _pallas_reference(gray: torch.Tensor, line_k: int, grid_k: int,
                      high: float) -> torch.Tensor:
    """Plain twin of the Pallas route: (B, H, W) float32 gray -> (B, 5)."""
    gx, gy = sobel_gradients(gray)  # same edge-replicated taps as _shift2
    mag = torch.sqrt(gx * gx + gy * gy)
    is_h, is_d1, is_v = _ratio_sectors(gx, gy)
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
    return torch.stack([box_count(edges)] + [box_count(o > 0) for o in opens],
                       dim=1)


def _xla_reference(gray: torch.Tensor, line_k: int, grid_k: int,
                   high: float) -> torch.Tensor:
    """Plain twin of the default route, the JAX package's XLA ops one for
    one: (B, H, W) float32 gray -> (B, 6)."""
    from synapta_tpu_torch.ops.features import _open_iter2

    edges, _, _ = sobel_edges(gray, low=high / 3.0, high=high)
    e = edges.to(torch.float32)
    v_open = _open_iter2(e, line_k, 1) > 0
    h_open = _open_iter2(e, 1, line_k) > 0
    masks = [edges, v_open, h_open, _open_iter2(e, 1, grid_k) > 0,
             _open_iter2(e, grid_k, 1) > 0, v_open | h_open]
    return torch.stack([box_count(m) for m in masks], dim=1)


def fused_edge_stats_reference(gray: torch.Tensor, line_k: int = 20,
                               grid_k: int = 25, high: float = 150.0,
                               use_pallas: bool = False) -> torch.Tensor:
    """Plain twin of the kernel on either route: (B, H, W) float32 gray ->
    (B, 6) float32 counts, or (B, 5) with ``use_pallas``."""
    twin = _pallas_reference if use_pallas else _xla_reference
    return twin(gray, line_k, grid_k, high)


def fused_edge_stats_cuda(gray: torch.Tensor, line_k: int = 20,
                          grid_k: int = 25, high: float = 150.0,
                          use_pallas: bool = False) -> torch.Tensor:
    """Launch the kernel on the current stream: (B, H, W) float32 contiguous
    CUDA gray -> (B, 6) float32, or (B, 5) with ``use_pallas``. The default
    route is exact against its twin for integer-valued gray only (see the
    module's note on the NMS sectors). Raises on any launch error."""
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
    out = torch.empty((B, 6), dtype=torch.float32, device=dev)
    # the edge map, bit-packed: bit x % 32 of word x // 32 of each row
    edge_bits = torch.empty((B, H, (W + 31) // 32), dtype=torch.int32,
                            device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.synapta_edge_stats(
            gray.data_ptr(), out.data_ptr(), edge_bits.data_ptr(),
            B, H, W, line_k, grid_k, float(high), float(high / 3.0),
            0 if use_pallas else 1, stream,
        )
    _build.check(err, "synapta_edge_stats")
    fused_edge_stats_cuda.launches += 1
    return out[:, :5] if use_pallas else out


fused_edge_stats_cuda.launches = 0


def fused_edge_stats(gray: torch.Tensor, line_k: int = 20, grid_k: int = 25,
                     high: float = 150.0,
                     use_pallas: bool = False) -> torch.Tensor:
    """(B, H, W) gray -> (B, 6) counts, or (B, 5) with ``use_pallas``. A CUDA
    tensor runs the kernel, a CPU tensor the route's plain twin; any other
    device raises."""
    if gray.is_cuda:
        return fused_edge_stats_cuda(gray, line_k, grid_k, high, use_pallas)
    if gray.device.type != "cpu":
        raise ValueError(f"fused_edge_stats: unsupported device {gray.device}")
    return fused_edge_stats_reference(gray, line_k, grid_k, high, use_pallas)
