"""Fused edge statistics: a frozen copy of the plain twins in
``synapta_tpu_torch/ops/cuda_kernels.py``, the reference of the benchmark's
comparison for the CUDA kernel ``csrc/edge_stats.cu``.

Per crop, on both routes of the JAX package's ``_core_features``: Sobel with
replicated borders, 4-sector NMS, a (high, high/3) double threshold with one
in-bounds 3x3 grow, then 1-D opens with windows 2*line_k-1 (vertical,
horizontal) and 2*grid_k-1 (grid horizontal, vertical). The default route
(the one the pipeline runs: centred opens, wrapped NMS neighbours) only:
(B, 6) float32 counts [edges, v_open, h_open, grid_h, grid_v,
|v_open U h_open|].
"""
from __future__ import annotations

import torch

from portbench.reference.filters import box_count, sobel_edges


def _xla_reference(gray: torch.Tensor, line_k: int, grid_k: int,
                   high: float) -> torch.Tensor:
    """Plain twin of the default route, the JAX package's XLA ops one for
    one: (B, H, W) float32 gray -> (B, 6)."""
    from portbench.reference.features import _open_iter2

    edges, _, _ = sobel_edges(gray, low=high / 3.0, high=high)
    e = edges.to(torch.float32)
    v_open = _open_iter2(e, line_k, 1) > 0
    h_open = _open_iter2(e, 1, line_k) > 0
    masks = [edges, v_open, h_open, _open_iter2(e, 1, grid_k) > 0,
             _open_iter2(e, grid_k, 1) > 0, v_open | h_open]
    return torch.stack([box_count(m) for m in masks], dim=1)


def fused_edge_stats(gray: torch.Tensor, line_k: int = 20, grid_k: int = 25,
                     high: float = 150.0) -> torch.Tensor:
    """(B, H, W) float32 gray -> (B, 6) float32 counts, the default route's
    plain twin on the tensor's device."""
    return _xla_reference(gray, line_k, grid_k, high)
