"""Wrapper of the CUDA connected-components kernel (csrc/cc.cu).

Replaces synapta_tpu/ops/pallas_cc.py::connected_components_pallas; the
plain twin is ops/cc.py::connected_components_reference. The source's
header comment says what bounds the kernel on Hopper and how the design
answers it.
"""
from __future__ import annotations

import torch

from synapta_tpu_torch.ops import _build


def connected_components_cuda(mask: torch.Tensor, max_iters: int = 10,
                              connectivity: int = 8) -> torch.Tensor:
    """(B, H, W) float32 {0,1} CUDA mask -> int32 labels, exactly
    ``max_iters + 1`` propagation rounds. Launches on the current stream
    and does not synchronise; raises on any launch error."""
    if not mask.is_cuda:
        raise ValueError("connected_components_cuda needs a CUDA tensor")
    if mask.dtype != torch.float32 or mask.dim() != 3:
        raise ValueError(
            f"expected a (B, H, W) float32 mask, got {tuple(mask.shape)} "
            f"{mask.dtype}"
        )
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if max_iters < 0:
        raise ValueError("max_iters must be >= 0")
    B, H, W = mask.shape
    labels = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    scratch = (torch.empty_like(labels) if connectivity == 8 else labels)
    lib = _build.library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.synapta_cc(
            mask.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
            B, H, W, max_iters + 1, connectivity, stream,
        )
    _build.check(err, "synapta_cc")
    connected_components_cuda.launches += 1
    return labels


connected_components_cuda.launches = 0
