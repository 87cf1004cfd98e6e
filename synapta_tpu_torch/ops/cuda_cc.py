"""Wrapper of the CUDA connected-components kernel (csrc/cc.cu).

Replaces synapta_tpu/ops/pallas_cc.py::connected_components_pallas; the
plain twin is ops/cc.py::connected_components_reference. The source's
header comment says what bounds the kernel on Hopper and how the design
answers it: one thread-block cluster per map, the map in shared memory for
every round, and a stop at the fixed point.
"""
from __future__ import annotations

import ctypes

import torch

from synapta_tpu_torch.ops import _build


def cc_plan(H: int, W: int) -> tuple[int, int]:
    """(CTAs per map, dynamic shared memory bytes per CTA) of an H x W map.
    Raises ValueError when a band of the map does not fit a block."""
    cluster, smem = ctypes.c_int(), ctypes.c_int()
    err = _build.library().synapta_cc_plan(H, W, ctypes.byref(cluster),
                                           ctypes.byref(smem))
    if err != 0:
        raise ValueError(
            f"a {H}x{W} map does not fit one cluster of at most 8 CTAs "
            f"({smem.value} bytes of shared memory per CTA)"
        )
    return cluster.value, smem.value


def connected_components_cuda(mask: torch.Tensor, max_iters: int = 10,
                              connectivity: int = 8,
                              return_rounds: bool = False):
    """(B, H, W) float32 {0,1} CUDA mask -> int32 labels after at most
    ``max_iters + 1`` propagation rounds, stopping at the fixed point. With
    ``return_rounds`` also the (B,) int32 rounds each map took. Launches on
    the current stream and does not synchronise; raises on any launch
    error."""
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
    cc_plan(H, W)
    labels = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    rounds = torch.empty((B,), dtype=torch.int32, device=mask.device)
    lib = _build.library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.synapta_cc(
            mask.data_ptr(), labels.data_ptr(), rounds.data_ptr(),
            B, H, W, max_iters + 1, connectivity, stream,
        )
    _build.check(err, "synapta_cc")
    connected_components_cuda.launches += 1
    return (labels, rounds) if return_rounds else labels


connected_components_cuda.launches = 0
