"""Explicit device resolution — the counterpart of utils/jaxsetup.py.

A caller names its device. ``"cuda"`` means the GPU and raises when there is
none: a run that silently lands on the CPU would report the wrong machine's
numbers. The CPU is used only when asked for by name.
"""
from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"`` -> that GPU (raises without CUDA);
    ``"cpu"`` -> the CPU. Anything else raises ValueError."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available"
            )
        # TF32 keeps ~3 decimal digits: a float32 matmul or convolution must
        # mean float32, as it does in the JAX reference (cuDNN convs default
        # to TF32 otherwise).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
