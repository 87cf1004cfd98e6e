"""The hand-written CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports neither jax nor the JAX package, so it
also runs on a GPU machine without JAX, bypassing the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs are seeded numpy arrays; results must be bit-identical.
"""
import numpy as np
import pytest
import torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _masks():
    rng = np.random.default_rng(0)
    blobs = np.zeros((3, 64, 128), np.float32)
    for b in range(3):
        for _ in range(12):
            y, x = rng.integers(0, 56), rng.integers(0, 118)
            h, w = rng.integers(2, 9), rng.integers(2, 11)
            blobs[b, y:y + h, x:x + w] = 1.0
    return [
        blobs,
        (rng.random((16, 256, 256)) < 0.45).astype(np.float32),
        (rng.random((2, 37, 53)) < 0.6).astype(np.float32),  # ragged shape
        np.zeros((1, 16, 16), np.float32),
        np.ones((1, 16, 16), np.float32),
    ]


def _grays():
    rng = np.random.default_rng(1)
    blocks = rng.integers(0, 2, (4, 64, 64)).repeat(8, 1).repeat(8, 2) * 255.0
    return [
        blocks.astype(np.float32),
        rng.integers(0, 256, (2, 512, 512)).astype(np.float32),
        rng.integers(0, 256, (2, 40, 70)).astype(np.float32),  # ragged shape
        np.full((1, 64, 64), 255.0, np.float32),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("conn,cap", [(8, 6), (8, 4), (4, 6), (8, 10), (8, 64),
                                      (4, 0)])
def test_cc_kernel_equals_twin(conn, cap):
    _need_cuda()
    from synapta_tpu_torch.ops.cc import connected_components_reference
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda

    for m in _masks():
        x = torch.from_numpy(m).cuda()
        got = connected_components_cuda(x, cap, conn)
        torch.cuda.synchronize()
        assert torch.equal(got, connected_components_reference(x, cap, conn))


@pytest.mark.cuda
@pytest.mark.parametrize("line_k,grid_k,high", [(20, 25, 150.0), (4, 6, 90.0)])
def test_edge_stats_kernel_equals_twin(line_k, grid_k, high):
    _need_cuda()
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats_cuda,
        fused_edge_stats_reference,
    )

    for g in _grays():
        x = torch.from_numpy(g).cuda()
        got = fused_edge_stats_cuda(x, line_k, grid_k, high)
        torch.cuda.synchronize()
        assert torch.equal(got, fused_edge_stats_reference(x, line_k, grid_k, high))


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_inputs():
    _need_cuda()
    from synapta_tpu_torch.ops.cc import connected_components
    from synapta_tpu_torch.ops.cuda_cc import connected_components_cuda
    from synapta_tpu_torch.ops.cuda_kernels import (
        fused_edge_stats,
        fused_edge_stats_cuda,
    )

    m = torch.ones((1, 8, 8), device="cuda")
    n_cc, n_es = connected_components_cuda.launches, fused_edge_stats_cuda.launches
    connected_components(m)
    fused_edge_stats(m)
    assert connected_components_cuda.launches == n_cc + 1
    assert fused_edge_stats_cuda.launches == n_es + 1
    with pytest.raises(ValueError):
        connected_components(m.to(torch.float64))  # no silent fallback
    with pytest.raises(ValueError):
        fused_edge_stats(m[:, :, ::2])  # not contiguous
