"""Masked k-means for dominant-color extraction — counterpart of
synapta_tpu/ops/kmeans.py.

Pixels pass the HSV mask (S > 30, 40 < V < 240), a fixed-size sample is
gathered in a scrambled pixel order, maximin seeding picks the initial
centers, and a fixed number of Lloyd iterations run batched over crops.
Parity notes: the scramble hash is done in int64 with a 32-bit wrap, the
masked-first argsort is stable, argmin/argmax take the first index, and the
distances stay x^2 - 2xc + c^2 in float32 as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.color import rgb_to_hsv


def _sample_masked(rgb_flat: torch.Tensor, mask_flat: torch.Tensor, n: int):
    """(B, N, 3) uint8, (B, N) float -> (samples (B, n, 3) float32,
    weights (B, n)): up to n masked pixels, masked first, in the order of
    the bijection i -> (i * 2654435761 mod 2^32) mod N."""
    B, N = mask_flat.shape
    i = torch.arange(N, dtype=torch.int64, device=mask_flat.device)
    perm = ((i * 2654435761) & 0xFFFFFFFF) % N
    rgb_p = rgb_flat[:, perm]
    mask_p = mask_flat[:, perm]
    order = torch.argsort(1.0 - mask_p, dim=1, stable=True)
    idx = order[:, :n]
    samples = torch.gather(rgb_p, 1, idx[..., None].expand(-1, -1, 3))
    weights = torch.gather(mask_p, 1, idx)
    return samples.to(torch.float32), weights


def _assign(samples: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    x2 = (samples * samples).sum(dim=-1, keepdim=True)
    c2 = (centers * centers).sum(dim=-1)[:, None, :]
    xc = torch.einsum("bnd,bkd->bnk", samples, centers)
    return torch.argmin(x2 - 2 * xc + c2, dim=-1)


def dominant_colors(
    rgb: torch.Tensor,
    k: int = 5,
    iters: int = 10,
    sample: int = 4096,
    sat_min: float = 30.0,
    val_range=(40.0, 240.0),
):
    """(B, H, W, 3) uint8 -> (centers (B, k, 3), counts (B, k), n_masked (B,)).

    Centers are RGB float32; counts are masked-pixel counts per cluster."""
    B = rgb.shape[0]
    _, s, v = rgb_to_hsv(rgb)
    mask = (s > sat_min) & (v > val_range[0]) & (v < val_range[1])
    rgb_flat = rgb.reshape(B, -1, 3)
    mask_flat = mask.reshape(B, -1).to(torch.float32)
    samples, weights = _sample_masked(rgb_flat, mask_flat, sample)
    batch = torch.arange(B, device=rgb.device)

    # deterministic farthest-point (maximin) seeding
    centers = torch.zeros((B, k, 3), dtype=torch.float32, device=rgb.device)
    c = samples[:, 0]
    centers[:, 0] = c
    dmin = ((samples - c[:, None]) ** 2).sum(dim=-1) * weights
    for j in range(1, k):
        c = samples[batch, torch.argmax(dmin, dim=1)]
        centers[:, j] = c
        d = ((samples - c[:, None]) ** 2).sum(dim=-1) * weights
        dmin = torch.minimum(dmin, d)

    def weighted_onehot(centers):
        assign = _assign(samples, centers)
        return F.one_hot(assign, k).to(torch.float32) * weights[..., None]

    for _ in range(iters):
        onehot = weighted_onehot(centers)
        sums = torch.einsum("bnk,bnd->bkd", onehot, samples)
        cnts = onehot.sum(dim=1)
        new = sums / torch.clamp(cnts, min=1.0)[..., None]
        centers = torch.where(cnts[..., None] > 0, new, centers)

    counts = weighted_onehot(centers).sum(dim=1)
    n_masked = mask_flat.sum(dim=1)
    return centers, counts, n_masked
