"""The fused per-crop analyze pass: a frozen copy of
``synapta_tpu_torch/ops/features.py::analyze`` over the frozen plain twins
(``cc``, ``edge_stats``), the reference of the benchmark's comparison.

``reference_analyze`` takes the same host (B, H, W, 3) uint8 crop chunk and
(B, 2) true sizes that the program's ``device_analyze_dispatch`` takes, does
the host split again, and returns the same packed (B, n) float32 layout:
``_SCALAR_KEYS``, 15 k-means centre values, 5 counts, MAX_LINES x 5 boxes.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.cc import (
    census_counts,
    component_stats_device,
    connected_components,
)
from portbench.reference.edge_stats import fused_edge_stats
from portbench.reference.filters import (
    binarize_ink,
    box_count,
    diagonal_run_mask,
    downsample2,
    downsample2_min,
    dilate,
    erode,
    morph_open,
    sobel_edges,
)
from portbench.reference.kmeans import dominant_colors


def _open_iter2(img: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2 MORPH_OPEN with iterations=2 == erode twice then dilate twice,
    equivalent to one open with the (2k-1)-sized kernel."""
    ekh = 2 * kh - 1 if kh > 1 else 1
    ekw = 2 * kw - 1 if kw > 1 else 1
    return dilate(erode(img, ekh, ekw), ekh, ekw)


def _run_length_rows(mask: torch.Tensor, min_len: int) -> torch.Tensor:
    """Per-image count of pixels that belong to a horizontal run >= min_len."""
    return box_count(erode(mask, 1, min_len) > 0)


def _enclosed_mask(ink: torch.Tensor) -> torch.Tensor:
    """Non-ink pixels with ink on all four sides (ray casting via
    directional cumulative max) — the interiors of outlined shapes."""

    def cmax(a, dim, rev):  # lax.associative_scan(max) == cummax
        if rev:
            return torch.cummax(a.flip(dim), dim=dim).values.flip(dim)
        return torch.cummax(a, dim=dim).values

    left = cmax(ink, 2, False) > 0
    right = cmax(ink, 2, True) > 0
    top = cmax(ink, 1, False) > 0
    bottom = cmax(ink, 1, True) > 0
    return (left & right & top & bottom & (ink == 0)).to(torch.float32)


def _component_censuses(ink, vink, bg, sizes) -> Dict[str, torch.Tensor]:
    """Per-component censuses at half resolution (see the JAX version for
    the threshold scaling). sizes: (B, 2) true (h, w) of each crop.
    Returns (B,) float32 counts."""
    true_h = sizes[:, 0:1].to(torch.float32)
    true_w = sizes[:, 1:2].to(torch.float32)

    ink_stats = component_stats_device(
        connected_components(downsample2(ink), max_iters=6), k=8
    )
    blob_count = census_counts(
        ink_stats, lambda a, w, h, *_: (a >= 3) & (a <= 44)
    )

    def solid_pred(kind):
        def pred(a, w, h, x0, y0, x1, y1):
            fill = a / torch.clamp(w * h, min=1.0)
            base = (a >= 30) & (w >= 6) & (h >= 6)
            if kind == "rect":
                return base & (fill > 0.85)
            if kind == "circle":
                return base & (fill > 0.65) & (fill <= 0.85)
            return base & (fill > 0.35) & (fill <= 0.65)
        return pred

    ink_rect = census_counts(ink_stats, solid_pred("rect"))
    ink_circle = census_counts(ink_stats, solid_pred("circle"))
    ink_diamond = census_counts(ink_stats, solid_pred("diamond"))

    vink_stats = component_stats_device(
        connected_components(downsample2_min(vink), max_iters=4), k=8
    )
    tall_bars = census_counts(
        vink_stats,
        lambda a, w, h, *_: (h > 0.1 * true_h) & (h > 1.2 * w) & (w >= 2.0),
    )
    filled_bars = census_counts(
        vink_stats,
        lambda a, w, h, *_: (h > 0.06 * true_h) & (w >= 4.0),
    )

    bg_stats = component_stats_device(
        connected_components(downsample2(_enclosed_mask(1.0 - bg)),
                             max_iters=6, connectivity=4),
        k=8,
    )
    bg_scale = 2.0

    def bg_pred(kind):
        def pred(a, w, h, x0, y0, x1, y1):
            fill = a / torch.clamp(w * h, min=1.0)
            interior = (
                (x0 > 0) & (y0 > 0)
                & (x1 < true_w / bg_scale - 1)
                & (y1 < true_h / bg_scale - 1)
                & (a < 0.5 * true_h * true_w / (bg_scale * bg_scale))
            )
            base = interior & (a >= 120 / (bg_scale * bg_scale)) & (w >= 6) & (h >= 6)
            if kind == "rect":
                return base & (fill > 0.85)
            if kind == "circle":
                return base & (fill > 0.65) & (fill <= 0.85)
            return base & (fill > 0.35) & (fill <= 0.65)
        return pred

    return {
        "blob_count": blob_count,
        "tall_bars": tall_bars,
        "filled_bars": filled_bars,
        "shapes_rect": ink_rect + census_counts(bg_stats, bg_pred("rect")),
        "shapes_circle": ink_circle + census_counts(bg_stats, bg_pred("circle")),
        "shapes_diamond": ink_diamond + census_counts(bg_stats, bg_pred("diamond")),
    }


_SCALAR_KEYS = (
    "v_pixels", "h_pixels", "long_h_pixels", "grid_h", "grid_v",
    "diag_pixels", "line_pixels", "ring_score", "ring_radius",
    "circle_edge_density", "ring_coverage", "variance", "edge_count", "ink_count",
    "v_ink_pixels", "blob_count", "tall_bars", "filled_bars",
    "shapes_rect", "shapes_circle", "shapes_diamond", "kmeans_masked",
)


def _pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every per-crop output in ONE (B, 22 + 15 + 5) float32 tensor."""
    cols = [out[k].to(torch.float32)[:, None] for k in _SCALAR_KEYS]
    B = cols[0].shape[0]
    cols.append(out["kmeans_centers"].reshape(B, -1))
    cols.append(out["kmeans_counts"].reshape(B, -1))
    return torch.cat(cols, dim=1)


def _core_features(gray_u8: torch.Tensor, rgb_q: torch.Tensor,
                   line_kernel: int = 20, grid_kernel: int = 25) -> Dict[str, torch.Tensor]:
    """Fused non-CC features.

    gray_u8: (B, H, W) uint8 luma; rgb_q: (B, h, w, 3) uint8 color sample
    used only by k-means. The edge/open/grid counts on the default route
    (centred opens, the union count)."""
    B, H, W = gray_u8.shape
    dev = gray_u8.device
    gray = gray_u8.to(torch.float32)
    edges, _, _ = sobel_edges(gray)
    e = edges.to(torch.float32)

    long_h_pixels = _run_length_rows(e, max(8, W // 5))
    diag1 = diagonal_run_mask(edges, 24, anti=False)
    diag2 = diagonal_run_mask(edges, 24, anti=True)
    diag_pixels = box_count(diag1 | diag2)

    stats = fused_edge_stats(gray, line_kernel, grid_kernel)
    edge_count = stats[:, 0]
    v_pixels = stats[:, 1]
    h_pixels = stats[:, 2]
    grid_h = stats[:, 3]
    grid_v = stats[:, 4]
    # overall line pixels for connection counting: the union
    line_pixels = stats[:, 5] + diag_pixels

    # circle / pie scoring: radial histogram of edge pixels around the ink
    # centroid (scatter_add, not the JAX one-hot: that would materialise a
    # (B, H, W, 48) tensor; sums of 0/1 are exact either way)
    ink = binarize_ink(gray)
    ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    ink_n = torch.clamp(box_count(ink), min=1.0)
    cy = (ys * ink).sum(dim=(1, 2)) / ink_n
    cx = (xs * ink).sum(dim=(1, 2)) / ink_n
    dy = ys - cy[:, None, None]
    dx = xs - cx[:, None, None]
    r = torch.sqrt(dy ** 2 + dx ** 2)
    NBINS = 48
    rmax = 0.5 * min(H, W)
    rbin = torch.clamp((r / rmax * NBINS).to(torch.int64), 0, NBINS - 1)
    hist = torch.zeros((B, NBINS), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, rbin.reshape(B, -1), e.reshape(B, -1))
    bin_r = (torch.arange(NBINS, dtype=torch.float32, device=dev) + 0.5) * (
        rmax / NBINS
    )
    density = hist / (2 * math.pi * bin_r + 1e-6)[None, :]
    lo, hi = int(NBINS * 0.4), int(NBINS * 0.95)
    band = density[:, lo:hi]
    ring_peak = band.max(dim=1).values
    ring_bin = torch.argmax(band, dim=1) + lo
    ring_radius = (ring_bin.to(torch.float32) + 0.5) * (rmax / NBINS)
    band_mean = band.mean(dim=1)
    ring_score = ring_peak / (band_mean + 1e-6)
    inside = (r <= ring_radius[:, None, None]).to(torch.float32)
    inside_edges = (e * inside).sum(dim=(1, 2))
    circle_edge_density = inside_edges / (
        math.pi * ring_radius * ring_radius + 1e-6
    )
    ABINS = 36
    ang = torch.atan2(dy.expand(B, H, W), dx.expand(B, H, W))
    abin = torch.clamp(
        ((ang + math.pi) / (2 * math.pi) * ABINS).to(torch.int64), 0, ABINS - 1
    )
    on_ring = (
        torch.abs(r - ring_radius[:, None, None]) < (rmax / NBINS) * 1.5
    ).to(torch.float32) * e
    ahist = torch.zeros((B, ABINS), dtype=torch.float32, device=dev)
    ahist.scatter_add_(1, abin.reshape(B, -1), on_ring.reshape(B, -1))
    ring_coverage = (ahist > 0).to(torch.float32).mean(dim=1)

    # jnp.var (population), from exact integer sums of the uint8 luma: a
    # float reduction's order follows the batch size on the GPU, and a crop's
    # features must not depend on the chunk it is analysed in
    g64 = gray_u8.to(torch.int64)
    s1 = g64.sum(dim=(1, 2)).to(torch.float64)
    s2 = (g64 * g64).sum(dim=(1, 2)).to(torch.float64)
    variance = ((s2 - s1 * s1 / (H * W)) / (H * W)).to(torch.float32)

    v_ink = morph_open(ink, 2 * line_kernel - 1, 1)
    v_ink_pixels = box_count(v_ink > 0)

    # quarter-res color sample: counts scale by 4 to full-image pixel units
    centers, ccounts, n_masked = dominant_colors(rgb_q)
    return {
        "v_pixels": v_pixels,
        "h_pixels": h_pixels,
        "long_h_pixels": long_h_pixels,
        "grid_h": grid_h,
        "grid_v": grid_v,
        "diag_pixels": diag_pixels,
        "line_pixels": line_pixels,
        "ring_score": ring_score,
        "ring_radius": ring_radius,
        "circle_edge_density": circle_edge_density,
        "ring_coverage": ring_coverage,
        "variance": variance,
        "edge_count": edge_count,
        "ink_count": box_count(ink),
        "_ink": ink,
        "_vink": (v_ink > 0).to(torch.float32),
        "_bg": 1.0 - ink,
        "v_ink_pixels": v_ink_pixels,
        "kmeans_centers": centers,
        "kmeans_counts": ccounts * 4.0,
        "kmeans_masked": n_masked * 4.0,
    }


@torch.inference_mode()
def analyze(gray_u8: torch.Tensor, rgb_q: torch.Tensor,
            sizes: torch.Tensor) -> torch.Tensor:
    """The whole per-crop analysis in one pass: features, component
    censuses and text-line boxes packed into one (B, n) float32 tensor on
    the input's device."""
    from portbench.reference.linedet import line_boxes_from_ink

    out = _core_features(gray_u8, rgb_q, 20, 25)
    ink, vink, bg = out.pop("_ink"), out.pop("_vink"), out.pop("_bg")
    out.update(_component_censuses(ink, vink, bg, sizes))
    boxes = line_boxes_from_ink(ink)  # (B, MAX_LINES, 5)
    packed = _pack(out)
    return torch.cat([packed, boxes.reshape(packed.shape[0], -1)], dim=1)


def _host_split(rgb, sizes):
    """HOST (B, H, W, 3) uint8 crops -> (gray u8, eighth-res RGB, (B, 2)
    int32 sizes), what the analyze pass takes to the device."""
    import numpy as np

    from portbench.reference.color import gray_quarter_host

    B, H, W = rgb.shape[:3]
    if sizes is None:
        sizes = np.tile(np.array([H, W], np.int32), (B, 1))
    gray, rgb_q = gray_quarter_host(np.asarray(rgb))
    return gray, np.ascontiguousarray(rgb_q[:, ::2, ::2]), np.asarray(sizes, np.int32)


def reference_analyze(rgb, sizes, device) -> torch.Tensor:
    """HOST (B, H, W, 3) uint8 crops and (B, 2) true sizes -> the packed
    (B, n) float32 analysis on ``device``, default edge-stats route."""
    gray, rgb_q, sizes = (torch.from_numpy(a).to(device)
                          for a in _host_split(rgb, sizes))
    return analyze(gray, rgb_q, sizes)
