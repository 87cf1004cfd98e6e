"""Local (no-LLM) per-type feature extraction and classification.

The old-algorithm variant's CPU-hot path
(ref pdf_image_segmentation_old_algo.py:888-1010: process_chart_specific /
process_diagram_specific / process_image_specific / process_figure_specific)
rebuilt over the batched TPU feature pass: every pixel statistic comes from
``extract_crop_features``; only string logic runs here. Also provides the
heuristic VisualType classifier used when the vision LLM is disabled — an
upgrade over the reference's blanket FIGURE/0.3 fallback (ref :701-715),
per the north star's "VisualType assignment without host round-trips".
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

from synapta_tpu_torch.config import HeuristicsConfig
from synapta_tpu_torch.ocr import heuristics as H
from synapta_tpu_torch.ops.kmeans import colors_to_hex
from synapta_tpu_torch.schema import (
    ChartSpecificData,
    DiagramSpecificData,
    FigureSpecificData,
    ImageSpecificData,
    OCRResult,
    VisualType,
)
from synapta_tpu_torch.vision import classify as C


def dominant_colors_for(f: C.CropFeatures) -> list:
    return colors_to_hex(
        f.kmeans_centers, f.kmeans_counts, float(f.kmeans_masked)
    )


def classify_heuristic(
    f: C.CropFeatures,
    ocr: Optional[OCRResult],
    cfg: HeuristicsConfig = HeuristicsConfig(),
) -> Tuple[VisualType, float]:
    """Local VisualType decision from device features + OCR text."""
    text = ocr.raw_text if ocr else ""
    subtype = C.detect_chart_subtype(f, text, cfg)
    arrows = int(ocr.detected_arrows) if ocr else 0
    shapes = C.detect_shapes(f)
    # embedded tables first: their row rules mimic a line chart's
    # horizontal structure, but dense numeric text rows give them away
    # line charts also have numeric-dense OCR, but their series strokes
    # carry diagonal mass; table rules and text have none
    if (
        C.detect_embedded_table(text, cfg)
        and int(f.tall_bars) == 0
        and float(f.diag_pixels) < 60
    ):
        return VisualType.IMAGE, 0.6
    # screenshots (spreadsheets / software windows): a ruled grid under
    # paragraph-scale OCR across many text rows is a window capture, not a
    # data chart — charts carry at most axis ticks + a legend. The golden
    # Excel crop (ref extracted_visuals_excelSS, segment_type "image") is
    # the type specimen; thresholds from ref's image-subtype text-density
    # family (:1791-1810)
    if (
        ocr is not None
        and len(text) > cfg.screenshot_gate_chars
        and len(ocr.blocks) >= cfg.screenshot_gate_blocks
        and C.detect_grid(f, cfg)
    ):
        return VisualType.IMAGE, 0.6
    has_axes_structure = C.detect_grid(f, cfg) or subtype in (
        "bar", "line", "pie", "scatter", "candlestick", "histogram"
    )
    if subtype != "unknown" and has_axes_structure:
        return VisualType.CHART, 0.7
    # squat-bar charts: bars wider than tall fail the subtype census's
    # aspect test (the reference's CV had the same blind spot and leaned
    # on the LLM, ref :1403-1406) — but gridlines plus >= 2 FILLED bars
    # is chart-only evidence (flowcharts have outlined nodes, no grid)
    if C.detect_grid(f, cfg) and int(f.filled_bars) >= 2:
        return VisualType.CHART, 0.6
    n_rect = shapes.get("rectangles", 0)
    n_diamond = shapes.get("diamonds", 0)
    decision = C.detect_decision_points(f, text)
    # tall_bars guard: FILLED chart bars register in the solid-shape
    # censuses as rects/diamonds (the reference never hit this because it
    # only ran shape detection on LLM-classified diagrams, old_algo
    # :921-951); flowchart nodes are OUTLINED boxes, which the filled-bar
    # census (morph-opened ink) never counts
    if n_diamond >= 1 and n_rect >= 2 and int(f.filled_bars) < 2:
        return VisualType.FLOWCHART, 0.65
    if int(f.filled_bars) < 2 and (
        (n_rect + n_diamond >= 3 and arrows >= 1)
        or (decision and n_rect >= 2)
    ):
        return VisualType.FLOWCHART, 0.55
    nodes = H.extract_nodes(ocr) if ocr else []
    if n_rect + shapes.get("circles", 0) >= 3 and len(nodes) >= 3:
        return VisualType.DIAGRAM, 0.55
    if float(f.variance) > cfg.photo_variance or (
        float(f.kmeans_masked) > 0.3 * f.height * f.width
    ):
        return VisualType.IMAGE, 0.6
    if C.detect_embedded_table(text, cfg):
        return VisualType.IMAGE, 0.55
    return VisualType.FIGURE, 0.4


def process_chart_specific(
    f: C.CropFeatures, ocr: Optional[OCRResult],
    cfg: HeuristicsConfig = HeuristicsConfig(),
) -> ChartSpecificData:
    """(ref old_algo :888-919)"""
    text = ocr.raw_text if ocr else ""
    legend = H.detect_legend_advanced(ocr, (f.width, f.height),
                                      cfg.legend_right_frac, cfg.legend_vgap)
    return ChartSpecificData(
        chart_subtype=C.detect_chart_subtype(f, text, cfg),
        axes_info=H.extract_axes_detailed(ocr),
        value_ranges=H.extract_value_ranges(ocr),
        legend_items=legend,
        series_count=len(legend) if legend else 1,
        grid_detected=C.detect_grid(f, cfg),
        color_scheme=dominant_colors_for(f),
        estimated_data_points=C.estimate_data_points(f, cfg),
        tick_labels=H.extract_tick_labels(ocr),
    )


def process_diagram_specific(
    f: C.CropFeatures, ocr: Optional[OCRResult],
    cfg: HeuristicsConfig = HeuristicsConfig(),
) -> DiagramSpecificData:
    """(ref old_algo :921-951)"""
    text = ocr.raw_text if ocr else ""
    nodes = H.extract_nodes(ocr, cfg.node_cap)
    return DiagramSpecificData(
        diagram_subtype=C.detect_diagram_subtype(text),
        node_count=len(nodes),
        nodes=nodes,
        connections=C.count_connections(f, cfg),
        arrow_count=int(ocr.detected_arrows) if ocr else 0,
        hierarchy_detected=C.detect_hierarchy(nodes, cfg.hierarchy_y_range),
        layout_type=C.detect_layout_type(nodes, cfg.layout_variance_ratio),
        shapes_detected=C.detect_shapes(f),
        has_decision_points=C.detect_decision_points(f, text),
    )


def process_image_specific(
    f: C.CropFeatures, ocr: Optional[OCRResult],
    cfg: HeuristicsConfig = HeuristicsConfig(),
) -> ImageSpecificData:
    """(ref old_algo :953-983)"""
    text = ocr.raw_text if ocr else ""
    data = ImageSpecificData(
        image_subtype=C.detect_image_subtype(f, text, cfg),
        is_embedded_table=C.detect_embedded_table(text, cfg),
        dominant_colors=dominant_colors_for(f),
        estimated_content_type=C.estimate_content_type(text),
    )
    if text.strip():
        data.contains_text = len(text.strip()) > 10
        n = len(text)
        if n > 500:
            data.text_density = "dense"
        elif n > 100:
            data.text_density = "moderate"
        elif n > 0:
            data.text_density = "sparse"
    return data


def process_figure_specific(
    f: C.CropFeatures, ocr: Optional[OCRResult],
    cfg: HeuristicsConfig = HeuristicsConfig(),
) -> FigureSpecificData:
    """(ref old_algo :985-1010)"""
    data = FigureSpecificData()
    text = (ocr.raw_text if ocr else "").lower()
    if text:
        matches = re.findall(r"\([a-z]\)|\b[a-z]\)", text)
        if len(matches) >= 2:
            data.is_composite = True
            data.sub_figure_count = len(matches)
    data.contains_chart = C.detect_grid(f, cfg)
    arrows = int(ocr.detected_arrows) if ocr else 0
    data.contains_diagram = arrows > 3
    data.contains_image = float(f.variance) > 1000.0
    return data


def process_for_type(visual_type: VisualType, f: C.CropFeatures,
                     ocr: Optional[OCRResult],
                     cfg: HeuristicsConfig = HeuristicsConfig()):
    """Dispatch to the per-type processor; returns the 4-tuple of payloads
    (old-algo _process_segment step 3, ref old_algo :3164-3183)."""
    chart = diagram = image = figure = None
    if visual_type == VisualType.CHART:
        chart = process_chart_specific(f, ocr, cfg)
    elif visual_type in (VisualType.DIAGRAM, VisualType.FLOWCHART):
        diagram = process_diagram_specific(f, ocr, cfg)
        if visual_type == VisualType.FLOWCHART:
            diagram.diagram_subtype = "flowchart"
    elif visual_type == VisualType.IMAGE:
        image = process_image_specific(f, ocr, cfg)
    elif visual_type == VisualType.FIGURE:
        figure = process_figure_specific(f, ocr, cfg)
    return chart, diagram, image, figure


def generate_fallback_summary(segment) -> str:
    """Rule-based summary (ref :3755-3775)."""
    parts = []
    if segment.segment_type == VisualType.CHART:
        parts.append("This chart displays")
        if segment.ocr_result and segment.ocr_result.axis_labels:
            axes = segment.ocr_result.axis_labels
            if "x" in axes and "y" in axes:
                parts.append(f"{axes['y']} versus {axes['x']}")
    elif segment.segment_type == VisualType.DIAGRAM:
        parts.append("This diagram illustrates a system or process")
    elif segment.segment_type == VisualType.FLOWCHART:
        parts.append("This flowchart shows a sequential process")
    else:
        parts.append(f"This {segment.segment_type.value}")
    if segment.caption_text:
        parts.append(f"Caption: {segment.caption_text[:100]}")
    return ". ".join(parts)
