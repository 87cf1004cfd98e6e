"""L0 data model: the output schema of the segmentation pipeline.

Byte-compatible with the reference schema
(``reference/pdf_image_segmentation.py:35-295``): the JSON emitted by
``VisualSegment.to_dict`` matches the reference's field names, ordering, and
the curated ``*_details`` blocks, validated against the golden sample at
``reference/extracted_visuals_excelSS/textbook_001_visual_segments.json``.

Field declaration order matters: serialization walks dataclass fields in
declaration order to reproduce the reference's key ordering exactly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class VisualType(str, Enum):
    """Six-way classification of a visual element (ref :35-42)."""

    FIGURE = "figure"
    CHART = "chart"
    DIAGRAM = "diagram"
    FLOWCHART = "flowchart"
    IMAGE = "image"
    UNKNOWN = "unknown"


@dataclass
class ChartSpecificData:
    """Chart metadata (ref :44-55)."""

    chart_subtype: Optional[str] = None
    axes_info: Dict[str, Any] = field(default_factory=dict)
    value_ranges: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    legend_items: List[str] = field(default_factory=list)
    series_count: int = 0
    grid_detected: bool = False
    color_scheme: List[str] = field(default_factory=list)
    estimated_data_points: int = 0
    tick_labels: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class DiagramSpecificData:
    """Diagram/flowchart metadata (ref :58-69)."""

    diagram_subtype: Optional[str] = None
    node_count: int = 0
    nodes: List[Dict[str, Any]] = field(default_factory=list)
    connections: List[Dict[str, Any]] = field(default_factory=list)
    arrow_count: int = 0
    hierarchy_detected: bool = False
    layout_type: Optional[str] = None
    shapes_detected: Dict[str, int] = field(default_factory=dict)
    has_decision_points: bool = False


@dataclass
class ImageSpecificData:
    """Image metadata incl. calculation-extraction fields (ref :72-90)."""

    image_subtype: Optional[str] = None
    contains_text: bool = False
    text_density: str = "none"
    is_embedded_table: bool = False
    dominant_colors: List[str] = field(default_factory=list)
    estimated_content_type: Optional[str] = None
    definitions: List[Dict[str, str]] = field(default_factory=list)
    formulas: List[Dict[str, str]] = field(default_factory=list)
    variables: List[Dict[str, str]] = field(default_factory=list)
    tables: List[Dict[str, Any]] = field(default_factory=list)
    input_variables: List[Dict[str, Any]] = field(default_factory=list)
    output_values: List[Dict[str, Any]] = field(default_factory=list)
    calculation_verification: Optional[Dict[str, Any]] = None


@dataclass
class FigureSpecificData:
    """Composite-figure flags (ref :92-99)."""

    is_composite: bool = False
    sub_figure_count: int = 0
    contains_chart: bool = False
    contains_diagram: bool = False
    contains_image: bool = False


@dataclass
class BoundingBox:
    """Page-space rectangle in PDF points (ref :101-122)."""

    x0: float
    y0: float
    x1: float
    y1: float
    page_width: float
    page_height: float

    def to_dict(self) -> Dict[str, float]:
        return {
            "x0": self.x0,
            "y0": self.y0,
            "x1": self.x1,
            "y1": self.y1,
            "width": self.x1 - self.x0,
            "height": self.y1 - self.y0,
            "page_width": self.page_width,
            "page_height": self.page_height,
        }

    def area(self) -> float:
        return (self.x1 - self.x0) * (self.y1 - self.y0)

    def intersect_area(self, other: "BoundingBox") -> float:
        w = min(self.x1, other.x1) - max(self.x0, other.x0)
        h = min(self.y1, other.y1) - max(self.y0, other.y0)
        return max(0.0, w) * max(0.0, h)

    def iou(self, other: "BoundingBox") -> float:
        inter = self.intersect_area(other)
        union = self.area() + other.area() - inter
        return inter / union if union > 0 else 0.0


@dataclass
class OCRResult:
    """Structured OCR output (ref :125-139).

    ``blocks`` entries are ``{"text": str, "bbox": [x0,y0,x1,y1] px,
    "confidence": float 0-100}``; ``confidence`` is the 0-1 mean.
    """

    raw_text: str
    blocks: List[Dict[str, Any]] = field(default_factory=list)
    confidence: float = 0.0
    axis_labels: Dict[str, str] = field(default_factory=dict)
    legend_items: List[str] = field(default_factory=list)
    tick_labels: Dict[str, List[str]] = field(default_factory=dict)
    node_texts: List[str] = field(default_factory=list)
    detected_arrows: int = 0


@dataclass
class MermaidRepresentation:
    """Mermaid source for a diagram/flowchart segment (ref :142-148)."""

    mermaid_code: Optional[str] = None
    diagram_type: Optional[str] = None
    extraction_confidence: float = 0.0
    extraction_notes: str = ""


def to_builtin(obj: Any) -> Any:
    """Coerce numpy scalars/arrays (and nested containers) to JSON-native
    Python types (ref :207-225)."""
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: to_builtin(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_builtin(v) for v in obj]
    return obj


@dataclass
class VisualSegment:
    """One extracted visual element — the pipeline's output record
    (ref :151-295). Field order here defines JSON key order."""

    segment_id: str
    segment_type: VisualType
    book_id: str
    page_no: int
    bbox: BoundingBox
    image_path: Optional[str] = None
    image_bytes: Optional[bytes] = None
    caption_text: Optional[str] = None
    figure_number: Optional[str] = None
    reference_keys: List[str] = field(default_factory=list)
    ocr_result: Optional[OCRResult] = None
    mermaid_repr: Optional[MermaidRepresentation] = None
    chart_data: Optional[ChartSpecificData] = None
    diagram_data: Optional[DiagramSpecificData] = None
    image_data: Optional[ImageSpecificData] = None
    figure_data: Optional[FigureSpecificData] = None
    extracted_text_structured: Dict[str, List[str]] = field(default_factory=dict)
    classification_confidence: float = 0.0
    classification_method: str = "heuristic"
    summary: Optional[str] = None
    summary_confidence: float = 0.0
    linked_concept_ids: List[Dict[str, Any]] = field(default_factory=list)
    heading_path: List[str] = field(default_factory=list)
    linked_segment_ids: List[str] = field(default_factory=list)
    nearby_text: Optional[str] = None
    extraction_method: str = "native"
    confidence: float = 1.0
    notes: str = ""

    # Curated-views: limits applied in to_dict (ref :252, :268).
    _MAX_NODES_IN_DETAILS = 15
    _MAX_COLORS_IN_DETAILS = 5

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["segment_type"] = self.segment_type.value
        out["bbox"] = self.bbox.to_dict() if self.bbox else None
        out.pop("image_bytes", None)

        cd = self.chart_data
        if cd:
            out["chart_details"] = {
                "subtype": cd.chart_subtype,
                "axes": cd.axes_info,
                "legend": cd.legend_items,
                "series_count": cd.series_count,
                "data_points": cd.estimated_data_points,
                "has_grid": cd.grid_detected,
                "colors": cd.color_scheme,
                "value_ranges": cd.value_ranges,
                "tick_labels": cd.tick_labels,
            }
        dd = self.diagram_data
        if dd:
            out["diagram_details"] = {
                "subtype": dd.diagram_subtype,
                "node_count": dd.node_count,
                "nodes": dd.nodes[: self._MAX_NODES_IN_DETAILS],
                "connection_count": len(dd.connections),
                "arrow_count": dd.arrow_count,
                "layout_type": dd.layout_type,
                "has_hierarchy": dd.hierarchy_detected,
                "has_decision_points": dd.has_decision_points,
                "shapes": dd.shapes_detected,
            }
        idata = self.image_data
        if idata:
            out["image_details"] = {
                "subtype": idata.image_subtype,
                "contains_text": idata.contains_text,
                "text_density": idata.text_density,
                "is_embedded_table": idata.is_embedded_table,
                "content_type": idata.estimated_content_type,
                "dominant_colors": idata.dominant_colors[: self._MAX_COLORS_IN_DETAILS],
                "definitions": idata.definitions,
                "formulas": idata.formulas,
                "variables": idata.variables,
                "tables": idata.tables,
                "input_variables": idata.input_variables,
                "output_values": idata.output_values,
                "calculation_verification": idata.calculation_verification,
            }
        fd = self.figure_data
        if fd:
            out["figure_details"] = {
                "is_composite": fd.is_composite,
                "sub_figure_count": fd.sub_figure_count,
                "contains_chart": fd.contains_chart,
                "contains_diagram": fd.contains_diagram,
                "contains_image": fd.contains_image,
            }
        if self.extracted_text_structured:
            out["extracted_text_structured"] = self.extracted_text_structured
        return to_builtin(out)


def _pick(d: Dict[str, Any], cls) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def segment_from_dict(d: Dict[str, Any]) -> VisualSegment:
    """Inverse of ``VisualSegment.to_dict`` (curated ``*_details`` blocks are
    derived data and ignored). Used by checkpoint/resume."""
    b = d["bbox"]
    bbox = BoundingBox(
        x0=b["x0"], y0=b["y0"], x1=b["x1"], y1=b["y1"],
        page_width=b["page_width"], page_height=b["page_height"],
    )
    kw: Dict[str, Any] = {
        k: v
        for k, v in d.items()
        if k
        not in (
            "bbox", "segment_type", "ocr_result", "mermaid_repr",
            "chart_data", "diagram_data", "image_data", "figure_data",
            "chart_details", "diagram_details", "image_details", "figure_details",
        )
    }
    kw = _pick(kw, VisualSegment)
    seg = VisualSegment(
        bbox=bbox,
        segment_type=VisualType(d["segment_type"]),
        **kw,
    )
    if d.get("ocr_result"):
        seg.ocr_result = OCRResult(**_pick(d["ocr_result"], OCRResult))
    if d.get("mermaid_repr"):
        seg.mermaid_repr = MermaidRepresentation(**_pick(d["mermaid_repr"], MermaidRepresentation))
    if d.get("chart_data"):
        seg.chart_data = ChartSpecificData(**_pick(d["chart_data"], ChartSpecificData))
    if d.get("diagram_data"):
        seg.diagram_data = DiagramSpecificData(**_pick(d["diagram_data"], DiagramSpecificData))
    if d.get("image_data"):
        seg.image_data = ImageSpecificData(**_pick(d["image_data"], ImageSpecificData))
    if d.get("figure_data"):
        seg.figure_data = FigureSpecificData(**_pick(d["figure_data"], FigureSpecificData))
    return seg
