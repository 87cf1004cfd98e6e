"""String/geometry heuristics over OCR results (host-side).

Ports the reference's OCR-dependent extraction helpers
(ref pdf_image_segmentation.py:1197-1308, 1463-1544, 1619-1654, 1676-1693):
axis labels, legend clustering, tick labels, value ranges, diagram nodes,
structured text. These are cheap string ops on the (small) OCR block lists
the batched TPU OCR emits — deliberately host-side.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from synapta_tpu_torch.schema import OCRResult

_PURE_NUMERIC = re.compile(r"^[\d\-/.,\s%$€£¥]+$")
_PURE_NUMERIC_KMB = re.compile(r"^[\d\-/.,\s%$€£¥KMB]+$")


def extract_structured_text(ocr: Optional[OCRResult],
                            label_max_chars: int = 30) -> Dict[str, List[str]]:
    """Split OCR lines into labels / values / annotations (ref :1197-1229)."""
    out: Dict[str, List[str]] = {"labels": [], "values": [], "annotations": []}
    if not ocr or not ocr.raw_text:
        return out
    for line in ocr.raw_text.split("\n"):
        line = line.strip()
        if not line:
            continue
        if re.search(r"\d", line) and len(line) < label_max_chars:
            out["values"].append(line)
        elif len(line) < label_max_chars:
            out["labels"].append(line)
        else:
            out["annotations"].append(line)
    return out


def detect_axis_labels(text: str) -> Dict[str, str]:
    """Keyword-based x/y axis label pick (ref :1231-1242)."""
    labels: Dict[str, str] = {}
    for line in (text or "").split("\n"):
        low = line.lower()
        if any(k in low for k in ("year", "time", "date")):
            labels["x"] = line.strip()
        elif any(k in low for k in ("value", "price", "amount", "%")):
            labels["y"] = line.strip()
    return labels


def detect_legend_advanced(
    ocr: Optional[OCRResult],
    image_size: Tuple[int, int],
    right_frac: float = 0.6,
    vgap: float = 50.0,
) -> List[str]:
    """Right-side spatial clustering of legend candidates (ref :1255-1308)."""
    if not ocr or not ocr.blocks:
        return []
    width, _height = image_size
    cands = []
    for b in ocr.blocks:
        text = (b.get("text") or "").strip()
        bbox = b.get("bbox") or [0, 0, 0, 0]
        if not text or len(text) < 3 or len(text) > 30:
            continue
        if _PURE_NUMERIC.match(text):
            continue
        x_mid = (bbox[0] + bbox[2]) / 2
        if x_mid > right_frac * width:
            cands.append({"text": text, "y": (bbox[1] + bbox[3]) / 2})
    if len(cands) < 2:
        return [c["text"] for c in cands]
    cands.sort(key=lambda c: c["y"])
    groups: List[List[Dict]] = []
    cur = [cands[0]]
    for c in cands[1:]:
        if c["y"] - cur[-1]["y"] < vgap:
            cur.append(c)
        else:
            if len(cur) >= 2:
                groups.append(cur)
            cur = [c]
    if len(cur) >= 2:
        groups.append(cur)
    if groups:
        return [c["text"] for c in max(groups, key=len)]
    return []


def extract_axes_detailed(ocr: Optional[OCRResult]) -> Dict[str, Any]:
    """Zone-based axis label extraction (ref :1463-1510)."""
    axes: Dict[str, Any] = {"x_axis": {}, "y_axis": {}}
    if not ocr or not ocr.blocks:
        return axes
    boxes = [b["bbox"] for b in ocr.blocks]
    max_x = max(b[2] for b in boxes)
    max_y = max(b[3] for b in boxes)
    for b in ocr.blocks:
        text = (b.get("text") or "").strip()
        if not text or len(text) < 2:
            continue
        bbox = b["bbox"]
        x_mid = (bbox[0] + bbox[2]) / 2
        y_mid = (bbox[1] + bbox[3]) / 2
        valid = not _PURE_NUMERIC.match(text) and len(text) > 3
        if y_mid > 0.85 * max_y and valid:
            cur = axes["x_axis"].get("label", "")
            if len(text) > len(cur):
                axes["x_axis"]["label"] = text
        if x_mid < 0.15 * max_x and valid:
            cur = axes["y_axis"].get("label", "")
            if len(text) > len(cur):
                axes["y_axis"]["label"] = text
    return axes


_VALUE_RE = re.compile(r"([€£¥$]?\s*-?\d+(?:[.,]\d+)?(?:[KMBkmb])?)\s*(%|€|£|¥|\$)?")
_MULT = {"K": 1e3, "k": 1e3, "M": 1e6, "m": 1e6, "B": 1e9, "b": 1e9}


def extract_value_ranges(ocr: Optional[OCRResult]) -> Dict[str, Any]:
    """Currency/multiplier-aware numeric range (ref :1512-1544)."""
    ranges: Dict[str, Any] = {}
    if not ocr or not ocr.raw_text:
        return ranges
    numbers: List[float] = []
    for b in ocr.blocks:
        for m in _VALUE_RE.finditer(b.get("text") or ""):
            raw = m.group(1)
            for ch in ",$€£¥ ":
                raw = raw.replace(ch, "")
            if not raw:
                continue
            mult = 1.0
            if raw[-1] in _MULT:
                mult = _MULT[raw[-1]]
                raw = raw[:-1]
            try:
                numbers.append(float(raw) * mult)
            except ValueError:
                continue
    if numbers:
        ranges["detected"] = (min(numbers), max(numbers))
        ranges["count"] = len(numbers)
    return ranges


def extract_tick_labels(ocr: Optional[OCRResult]) -> Dict[str, List[str]]:
    """Zone-based tick label split (ref :1619-1654)."""
    ticks: Dict[str, List[str]] = {"x_axis": [], "y_axis": []}
    if not ocr or not ocr.blocks:
        return ticks
    boxes = [b["bbox"] for b in ocr.blocks]
    max_x = max(b[2] for b in boxes)
    max_y = max(b[3] for b in boxes)
    for b in ocr.blocks:
        text = (b.get("text") or "").strip()
        if not text or len(text) > 20:
            continue
        bbox = b["bbox"]
        x_mid = (bbox[0] + bbox[2]) / 2
        y_mid = (bbox[1] + bbox[3]) / 2
        if y_mid > 0.8 * max_y and 0.1 < x_mid / max_x < 0.9:
            ticks["x_axis"].append(text)
        elif (x_mid < 0.15 * max_x or x_mid > 0.85 * max_x) and 0.1 < y_mid / max_y < 0.9:
            if _PURE_NUMERIC_KMB.match(text):
                ticks["y_axis"].append(text)
    return ticks


def extract_nodes(ocr: Optional[OCRResult], cap: int = 50) -> List[Dict[str, Any]]:
    """Diagram node candidates from OCR blocks (ref :1676-1693)."""
    nodes: List[Dict[str, Any]] = []
    if not ocr or not ocr.blocks:
        return nodes
    for i, b in enumerate(ocr.blocks):
        text = (b.get("text") or "").strip()
        if 3 < len(text) < 100:
            nodes.append({"id": f"node_{i}", "text": text, "bbox": b.get("bbox", [])})
    return nodes[:cap]


def node_texts(blocks: List[Dict]) -> List[str]:
    """(ref :1310-1318)"""
    out = []
    for b in blocks:
        t = (b.get("text") or "").strip()
        if 3 < len(t) < 50:
            out.append(t)
    return out


def detect_legend(text: str) -> List[str]:
    """Simple line-based legend candidates (ref :1244-1253) — superseded by
    detect_legend_advanced but kept for API parity."""
    items = []
    for line in (text or "").split("\n"):
        clean = line.strip()
        if 3 < len(clean) < 40 and not re.match(r"^[\d\-/.,\s%$]+$", clean):
            items.append(clean)
    return items[:10]
