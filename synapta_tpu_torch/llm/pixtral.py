"""Vision-LLM client (Mistral Pixtral) — async, batched, retried.

Rebuilds the reference MistralVisionAPI (ref pdf_image_segmentation.py:
298-1040) with the upgrades SURVEY.md §7.7 calls for: calls run through a
bounded thread pool off the pipeline's critical path, failures retry with
exponential backoff (the reference had none), and the calculation endpoint's
doubled-path bug (ref :1000 posts to base_url + "/chat/completions" where
base_url already ends in it) is fixed. Parsing, category mapping, confidence
capping, and fallback semantics are behavior-identical.

The API key comes from the environment only — the reference committed a
live key (ref :2707); we never will.
"""
from __future__ import annotations

import base64
import io
import json
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np

from synapta_tpu_torch.config import VisionLLMConfig
from synapta_tpu_torch.llm import prompts
from synapta_tpu_torch.schema import (
    ChartSpecificData,
    DiagramSpecificData,
    FigureSpecificData,
    ImageSpecificData,
    MermaidRepresentation,
    OCRResult,
    VisualType,
)

_CATEGORY_MAP = {
    "CHART": VisualType.CHART,
    "DIAGRAM": VisualType.DIAGRAM,
    "FLOWCHART": VisualType.FLOWCHART,
    "IMAGE": VisualType.IMAGE,
    "FIGURE": VisualType.FIGURE,
}


def fallback_analysis() -> Dict[str, Any]:
    """No-key / failure analysis (ref :701-715)."""
    return {
        "visual_type": VisualType.FIGURE,
        "confidence": 0.3,
        "metadata": {
            "definitions": [],
            "formulas": [],
            "variables": [],
            "tables": [],
        },
        "summary": "Visual element detected (classification unavailable)",
        "summary_confidence": 0.3,
        "method": "fallback_heuristic",
    }


def parse_comprehensive(content: str, cfg: VisionLLMConfig) -> Optional[Dict[str, Any]]:
    """Strip code fences and map the JSON reply (ref :641-686)."""
    content = content.strip()
    m = re.search(r"```json\s*(\{.*?\})\s*```", content, re.DOTALL)
    if m:
        content = m.group(1)
    elif "```" in content:
        content = re.sub(r"```\w*\s*", "", content).replace("```", "").strip()
    try:
        data = json.loads(content)
    except json.JSONDecodeError:
        return None
    classification = data.get("classification", {}) or {}
    category = str(classification.get("category", "FIGURE")).upper()
    visual_type = _CATEGORY_MAP.get(category, VisualType.FIGURE)
    try:
        confidence = float(classification.get("confidence", 0.7))
    except (TypeError, ValueError):
        confidence = 0.7
    summary = data.get("summary", {}) or {}
    try:
        summary_conf = float(summary.get("confidence", 0.8))
    except (TypeError, ValueError):
        summary_conf = 0.8
    return {
        "visual_type": visual_type,
        "confidence": min(confidence, cfg.confidence_cap),
        "metadata": data.get("metadata", {}) or {},
        "summary": summary.get("text", ""),
        "summary_confidence": summary_conf,
        "method": "mistral_vision_comprehensive",
    }


def convert_metadata(visual_type: VisualType, metadata: Dict) -> Tuple[
    Optional[ChartSpecificData],
    Optional[DiagramSpecificData],
    Optional[ImageSpecificData],
    Optional[FigureSpecificData],
]:
    """Metadata dict -> type payload dataclasses (ref :717-805)."""
    chart = diagram = image = figure = None
    if visual_type == VisualType.CHART:
        vr = metadata.get("value_range") or None
        chart = ChartSpecificData(
            chart_subtype=metadata.get("chart_subtype"),
            axes_info={
                "x_axis": {"label": metadata.get("x_axis_label")},
                "y_axis": {"label": metadata.get("y_axis_label")},
            },
            legend_items=metadata.get("legend_items") or [],
            series_count=metadata.get("data_series_count", 0) or 0,
            grid_detected=bool(metadata.get("has_grid", False)),
            value_ranges=(
                {"detected": (vr.get("min"), vr.get("max"))} if isinstance(vr, dict) else {}
            ),
        )
    elif visual_type in (VisualType.FLOWCHART, VisualType.DIAGRAM):
        subtype = (
            "flowchart"
            if visual_type == VisualType.FLOWCHART
            else metadata.get("diagram_subtype")
        )
        diagram = DiagramSpecificData(
            diagram_subtype=subtype,
            node_count=metadata.get("node_count", 0) or 0,
            has_decision_points=(metadata.get("decision_points", 0) or 0) > 0,
            hierarchy_detected=bool(metadata.get("has_hierarchy", False)),
            layout_type=metadata.get("layout_type"),
        )
    elif visual_type == VisualType.IMAGE:
        def as_list(key):
            v = metadata.get(key, [])
            return v if isinstance(v, list) else []

        image = ImageSpecificData(
            image_subtype=metadata.get("image_subtype"),
            contains_text=bool(metadata.get("contains_text", False)),
            text_density=metadata.get("text_density", "none") or "none",
            is_embedded_table=bool(metadata.get("is_embedded_table", False)),
            definitions=as_list("definitions"),
            formulas=as_list("formulas"),
            variables=as_list("variables"),
            tables=as_list("tables"),
            input_variables=as_list("input_variables"),
            output_values=as_list("output_values"),
            calculation_verification=metadata.get("calculation_verification"),
        )
    elif visual_type == VisualType.FIGURE:
        figure = FigureSpecificData(
            is_composite=bool(metadata.get("is_composite", False)),
            sub_figure_count=metadata.get("sub_figure_count", 0) or 0,
            contains_chart=bool(metadata.get("contains_chart", False)),
            contains_diagram=bool(metadata.get("contains_diagram", False)),
            contains_image=bool(metadata.get("contains_image", False)),
        )
    return chart, diagram, image, figure


def parse_mermaid(content: str, cfg: VisionLLMConfig) -> Optional[MermaidRepresentation]:
    """(ref :883-900)"""
    m = re.search(r"```mermaid\s*(.*?)\s*```", content, re.DOTALL)
    if not m:
        return None
    code = m.group(1).strip()
    diagram_type = "graph"
    head = code[:50]
    if "flowchart" in head:
        diagram_type = "flowchart"
    elif "sequenceDiagram" in head:
        diagram_type = "sequence"
    return MermaidRepresentation(
        mermaid_code=code,
        diagram_type=diagram_type,
        extraction_confidence=cfg.mermaid_confidence,
        extraction_notes="Extracted via Mistral vision model",
    )


def parse_calculations(content: str) -> Dict[str, Any]:
    """(ref :1018-1032)"""
    m = re.search(r"\{.*\}", content, re.DOTALL)
    empty = {
        "input_variables": [],
        "output_values": [],
        "calculation_verification": None,
    }
    if not m:
        return empty
    try:
        data = json.loads(m.group())
    except json.JSONDecodeError:
        return empty
    return {
        "input_variables": data.get("input_variables", []) or [],
        "output_values": data.get("output_values", []) or [],
        "calculation_verification": data.get("verification"),
    }


def encode_image_png(pixels: np.ndarray, max_dim: int = 1536) -> str:
    """RGB array -> base64 PNG, downscaled to keep request sizes sane."""
    from PIL import Image

    img = Image.fromarray(pixels)
    if max(img.size) > max_dim:
        scale = max_dim / max(img.size)
        img = img.resize(
            (max(1, int(img.width * scale)), max(1, int(img.height * scale)))
        )
    bio = io.BytesIO()
    img.save(bio, format="PNG")
    return base64.b64encode(bio.getvalue()).decode("ascii")


class PixtralClient:
    """Thread-pooled client; every analysis returns a Future so the pipeline
    keeps streaming while calls are in flight."""

    def __init__(self, cfg: VisionLLMConfig = VisionLLMConfig(),
                 api_key: Optional[str] = None):
        self.cfg = cfg
        self.api_key = api_key if api_key is not None else os.environ.get(
            "MISTRAL_API_KEY", ""
        )
        self._pool = ThreadPoolExecutor(max_workers=cfg.max_concurrent)
        self._lock = threading.Lock()
        self.stats = {"calls": 0, "failures": 0, "retries": 0}

    @property
    def enabled(self) -> bool:
        return bool(self.api_key)

    # ------------------------------------------------------------ plumbing

    def _post(self, payload: Dict, timeout: float) -> Optional[str]:
        import requests

        url = f"{self.cfg.base_url}/chat/completions"
        delay = 1.0
        for attempt in range(self.cfg.max_retries):
            try:
                with self._lock:
                    self.stats["calls"] += 1
                resp = requests.post(
                    url,
                    headers={
                        "Authorization": f"Bearer {self.api_key}",
                        "Content-Type": "application/json",
                    },
                    json=payload,
                    timeout=timeout,
                )
                if resp.status_code == 200:
                    return resp.json()["choices"][0]["message"]["content"]
                if resp.status_code in (429, 500, 502, 503, 504):
                    raise IOError(f"retryable status {resp.status_code}")
                return None  # permanent error
            except Exception:
                with self._lock:
                    self.stats["retries"] += 1
                if attempt == self.cfg.max_retries - 1:
                    with self._lock:
                        self.stats["failures"] += 1
                    return None
                import time

                time.sleep(delay)
                delay *= self.cfg.retry_backoff
        return None

    def _vision_payload(self, prompt: str, img_b64: str, max_tokens: int,
                        temperature: float) -> Dict:
        return {
            "model": self.cfg.model,
            "messages": [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": prompt},
                        {
                            "type": "image_url",
                            "image_url": f"data:image/png;base64,{img_b64}",
                        },
                    ],
                }
            ],
            "max_tokens": max_tokens,
            "temperature": temperature,
        }

    # ------------------------------------------------------------- calls

    def analyze_comprehensive(self, pixels: np.ndarray,
                              ocr: Optional[OCRResult]) -> Dict[str, Any]:
        """One call: classification + metadata + summary (ref :313-699)."""
        if not self.enabled:
            return fallback_analysis()
        prompt = prompts.comprehensive_prompt(ocr.raw_text if ocr else None)
        content = self._post(
            self._vision_payload(
                prompt,
                encode_image_png(pixels, self.cfg.max_image_dim),
                self.cfg.comprehensive_max_tokens,
                self.cfg.comprehensive_temperature,
            ),
            self.cfg.comprehensive_timeout,
        )
        if content:
            parsed = parse_comprehensive(content, self.cfg)
            if parsed:
                return parsed
        return fallback_analysis()

    def extract_mermaid(self, pixels: np.ndarray, visual_type: VisualType,
                        ocr: Optional[OCRResult]) -> Optional[MermaidRepresentation]:
        """Diagrams/flowcharts only (ref :807-907)."""
        if not self.enabled or visual_type not in (
            VisualType.DIAGRAM, VisualType.FLOWCHART
        ):
            return None
        kind = "flowchart" if visual_type == VisualType.FLOWCHART else "diagram"
        content = self._post(
            self._vision_payload(
                prompts.mermaid_prompt(kind, ocr.raw_text if ocr else None),
                encode_image_png(pixels, self.cfg.max_image_dim),
                self.cfg.mermaid_max_tokens,
                self.cfg.comprehensive_temperature,
            ),
            self.cfg.mermaid_timeout,
        )
        return parse_mermaid(content, self.cfg) if content else None

    def extract_calculations(self, pixels: np.ndarray, ocr: Optional[OCRResult],
                             nearby_text: Optional[str]) -> Dict[str, Any]:
        """IMAGE segments' second pass (ref :909-1040)."""
        if not self.enabled:
            return {
                "input_variables": [],
                "output_values": [],
                "calculation_verification": None,
            }
        content = self._post(
            self._vision_payload(
                prompts.calculations_prompt(
                    ocr.raw_text if ocr else None, nearby_text
                ),
                encode_image_png(pixels, self.cfg.max_image_dim),
                self.cfg.calc_max_tokens,
                self.cfg.calc_temperature,
            ),
            self.cfg.calc_timeout,
        )
        if content:
            return parse_calculations(content)
        return {
            "input_variables": [],
            "output_values": [],
            "calculation_verification": None,
        }

    # --------------------------------------------------------- async forms

    # Pixel lifetime contract: the pipeline snapshots ring-view pixels
    # once per segment BEFORE any submit (pipeline._snap_pixels), so the
    # arrays received here remain valid for deferred reads — no copies
    # needed in client implementations.

    def submit_comprehensive(self, pixels, ocr) -> Future:
        return self._pool.submit(self.analyze_comprehensive, pixels, ocr)

    def submit_mermaid(self, pixels, visual_type, ocr) -> Future:
        return self._pool.submit(self.extract_mermaid, pixels, visual_type, ocr)

    def submit_calculations(self, pixels, ocr, nearby) -> Future:
        return self._pool.submit(self.extract_calculations, pixels, ocr, nearby)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# old-algorithm variant calls (SURVEY.md §2.2): separate classify + summary
# ---------------------------------------------------------------------------


def _old_algo_methods():
    """Mixin-style attach to keep the class body above focused."""

    def classify_visual(self, pixels: np.ndarray,
                        ocr: Optional[OCRResult]):
        """Stand-alone classification call (old_algo :295-419, max_tokens
        300, temperature 0.1). Returns (VisualType, confidence, method)."""
        if not self.enabled:
            return VisualType.FIGURE, 0.3, "fallback_heuristic"
        content = self._post(
            self._vision_payload(
                prompts.classify_prompt(ocr.raw_text if ocr else None),
                encode_image_png(pixels, self.cfg.max_image_dim),
                300,
                0.1,
            ),
            self.cfg.mermaid_timeout,
        )
        if content:
            m = re.search(r"\{.*\}", content, re.DOTALL)
            if m:
                try:
                    data = json.loads(m.group())
                    category = str(data.get("category", "FIGURE")).upper()
                    conf = float(data.get("confidence", 0.7))
                    return (
                        _CATEGORY_MAP.get(category, VisualType.FIGURE),
                        min(conf, self.cfg.confidence_cap),
                        "mistral_vision",
                    )
                except (json.JSONDecodeError, TypeError, ValueError):
                    pass
        return VisualType.FIGURE, 0.3, "fallback_heuristic"

    def generate_summary(self, pixels: np.ndarray, visual_type: VisualType,
                         caption: Optional[str], ocr: Optional[OCRResult]):
        """Stand-alone type-aware summary call (old_algo :422-594,
        max_tokens 500, temperature 0.3, strips **bold** markdown).
        Returns (summary or None, confidence)."""
        if not self.enabled:
            return None, 0.0
        content = self._post(
            self._vision_payload(
                prompts.summary_prompt(
                    visual_type.value, caption, ocr.raw_text if ocr else None
                ),
                encode_image_png(pixels, self.cfg.max_image_dim),
                500,
                0.3,
            ),
            self.cfg.mermaid_timeout,
        )
        if content:
            summary = re.sub(r"\*\*.*?\*\*:?\s*", "", content.strip()).strip()
            return summary, 0.85
        return None, 0.0

    PixtralClient.classify_visual = classify_visual
    PixtralClient.generate_summary = generate_summary


_old_algo_methods()
