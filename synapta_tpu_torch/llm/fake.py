"""Deterministic fake vision-LLM for hermetic tests (the seam the reference
implicitly exposes via its fallback paths, SURVEY.md §4)."""
from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np

from synapta_tpu_torch.llm.pixtral import fallback_analysis
from synapta_tpu_torch.schema import MermaidRepresentation, OCRResult, VisualType


class FakePixtralClient:
    """Classifies from a hint function or canned responses; never touches
    the network. API-compatible with PixtralClient."""

    def __init__(self, responses: Optional[list] = None, hint_fn=None,
                 enabled: bool = True):
        self.responses = list(responses or [])
        self.hint_fn = hint_fn
        self._enabled = enabled
        self.calls: list = []
        self.stats = {"calls": 0, "failures": 0, "retries": 0}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def analyze_comprehensive(self, pixels: np.ndarray,
                              ocr: Optional[OCRResult]) -> Dict[str, Any]:
        self.calls.append(("comprehensive", pixels.shape))
        self.stats["calls"] += 1
        if self.responses:
            return self.responses.pop(0)
        if self.hint_fn:
            return self.hint_fn(pixels, ocr)
        return {
            "visual_type": VisualType.FIGURE,
            "confidence": 0.9,
            "metadata": {},
            "summary": "Fake analysis of the visual element.",
            "summary_confidence": 0.9,
            "method": "mistral_vision_comprehensive",
        }

    def extract_mermaid(self, pixels, visual_type, ocr):
        self.calls.append(("mermaid", visual_type))
        if visual_type not in (VisualType.DIAGRAM, VisualType.FLOWCHART):
            return None
        return MermaidRepresentation(
            mermaid_code="flowchart TD\n    A[Start] --> B{Decision}",
            diagram_type="flowchart",
            extraction_confidence=0.75,
            extraction_notes="Extracted via Mistral vision model",
        )

    def extract_calculations(self, pixels, ocr, nearby):
        self.calls.append(("calculations", None))
        return {
            "input_variables": [
                {"variable": "r", "value": "4.5", "unit": "%"}
            ],
            "output_values": [
                {"output_name": "PV", "value": "100.0", "location": "row 3"}
            ],
            "calculation_verification": {
                "verified": True, "matches": True, "differences": [],
            },
        }

    def _wrap(self, value) -> Future:
        f: Future = Future()
        f.set_result(value)
        return f

    def submit_comprehensive(self, pixels, ocr) -> Future:
        return self._wrap(self.analyze_comprehensive(pixels, ocr))

    def submit_mermaid(self, pixels, visual_type, ocr) -> Future:
        return self._wrap(self.extract_mermaid(pixels, visual_type, ocr))

    def submit_calculations(self, pixels, ocr, nearby) -> Future:
        return self._wrap(self.extract_calculations(pixels, ocr, nearby))

    def shutdown(self) -> None:
        pass


class DisabledClient(FakePixtralClient):
    """No-API-key behavior: every comprehensive call returns the reference's
    fallback analysis (ref :701-715)."""

    def __init__(self):
        super().__init__(enabled=False)

    def analyze_comprehensive(self, pixels, ocr):
        self.stats["calls"] += 1
        return fallback_analysis()

    def extract_mermaid(self, pixels, visual_type, ocr):
        return None

    def extract_calculations(self, pixels, ocr, nearby):
        return {
            "input_variables": [],
            "output_values": [],
            "calculation_verification": None,
        }
