"""Caption detection: figure-number patterns + proximity search
(ref pdf_image_segmentation.py:1043-1080)."""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from synapta_tpu_torch.schema import BoundingBox

CAPTION_PATTERNS = [
    r"Figure\s+(\d+(?:\.\d+)?)\s*[:\-]?\s*(.*?)(?=\n\n|\Z)",
    r"Fig\.\s+(\d+(?:\.\d+)?)\s*[:\-]?\s*(.*?)(?=\n\n|\Z)",
    r"Exhibit\s+(\d+(?:\.\d+)?)\s*[:\-]?\s*(.*?)(?=\n\n|\Z)",
    r"Chart\s+(\d+(?:\.\d+)?)\s*[:\-]?\s*(.*?)(?=\n\n|\Z)",
    r"Diagram\s+(\d+(?:\.\d+)?)\s*[:\-]?\s*(.*?)(?=\n\n|\Z)",
]

# Phrases marking in-text references rather than real captions (ref :3189-3197)
REFERENCE_PHRASES = [
    r"\bas shown in\b",
    r"\bsee figure\b",
    r"\bin figure\b",
    r"\brefer to\b",
    r"\baccording to\b",
    r"\bas illustrated in\b",
    r"\bas depicted in\b",
]

# Precompiled once: match_caption runs on EVERY text block of every page
# (detection pass 1), and re.search's per-call flag handling profiled at
# ~0.3 ms/page on the 1-core bench host.
_CAPTION_RES = [
    re.compile(p, re.IGNORECASE | re.DOTALL) for p in CAPTION_PATTERNS
]
_REFERENCE_RES = [re.compile(p) for p in REFERENCE_PHRASES]


def match_caption(text: str) -> Optional[re.Match]:
    for pattern in _CAPTION_RES:
        m = pattern.search(text)
        if m:
            return m
    return None


def is_true_caption(text: str, match: re.Match,
                    max_offset: int = 20, max_length: int = 400) -> bool:
    """Caption-vs-reference gate (ref :3178-3215): match near block start,
    no reference phrasing, short block."""
    if match.start() >= max_offset:
        return False
    low = text.lower()
    if any(p.search(low) for p in _REFERENCE_RES):
        return False
    return len(text) < max_length


def detect_caption(
    text_blocks: List[Dict],
    bbox: BoundingBox,
    proximity: float = 50.0,
) -> Tuple[Optional[str], Optional[str]]:
    """Find (figure_number, caption_text) near a visual's bbox
    (ref :1054-1080): considers blocks within ``proximity`` pts above the
    top or below the bottom edge."""
    candidates = []
    for block in text_blocks:
        bb = block.get("bbox", [0, 0, 0, 0])
        text = (block.get("text") or "").strip()
        if not text:
            continue
        if abs(bb[1] - bbox.y1) < proximity or abs(bbox.y0 - bb[3]) < proximity:
            candidates.append(text)
    combined = " ".join(candidates)
    m = match_caption(combined)
    if m:
        figure_number = m.group(1)
        caption = m.group(2).strip() if len(m.groups()) > 1 else ""
        return figure_number, caption
    if combined:
        return None, combined[:200]
    return None, None


def reference_keys_for(figure_number: str) -> List[str]:
    """(ref :2807-2811)"""
    return [
        f"Figure {figure_number}",
        f"Fig. {figure_number}",
        f"Fig {figure_number}",
    ]
