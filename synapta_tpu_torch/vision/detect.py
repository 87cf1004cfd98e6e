"""Two-pass region detection engine.

Pass 1 — caption-driven (ref pdf_image_segmentation.py:3148-3509): find true
caption blocks, then locate the visual above each via four prioritized
boundary signals (vector drawings > embedded images > whitespace gap > text
structure > conservative fallback).

Pass 2 — embedded-image extraction with additive validation scoring
(ref :2851-2998), nearby-caption rescue, and bbox expansion.

Conflicts between passes resolve by evidence scoring (ref :3020-3103).
A drawing-cluster pass (dead code in the reference's live path, :3511-3618)
is available behind ``DetectionConfig.use_drawing_detection``.

All geometry comes from the native ingest engine's page metadata; pixel
statistics (variance) come from decoded embedded images — page pixels are
touched only when a detected region is rendered.
"""
from __future__ import annotations

import io
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from synapta_tpu_torch.config import DetectionConfig
from synapta_tpu_torch.io.ingest import Document
from synapta_tpu_torch.schema import BoundingBox
from synapta_tpu_torch.vision import captions as cap


@dataclass
class DetectedRegion:
    """A candidate visual region on one page (pre-OCR, pre-classification)."""

    bbox: BoundingBox
    page_num: int                      # 0-based
    extraction_method: str             # caption_based | embedded_image | drawing_cluster
    caption_text: Optional[str] = None
    figure_number: Optional[str] = None
    reference_keys: List[str] = field(default_factory=list)
    confidence: float = 0.9
    notes: str = ""
    image_obj: Optional[int] = None    # PDF object number for embedded images
    variance: Optional[float] = None   # gray variance of embedded pixels
    content_digest: Optional[str] = None  # raw-pixel md5-8, stamped by loader


class DetectionEngine:
    def __init__(self, doc: Document, cfg: DetectionConfig = DetectionConfig(),
                 pixels_doc: Optional[Document] = None):
        self.doc = doc
        self.cfg = cfg
        # Handle used for embedded-pixel decodes (variance validation).
        # Pointing this at the RENDER handle lets the native document-
        # level decoded-image cache warm for the region rasterizations
        # that follow detection (each embedded JPEG otherwise decodes
        # 3x per region: validate + fitted-DPI render + 150-DPI render).
        # Safe because detect and render run sequentially in the same
        # prepare thread; defaults to `doc` for standalone use.
        self.pixels_doc = pixels_doc or doc

    # ------------------------------------------------------------------ api

    def detect_page(self, page_num: int) -> List[DetectedRegion]:
        """Two-pass detection with conflict resolution (ref :2763-2849)."""
        page_w, page_h = self.doc.page_size(page_num)
        regions = self._detect_by_captions(page_num, page_w, page_h)
        embedded = self._extract_embedded_validated(page_num, page_w, page_h)
        for cand in embedded:
            conflict = self._find_conflict(cand, regions)
            if conflict is not None:
                keep_embedded, reason = self._resolve_conflict(cand, conflict, page_num)
                if keep_embedded:
                    regions.remove(conflict)
                    regions.append(cand)
            else:
                regions.append(cand)
        if self.cfg.use_drawing_detection:
            for dr in self._detect_by_drawings(page_num, page_w, page_h):
                if not any(
                    self._overlap_ratio(dr.bbox, r.bbox) > self.cfg.conflict_overlap_ratio
                    for r in regions
                ):
                    regions.append(dr)
        return regions

    def render_region(self, page_num: int, bbox: BoundingBox,
                      dpi: Optional[float] = None) -> Tuple[np.ndarray, bytes]:
        """Rasterize a region and encode PNG (ref _render_region :3638-3657)."""
        dpi = dpi or self.cfg.render_dpi
        arr = self.doc.render(page_num, dpi=dpi,
                              clip=[bbox.x0, bbox.y0, bbox.x1, bbox.y1])
        from PIL import Image

        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format="PNG")
        return arr, bio.getvalue()

    # -------------------------------------------------------------- pass 1

    def _detect_by_captions(self, page_num: int, page_w: float,
                            page_h: float) -> List[DetectedRegion]:
        cfg = self.cfg
        blocks = self.doc.page_text_blocks(page_num)
        caption_blocks = []
        for b in blocks:
            text = (b.get("text") or "").strip()
            if not text:
                continue
            m = cap.match_caption(text)
            if m and cap.is_true_caption(
                text, m, cfg.caption_match_max_offset, cfg.caption_max_length
            ):
                caption_blocks.append({"text": text, "bbox": b["bbox"], "match": m})

        out: List[DetectedRegion] = []
        for cb in caption_blocks:
            cbb = cb["bbox"]
            y_start = max(0.0, cbb[1] - cfg.caption_search_height)
            y_end = cbb[1]
            others = [
                o["bbox"] for o in caption_blocks
                if o is not cb
                and abs(o["bbox"][1] - cbb[1]) < cfg.caption_search_height
            ]
            visual = self._find_visual_content_above(
                page_num, y_start, y_end, cbb, page_w, page_h,
                other_captions=others,
            )
            if visual is None:
                continue
            bbox = BoundingBox(
                x0=min(visual.x0, cbb[0]),
                y0=visual.y0,
                x1=max(visual.x1, cbb[2]),
                y1=cbb[3] + cfg.caption_pad,
                page_width=page_w,
                page_height=page_h,
            )
            region = DetectedRegion(
                bbox=bbox,
                page_num=page_num,
                extraction_method="caption_based",
                caption_text=cb["text"],
                confidence=0.9,
                notes=f"Detected via caption: {cb['text'][:50]}",
            )
            m = cb["match"]
            region.figure_number = m.group(1)
            region.reference_keys = cap.reference_keys_for(m.group(1))
            out.append(region)
        return out

    def _find_visual_content_above(
        self, page_num: int, y_start: float, y_end: float,
        caption_bbox: List[float], page_w: float, page_h: float,
        other_captions: Optional[List[List[float]]] = None,
    ) -> Optional[BoundingBox]:
        """Four-signal boundary search (ref :3256-3320), with one
        deliberate improvement: when SEVERAL captions share the search
        band (side-by-side figures), each drawing/image/text block belongs
        to the caption NEAREST its horizontal center — the reference
        unioned every drawing in the vertical band (ref :3274), merging
        side-by-side figures into one fat box. Single-caption pages keep
        the reference's take-everything semantics."""

        def h_dist(bb, cap) -> float:
            cx = 0.5 * (bb[0] + bb[2])
            if cap[0] <= cx <= cap[2]:
                return 0.0
            return min(abs(cx - cap[0]), abs(cx - cap[2]))

        def h_ok(bb) -> bool:
            if not other_captions:
                return True
            mine = h_dist(bb, caption_bbox)
            return all(mine <= h_dist(bb, o) for o in other_captions)

        drawings = [
            d["bbox"]
            for d in self.doc.page_drawings(page_num)
            if y_start <= d["bbox"][1] < y_end and h_ok(d["bbox"])
        ]
        drawing_bounds = self._union(drawings) if drawings else None

        images = [
            im["bbox"]
            for im in self.doc.page_images(page_num)
            if y_start <= im["bbox"][1] < y_end and h_ok(im["bbox"])
        ]
        image_bounds = self._union(images) if images else None

        # one band filter shared by the three text-signal scans below —
        # they each applied the identical y-window to the full block list
        # (three passes per caption; profiled on the 1000-page bench)
        band_blocks = [
            b for b in self.doc.page_text_blocks(page_num)
            if y_start <= b["bbox"][1] < y_end
        ]
        ws_boundary = self._find_whitespace_boundary(
            page_num, y_start, y_end, band_blocks
        )
        text_boundary = self._find_text_boundary(
            page_num, y_start, y_end, page_w, band_blocks
        )
        figure_text = [
            bb
            for bb in self._figure_text_blocks(page_num, y_start, y_end,
                                               page_w, band_blocks)
            if h_ok(bb)
        ]
        return self._combine_signals(
            drawing_bounds, image_bounds, ws_boundary, text_boundary,
            caption_bbox, page_w, page_h, y_start, figure_text,
        )

    def _figure_text_blocks(self, page_num: int, y_start: float, y_end: float,
                            page_w: float,
                            band_blocks=None) -> List[List[float]]:
        """Non-body text blocks in the search band — in-figure labels
        (legends, ticks, node text) that must not be clipped off."""
        cfg = self.cfg
        if band_blocks is None:
            band_blocks = [
                b for b in self.doc.page_text_blocks(page_num)
                if y_start <= b["bbox"][1] < y_end
            ]
        out = []
        for b in band_blocks:
            bb = b["bbox"]
            text = (b.get("text") or "").strip()
            is_body = (
                bb[2] - bb[0] > page_w * cfg.body_text_width_frac
                and len(text) > cfg.body_text_min_chars
            )
            # heading-sized text is never an in-figure label: chapter/
            # section titles above a figure otherwise get absorbed by the
            # fixpoint widening, bloating the box over the heading line
            # (same font threshold the heading-path extractor uses)
            is_heading = b.get("size", 0.0) > cfg.figure_text_max_font
            if not is_body and not is_heading:
                out.append(bb)
        return out

    @staticmethod
    def _union(rects: List[List[float]]) -> Tuple[float, float, float, float]:
        return (
            min(r[0] for r in rects),
            min(r[1] for r in rects),
            max(r[2] for r in rects),
            max(r[3] for r in rects),
        )

    def _find_whitespace_boundary(self, page_num: int, y_start: float,
                                  y_end: float,
                                  band_blocks=None) -> Optional[float]:
        """Largest vertical text gap in the search band (ref :3322-3363).
        Returns the y where the visual likely begins."""
        cfg = self.cfg
        if band_blocks is None:
            band_blocks = [
                b for b in self.doc.page_text_blocks(page_num)
                if y_start <= b["bbox"][1] < y_end
            ]
        rows = [
            {"top": b["bbox"][1], "bottom": b["bbox"][3]}
            for b in band_blocks
        ]
        if not rows:
            return None
        rows.sort(key=lambda r: r["bottom"])
        largest, pos = 0.0, None
        for a, b in zip(rows, rows[1:]):
            gap = b["top"] - a["bottom"]
            if gap > largest and gap > cfg.whitespace_min_region:
                largest, pos = gap, a["bottom"]
        if pos is not None and largest > cfg.whitespace_min_gap:
            return pos + 5.0
        return None

    def _find_text_boundary(
        self, page_num: int, y_start: float, y_end: float, page_w: float,
        band_blocks=None,
    ) -> Optional[Tuple[Optional[float], float, Optional[float]]]:
        """Body-paragraph vs figure-label analysis (ref :3365-3424).
        Returns (x0, y_top, x1) with None for unconstrained axes."""
        cfg = self.cfg
        if band_blocks is None:
            band_blocks = [
                b for b in self.doc.page_text_blocks(page_num)
                if y_start <= b["bbox"][1] < y_end
            ]
        body, figure_text = [], []
        for b in band_blocks:
            bb = b["bbox"]
            text = (b.get("text") or "").strip()
            width = bb[2] - bb[0]
            height = bb[3] - bb[1]
            is_body = (
                width > page_w * cfg.body_text_width_frac
                and len(text) > cfg.body_text_min_chars
                and height > cfg.body_text_min_height
                and bb[0] < page_w * cfg.body_text_left_margin_frac
            )
            (body if is_body else figure_text).append(bb)
        if not body:
            return None
        last_bottom = max(b[3] for b in body)
        y_top = last_bottom + 20.0
        if figure_text:
            return (
                min(b[0] for b in figure_text),
                y_top,
                max(b[2] for b in figure_text),
            )
        return (None, y_top, None)

    def _combine_signals(
        self,
        drawing_bounds, image_bounds, ws_y, text_boundary,
        caption_bbox, page_w, page_h, y_start, figure_text=None,
    ) -> Optional[BoundingBox]:
        """Priority merge (ref :3426-3509), with one deliberate improvement:
        drawing/image bounds extend horizontally over in-figure text blocks
        (legends, tick labels) that vertically overlap the visual — the
        reference's drawings-only bounds clip legend text that extends past
        the last vector path."""
        def boxed(x0, y0, x1, y1, min_w, min_h, max_h=None):
            if x1 - x0 > min_w and y1 - y0 > min_h and (
                max_h is None or (y1 - y0) < max_h
            ):
                return BoundingBox(x0, y0, x1, y1, page_w, page_h)
            return None

        def widen(x0, y0, x1, y1):
            """Extend drawing/image bounds over in-figure text, to
            FIXPOINT. Lateral: blocks that vertically overlap the visual
            (legends, ticks). Above/below: blocks within 25pt of the
            visual's top/bottom edge and horizontally overlapping it (axis
            titles, chart headings, x-tick labels) — the drawings-only
            bound otherwise clips them. Iterated because each absorbed
            block can bring the next into range (tick labels pull the box
            left, which brings the y-axis title's x-range inside)."""
            for _ in range(3):
                changed = False
                for tb in figure_text or []:
                    nx0, ny0, nx1, ny1 = x0, y0, x1, y1
                    overlap = min(y1, tb[3]) - max(y0, tb[1])
                    near_x = tb[2] >= x0 - 25 and tb[0] <= x1 + 25
                    if overlap > 0.5 * (tb[3] - tb[1]) and near_x:
                        nx0 = min(nx0, tb[0])
                        nx1 = max(nx1, tb[2])
                    x_inside = min(x1, tb[2]) - max(x0, tb[0])
                    if x_inside > 0 and -2.0 <= y0 - tb[3] <= 25.0:
                        ny0 = min(ny0, tb[1])
                        nx0 = min(nx0, tb[0])
                        nx1 = max(nx1, tb[2])
                    if x_inside > 0 and -2.0 <= tb[1] - y1 <= 25.0:
                        ny1 = max(ny1, tb[3])
                        nx0 = min(nx0, tb[0])
                        nx1 = max(nx1, tb[2])
                    if (nx0, ny0, nx1, ny1) != (x0, y0, x1, y1):
                        x0, y0, x1, y1 = nx0, ny0, nx1, ny1
                        changed = True
                if not changed:
                    break
            return x0, y0, x1, y1

        if drawing_bounds:
            x0, y0, x1, y1 = drawing_bounds
            # the whitespace boundary may only TRIM decoration near the
            # top of the drawing union (header rules etc.) — clamping
            # deeper would cut into figures whose in-figure text leaves a
            # large internal gap (legend at top, tick labels at bottom)
            if (
                ws_y is not None
                and y0 < ws_y <= y0 + 0.25 * max(y1 - y0, 1.0)
            ):
                y0 = ws_y
            x0, y0, x1, y1 = widen(x0, y0, x1, y1)
            b = boxed(
                max(0.0, x0 - 10), max(y_start, y0 - 10),
                min(page_w, x1 + 10), min(caption_bbox[1] - 5, y1 + 10),
                50, 50,
            )
            if b:
                return b
        if image_bounds:
            x0, y0, x1, y1 = image_bounds
            # same top-25% cap as the drawings branch: the whitespace
            # boundary may only trim decoration, never cut into a figure
            # of stacked images with an internal gap
            if (
                ws_y is not None
                and y0 < ws_y <= y0 + 0.25 * max(y1 - y0, 1.0)
            ):
                y0 = ws_y
            x0, y0, x1, y1 = widen(x0, y0, x1, y1)
            b = boxed(
                max(0.0, x0 - 5), max(y_start, y0 - 5),
                min(page_w, x1 + 5), min(caption_bbox[1] - 5, y1 + 5),
                50, 50,
            )
            if b:
                return b
        if ws_y is not None:
            b = boxed(
                max(0.0, caption_bbox[0] - 30), ws_y,
                min(page_w, caption_bbox[2] + 30), caption_bbox[1] - 10,
                80, 60,
            )
            if b:
                return b
        if text_boundary:
            tx0, ty, tx1 = text_boundary
            b = boxed(
                tx0 if tx0 is not None else max(0.0, caption_bbox[0] - 30),
                ty,
                tx1 if tx1 is not None else min(page_w, caption_bbox[2] + 30),
                caption_bbox[1] - 10,
                80, 60,
            )
            if b:
                return b
        # conservative fallback (ref :3496-3507)
        return boxed(
            max(0.0, caption_bbox[0] - 20),
            max(y_start, caption_bbox[1] - self.cfg.fallback_region_height),
            min(page_w, caption_bbox[2] + 20),
            caption_bbox[1] - 10,
            100, 80, max_h=500,
        )

    # -------------------------------------------------------------- pass 2

    def _extract_embedded_validated(self, page_num: int, page_w: float,
                                    page_h: float) -> List[DetectedRegion]:
        cfg = self.cfg
        out: List[DetectedRegion] = []
        for im in self.doc.page_images(page_num):
            bb = im["bbox"]
            bbox = BoundingBox(bb[0], bb[1], bb[2], bb[3], page_w, page_h)
            pixels = (
                self.pixels_doc.decode_image(im["obj"]) if im["obj"] else None
            )
            if pixels is None:
                continue
            score, notes, variance = self._validate_embedded(
                pixels, bbox, page_num, page_h
            )
            if score < cfg.embed_keep_threshold:
                continue
            caption_text = self._find_caption_near_bbox(page_num, bbox)
            if caption_text:
                for block in self.doc.page_text_blocks(page_num):
                    if caption_text[:30] in (block.get("text") or ""):
                        cb = block["bbox"]
                        bbox = BoundingBox(
                            x0=min(bbox.x0, cb[0]),
                            y0=bbox.y0,
                            x1=max(bbox.x1, cb[2]),
                            y1=max(bbox.y1, cb[3]),
                            page_width=page_w,
                            page_height=page_h,
                        )
                        break
            out.append(
                DetectedRegion(
                    bbox=bbox,
                    page_num=page_num,
                    extraction_method="embedded_image",
                    caption_text=caption_text,
                    confidence=score,
                    notes=f"Validation: {notes}",
                    image_obj=im["obj"],
                    variance=variance,
                )
            )
        return out

    def _validate_embedded(
        self, pixels: np.ndarray, bbox: BoundingBox, page_num: int, page_h: float
    ) -> Tuple[float, str, float]:
        """Additive validation scoring (ref :2933-2998). The note strings are
        part of the output schema (they appear in `notes`) and match the
        reference's vocabulary."""
        cfg = self.cfg
        score = 0.0
        notes: List[str] = []
        h_px, w_px = pixels.shape[:2]
        # variance from a stride-2 SUBSAMPLE: an unbiased sample of the
        # same pixel distribution (unlike a downscale, which averages and
        # shifts variance), 4x less float work — full-page scans made the
        # float temporaries here a measured host hot spot
        sub = pixels[::2, ::2] if h_px > 64 and w_px > 64 else pixels
        gray = (
            0.299 * sub[..., 0].astype(np.float32)
            + 0.587 * sub[..., 1].astype(np.float32)
            + 0.114 * sub[..., 2].astype(np.float32)
        )
        variance = float(np.var(gray))

        area = bbox.area()
        if area < cfg.embed_min_area:
            return 0.0, "too_small", variance
        if area > cfg.embed_good_area:
            score += 0.3
            notes.append("good_size")
        else:
            score += 0.1
            notes.append("moderate_size")
        if w_px < cfg.embed_min_dim or h_px < cfg.embed_min_dim:
            return 0.0, "tiny_dimensions", variance
        if w_px > cfg.embed_good_dim and h_px > cfg.embed_good_dim:
            score += 0.2
            notes.append("substantial_dimensions")
        aspect = w_px / h_px if h_px else 1.0
        if cfg.embed_aspect_range[0] < aspect < cfg.embed_aspect_range[1]:
            score += 0.2
            notes.append("good_aspect_ratio")
        else:
            score -= 0.1
            notes.append("unusual_aspect_ratio")
        y_pos = bbox.y0 / page_h if page_h else 0.5
        if y_pos < cfg.embed_margin_frac or y_pos > 1 - cfg.embed_margin_frac:
            score -= 0.2
            notes.append("likely_header_footer")
        else:
            score += 0.1
            notes.append("good_position")
        if self._find_caption_near_bbox(page_num, bbox):
            score += 0.4
            notes.append("has_caption")
        if variance < cfg.embed_low_variance:
            score -= 0.3
            notes.append("low_variance")
        elif variance > cfg.embed_high_variance:
            score += 0.2
            notes.append("good_content_variance")
        return min(score, 1.0), ", ".join(notes), variance

    def _find_caption_near_bbox(self, page_num: int,
                                bbox: BoundingBox) -> Optional[str]:
        """(ref :3000-3018)"""
        cfg = self.cfg
        for block in self.doc.page_text_blocks(page_num):
            bb = block["bbox"]
            vdist = bb[1] - bbox.y1
            overlap = min(bbox.x1, bb[2]) - max(bbox.x0, bb[0])
            if 0 <= vdist <= cfg.embed_caption_search_below and overlap > 0:
                text = block.get("text") or ""
                if cap.match_caption(text):
                    return text
        return None

    # ------------------------------------------------------- conflict logic

    @staticmethod
    def _overlap_ratio(a: BoundingBox, b: BoundingBox) -> float:
        """Overlap over the smaller box (ref :3029-3039)."""
        inter = a.intersect_area(b)
        smaller = min(a.area(), b.area())
        return inter / smaller if smaller > 0 else 0.0

    def _find_conflict(self, cand: DetectedRegion,
                       existing: List[DetectedRegion]) -> Optional[DetectedRegion]:
        for seg in existing:
            if self._overlap_ratio(cand.bbox, seg.bbox) > self.cfg.conflict_overlap_ratio:
                return seg
        return None

    def _resolve_conflict(
        self, embedded: DetectedRegion, caption_based: DetectedRegion, page_num: int
    ) -> Tuple[bool, str]:
        """Evidence scoring (ref :3041-3103). Returns (keep_embedded, reason)."""
        cfg = self.cfg
        reasons: List[str] = []
        e_score = c_score = 0
        if caption_based.caption_text:
            c_score += 3
            reasons.append("caption_based has caption")
        e_area, c_area = embedded.bbox.area(), caption_based.bbox.area()
        if c_area > e_area * cfg.conflict_area_ratio:
            c_score += 2
            reasons.append("caption_based includes more context")
        elif e_area > c_area * cfg.conflict_area_ratio:
            e_score += 1
            reasons.append("embedded is larger")
        if embedded.variance is not None and embedded.variance > cfg.conflict_photo_variance:
            e_score += 2
            reasons.append("embedded is photo-like (raster)")
        n_drawings = sum(
            1
            for d in self.doc.page_drawings(page_num)
            if caption_based.bbox.x0 <= d["bbox"][0] <= caption_based.bbox.x1
            and caption_based.bbox.y0 <= d["bbox"][1] <= caption_based.bbox.y1
        )
        if n_drawings > cfg.conflict_min_drawings:
            c_score += 2
            reasons.append("many vector drawings (chart/diagram)")
        if embedded.confidence > cfg.conflict_embed_score:
            e_score += 1
            reasons.append(f"embedded has high validation ({embedded.confidence:.2f})")
        return (c_score <= e_score), "; ".join(reasons)

    # ------------------------------------------ drawing clusters (optional)

    def _detect_by_drawings(self, page_num: int, page_w: float,
                            page_h: float) -> List[DetectedRegion]:
        """Drawing-cluster detection (ref :3511-3618 — dead in the ref's
        live path; optional here for caption-less vector figures)."""
        cfg = self.cfg
        rects = [d["bbox"] for d in self.doc.page_drawings(page_num)]
        clusters: List[List[List[float]]] = []
        for r in rects:
            placed = False
            for cl in clusters:
                if any(self._rect_distance(r, o) < cfg.drawing_cluster_distance for o in cl):
                    cl.append(r)
                    placed = True
                    break
            if not placed:
                clusters.append([r])
        out = []
        for cl in clusters:
            if len(cl) < cfg.drawing_cluster_min:
                continue
            x0, y0, x1, y1 = self._union(cl)
            area = (x1 - x0) * (y1 - y0)
            if area < cfg.drawing_min_area or area > cfg.drawing_max_page_frac * page_w * page_h:
                continue
            out.append(
                DetectedRegion(
                    bbox=BoundingBox(x0, y0, x1, y1, page_w, page_h),
                    page_num=page_num,
                    extraction_method="drawing_cluster",
                    confidence=0.6,
                    notes=f"Drawing cluster of {len(cl)} paths",
                )
            )
        return out

    @staticmethod
    def _rect_distance(a: List[float], b: List[float]) -> float:
        dx = max(0.0, max(a[0], b[0]) - min(a[2], b[2]))
        dy = max(0.0, max(a[1], b[1]) - min(a[3], b[3]))
        return (dx * dx + dy * dy) ** 0.5
