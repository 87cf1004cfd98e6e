"""Output writers: visual_segments.json, visual_summary.csv, segment PNGs.

Byte-compatible with the reference writers
(``reference/pdf_image_segmentation.py:3852-3952``): final JSON is
``{book_id, pdf_path, total_segments, segments[]}`` serialized with
``indent=2, ensure_ascii=False``; the CSV has the reference's 9 columns with
confidence pre-formatted to two decimals.

Unlike the reference — which re-reads and rewrites the *entire* JSON after
every segment (O(n^2) I/O, ref :3866-3898) — incremental progress goes to an
append-only ``.segments.jsonl`` sidecar that doubles as the checkpoint/resume
log; the canonical JSON is compacted once at the end (and at checkpoints).
Segment ids stay content-hashed (ref :3777-3783) so resume is idempotent.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

from synapta_tpu_torch.schema import VisualSegment

CSV_COLUMNS = [
    "segment_id",
    "page",
    "type",
    "confidence",
    "figure_number",
    "caption",
    "ocr_text",
    "linked_concepts",
    "summary",
]


def segment_id_for(book_id: str, page_num: int, image_bytes: bytes) -> str:
    """Deterministic content-hash id ``{book}_p{page:03d}_{md5-8}``.

    ``page_num`` is the 0-based page index (the JSON ``page_no`` field is
    1-based; the id keeps the 0-based index — ref :3783 vs golden sample
    ``page_no: 1`` / id ``..._p000_...``).
    """
    return f"{book_id}_p{page_num:03d}_{hashlib.md5(image_bytes).hexdigest()[:8]}"


def segment_id_for_region(book_id: str, region, png: bytes) -> str:
    """Content-hash id for a prepared region, preferring the RAW-PIXEL
    digest the loader stamps on it (``region.content_digest``).

    Hashing the encoded PNG made ids depend on the encoder: when the
    native encoder gained palettization the bytes changed for identical
    pixels, so a resume re-added every previously-checkpointed segment
    under a new id. The raw render is what the id is semantically about;
    the PNG-bytes path remains only as a fallback for regions prepared
    without a digest.

    Digest scheme history: md5[:8] originally, crc32 hex since round 3
    (8x faster, same 32-bit strength and 8-hex shape, ref :3783). The
    schemes collide on nothing, so resuming a book checkpointed under
    the OLD scheme re-processes every segment once and keeps both
    records — start such upgrades with ``resume=False`` (or a fresh
    output dir) to avoid duplicated segments in the compacted JSON."""
    digest = getattr(region, "content_digest", None)
    if digest:
        return f"{book_id}_p{region.page_num:03d}_{digest}"
    return segment_id_for(book_id, region.page_num, png)


class ResultsWriter:
    """Owns all pipeline outputs for one book run."""

    def __init__(self, book_id: str, pdf_path: str, output_dir: str):
        self.book_id = book_id
        self.pdf_path = pdf_path
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.json_path = self.output_dir / f"{book_id}_visual_segments.json"
        self.csv_path = self.output_dir / f"{book_id}_visual_summary.csv"
        self.jsonl_path = self.output_dir / f".{book_id}_segments.jsonl"
        self._seen_ids: set[str] = set()
        self._dicts: List[Dict[str, Any]] = []
        # persistent append handle + batched fsync: per-segment
        # open/fsync cost ~5ms each on the bench book (profiled). Appends
        # flush to the OS on every write; fsync happens every
        # _SYNC_EVERY appends and at finalize. A crash loses at most the
        # un-synced tail — load_checkpoint already tolerates torn tails,
        # and resume re-derives the lost segments from their pages.
        self._f = None
        self._unsynced = 0

    _SYNC_EVERY = 64

    def _log_write(self, d: Dict[str, Any], sync: bool = False) -> None:
        if self._f is None:
            self._f = open(self.jsonl_path, "a", encoding="utf-8")
        self._f.write(json.dumps(d, ensure_ascii=False) + "\n")
        self._f.flush()
        self._unsynced += 1
        if sync or self._unsynced >= self._SYNC_EVERY:
            os.fsync(self._f.fileno())
            self._unsynced = 0

    def close_log(self) -> None:
        if self._f is not None:
            if self._unsynced:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._unsynced = 0
            self._f.close()
            self._f = None

    # ---- resume -----------------------------------------------------------

    def load_checkpoint(self) -> int:
        """Load previously written segments from the JSONL log (resume).

        Returns the number of recovered segments."""
        if not self.jsonl_path.exists():
            return 0
        recovered = 0
        with open(self.jsonl_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a crash
                sid = d.get("segment_id")
                if sid and sid not in self._seen_ids:
                    self._seen_ids.add(sid)
                    self._dicts.append(d)
                    recovered += 1
        return recovered

    def has_segment(self, segment_id: str) -> bool:
        return segment_id in self._seen_ids

    # ---- writes -----------------------------------------------------------

    def initialize(self) -> None:
        """Write the empty JSON shell (ref :3852-3864)."""
        self._write_json()

    def append(self, segment: VisualSegment) -> bool:
        """Durably record one finished segment. Returns False on duplicate."""
        if segment.segment_id in self._seen_ids:
            return False
        d = segment.to_dict()
        self._seen_ids.add(segment.segment_id)
        self._dicts.append(d)
        self._log_write(d)
        return True

    def append_dict(self, d: Dict[str, Any]) -> bool:
        sid = d.get("segment_id")
        if sid is None or sid in self._seen_ids:
            return False
        self._seen_ids.add(sid)
        self._dicts.append(d)
        self._log_write(d)
        return True

    def update(self, segment: VisualSegment) -> None:
        """Replace an already-appended segment (e.g. after a late LLM
        response patches its analysis)."""
        d = segment.to_dict()
        for i, old in enumerate(self._dicts):
            if old.get("segment_id") == segment.segment_id:
                self._dicts[i] = d
                break
        else:
            self._seen_ids.add(segment.segment_id)
            self._dicts.append(d)
        self._log_write(d)

    def write_png(self, segment_id: str, png_bytes: bytes) -> str:
        path = self.output_dir / f"{segment_id}.png"
        with open(path, "wb") as f:
            f.write(png_bytes)
        return str(path)

    # ---- finalize ---------------------------------------------------------

    def _payload(self) -> Dict[str, Any]:
        return {
            "book_id": self.book_id,
            "pdf_path": self.pdf_path,
            "total_segments": len(self._dicts),
            "segments": self._dicts,
        }

    def _write_json(self) -> None:
        tmp = self.json_path.with_suffix(".json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._payload(), f, indent=2, ensure_ascii=False)
        os.replace(tmp, self.json_path)

    def finalize(self) -> None:
        """Compact JSONL into the canonical JSON + write the summary CSV
        (ref :3900-3952)."""
        self.close_log()
        self._write_json()
        self._write_csv()

    def _write_csv(self) -> None:
        import csv

        with open(self.csv_path, "w", encoding="utf-8", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(CSV_COLUMNS)
            for d in self._dicts:
                ocr = d.get("ocr_result") or {}
                w.writerow(
                    [
                        d.get("segment_id", ""),
                        d.get("page_no", ""),
                        d.get("segment_type", ""),
                        f"{float(d.get('classification_confidence') or 0.0):.2f}",
                        d.get("figure_number") or "",
                        (d.get("caption_text") or "")[:100],
                        (ocr.get("raw_text") or "")[:100],
                        len(d.get("linked_concept_ids") or []),
                        (d.get("summary") or "")[:100],
                    ]
                )

    @property
    def segments(self) -> List[Dict[str, Any]]:
        return list(self._dicts)
