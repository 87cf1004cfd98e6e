"""Batch-of-books orchestration: a resumable queue over many PDFs.

The reference processes one book per script invocation (ref
pdf_image_segmentation.py:3959-3976). Production deployments segment
whole shelves: this module runs N books through ONE process with shared
device state (recognizer weights load + compile once; executables are
reused across books), a durable manifest for crash-resume at book
granularity, and structured progress events.

    python -m synapta_tpu_torch.serve --books a.pdf b.pdf --output-root out/
    python -m synapta_tpu_torch.serve --books-dir shelf/ --output-root out/

Every book's pipeline runs on ``--device`` (``BookQueue.device``; default
``cuda``, which fails without a GPU; ``cpu`` runs the kernels' plain
PyTorch twins).

Outputs per book land in ``<output_root>/<book_id>/`` with the standard
``{book_id}_visual_segments.json`` / ``_visual_summary.csv`` / PNGs.
``<output_root>/queue_manifest.json`` records per-book status; re-running
the same command skips completed books (and the per-segment JSONL resume
inside the pipeline handles mid-book crashes).
``<output_root>/queue_events.jsonl`` is an append-only event stream
(book_started / book_done / book_failed with stats) for monitoring.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from synapta_tpu_torch.config import PipelineConfig
from synapta_tpu_torch.utils.log import get_logger

log = get_logger("serve")


@dataclass
class BookJob:
    pdf_path: str
    book_id: str
    taxonomy_path: Optional[str] = None
    password: str = ""
    status: str = "pending"        # pending | done | failed
    pages: int = 0
    segments: int = 0
    errors: int = 0
    wall_s: float = 0.0
    error_msg: str = ""


@dataclass
class BookQueue:
    output_root: str
    config: PipelineConfig = field(default_factory=PipelineConfig)
    llm_client: object = None      # shared fake/real client (None = per-book)
    device: str = "cuda"           # torch device of every book's pipeline
    jobs: List[BookJob] = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.output_root, exist_ok=True)
        self._manifest_path = os.path.join(
            self.output_root, "queue_manifest.json"
        )
        self._events_path = os.path.join(
            self.output_root, "queue_events.jsonl"
        )
        self._ocr = None           # shared TorchOCR across books

    # ------------------------------------------------------------ queue ops

    def add(self, pdf_path: str, book_id: Optional[str] = None,
            taxonomy_path: Optional[str] = None, password: str = "") -> BookJob:
        if book_id is None:
            book_id = os.path.splitext(os.path.basename(pdf_path))[0]
        job = BookJob(pdf_path=pdf_path, book_id=book_id,
                      taxonomy_path=taxonomy_path, password=password)
        self.jobs.append(job)
        return job

    def _load_manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            try:
                with open(self._manifest_path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass
        return {"books": {}}

    def _save_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)

    def _emit(self, event: str, job: BookJob, **extra) -> None:
        rec = {
            "ts": round(time.time(), 3),
            "event": event,
            "book_id": job.book_id,
            "pdf_path": job.pdf_path,
            **extra,
        }
        with open(self._events_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------ run

    def _book_done(self, manifest: dict, job: BookJob) -> bool:
        """A book is complete when the manifest says so AND its final
        outputs exist (a deleted output dir forces a re-run)."""
        rec = manifest["books"].get(job.book_id)
        if not rec or rec.get("status") != "done":
            return False
        out_dir = os.path.join(self.output_root, job.book_id)
        return os.path.exists(
            os.path.join(out_dir, f"{job.book_id}_visual_segments.json")
        )

    def run(self) -> dict:
        """Process every queued book; returns the final manifest dict."""
        from synapta_tpu_torch.pipeline import VisualSegmentationPipeline

        manifest = self._load_manifest()
        for job in self.jobs:
            if self._book_done(manifest, job):
                job.status = "done"
                log.info("skip %s: already complete", job.book_id)
                continue
            out_dir = os.path.join(self.output_root, job.book_id)
            self._emit("book_started", job)
            t0 = time.time()
            try:
                cfg = self.config.replace(pdf_password=job.password)
                pipe = VisualSegmentationPipeline(
                    book_id=job.book_id,
                    pdf_path=job.pdf_path,
                    taxonomy_path=job.taxonomy_path,
                    output_dir=out_dir,
                    config=cfg,
                    llm_client=self.llm_client,
                    ocr=self._ocr,
                    resume=True,
                    device=self.device,
                )
                segs = pipe.process()
                # share the (weights-loaded, executable-warm) OCR stack
                # with every later book
                self._ocr = pipe.ocr
                pipe.close()
                job.status = "done"
                job.pages = pipe.stats.pages
                job.segments = len(segs)
                job.errors = pipe.stats.errors
                job.wall_s = round(time.time() - t0, 2)
                self._emit("book_done", job, pages=job.pages,
                           segments=job.segments, errors=job.errors,
                           wall_s=job.wall_s)
            except Exception as e:  # noqa: BLE001 — queue must survive a bad book
                job.status = "failed"
                job.error_msg = f"{type(e).__name__}: {e}"
                job.wall_s = round(time.time() - t0, 2)
                log.exception("book %s failed", job.book_id)
                self._emit("book_failed", job, error=job.error_msg,
                           wall_s=job.wall_s)
            manifest["books"][job.book_id] = {
                "status": job.status,
                "pdf_path": job.pdf_path,
                "pages": job.pages,
                "segments": job.segments,
                "errors": job.errors,
                "wall_s": job.wall_s,
                "error": job.error_msg,
            }
            self._save_manifest(manifest)
        return manifest


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Resumable multi-book segmentation queue"
    )
    ap.add_argument("--books", nargs="*", default=[], help="PDF paths")
    ap.add_argument("--books-dir", default=None,
                    help="process every *.pdf in this directory")
    ap.add_argument("--output-root", required=True)
    ap.add_argument("--taxonomy", default=None)
    ap.add_argument("--password", default="")
    ap.add_argument("--no-llm", action="store_true")
    ap.add_argument("--pages-per-batch", type=int, default=None,
                help="pages per super-batch (default: config's tuned value)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if argv is None:
        # the native PDF engine needs libjpeg.so.62; re-exec with Pillow's
        # copy where the system has none
        from synapta_tpu_torch.hostlibs import ensure_native_engine

        ensure_native_engine(["-m", "synapta_tpu_torch.serve", *sys.argv[1:]])

    books = list(args.books)
    if args.books_dir:
        books += sorted(
            os.path.join(args.books_dir, f)
            for f in os.listdir(args.books_dir)
            if f.lower().endswith(".pdf")
        )
    if not books:
        ap.error("no books given (--books or --books-dir)")

    cfg = PipelineConfig(
        use_vision_llm=not args.no_llm,
        **({"pages_per_batch": args.pages_per_batch}
           if args.pages_per_batch else {}),
    )
    from synapta_tpu_torch.llm.fake import DisabledClient

    q = BookQueue(
        output_root=args.output_root,
        config=cfg,
        llm_client=DisabledClient() if args.no_llm else None,
        device=args.device,
    )
    for b in books:
        q.add(b, taxonomy_path=args.taxonomy, password=args.password)
    manifest = q.run()
    done = sum(1 for r in manifest["books"].values() if r["status"] == "done")
    print(json.dumps({"books": len(manifest["books"]), "done": done}))
    return 0 if done == len(manifest["books"]) else 1


if __name__ == "__main__":
    sys.exit(main())
