"""Structured logging + pipeline counters (the reference had 52 bare prints;
SURVEY.md §5 asks for structured logging and throughput counters)."""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"synapta.{name}")
    if not logging.getLogger("synapta").handlers:
        root = logging.getLogger("synapta")
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        root.addHandler(h)
        root.setLevel(os.environ.get("SYNAPTA_LOG_LEVEL", "INFO"))
        root.propagate = False
    return logger


@dataclass
class PipelineStats:
    pages: int = 0
    regions: int = 0
    segments: int = 0
    ocr_blocks: int = 0
    llm_analyses: int = 0
    concept_links: int = 0
    llm_patches: int = 0     # late-LLM responses applied to written segments
    llm_unpatched: int = 0   # patches still in flight at shutdown
    llm_drain_wait_s: float = 0.0  # tail wait for in-flight LLM patches
    errors: int = 0          # swallowed per-batch/per-segment failures
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["pages_per_s"] = self.pages / self.wall_s if self.wall_s else 0.0
        return d
