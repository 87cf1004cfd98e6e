"""Plain scoring of written segments against the generator's truth: text
normalisation, the Levenshtein distance (Hyyrö's bit-parallel form of
Myers' algorithm, equal to the textbook dynamic programme) and box IoU."""
from __future__ import annotations

import re


def norm_text(s: str) -> str:
    return re.sub(r"\s+", " ", (s or "").strip().lower())


def levenshtein(a: str, b: str) -> int:
    """Edit distance between ``a`` and ``b`` (insertions, deletions and
    substitutions cost 1)."""
    m = len(a)
    if m == 0:
        return len(b)
    peq = {}
    for i, ch in enumerate(a):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    full = (1 << m) - 1
    top = 1 << (m - 1)
    pv, mv, score = full, 0, m
    for ch in b:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = ((((eq & pv) + pv) ^ pv) | eq) & full
        ph = (mv | ~(xh | pv)) & full
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = (mh | ~(xv | ph)) & full
        mv = ph & xv
    return score


def cer(ref: str, hyp: str) -> float:
    """Character error rate of ``hyp`` against ``ref``."""
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


def iou(a, b) -> float:
    """IoU of two [x0, y0, x1, y1] boxes."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
            - inter)
    return inter / area if area > 0 else 0.0
