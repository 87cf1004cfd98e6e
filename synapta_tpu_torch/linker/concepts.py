"""Concept linker: 5-signal scoring against a taxonomy.

Behavior-compatible rebuild of the reference ConceptLinker
(ref pdf_image_segmentation.py:1840-2690): exact phrase (30) + cosine TF-IDF
(30) + weighted term overlap (25) + fuzzy (10) + context bonus (5), a
generic-single-term gate, and name-dedup keeping the lowest Bloom level.

Performance redesign (SURVEY.md §7.6): the reference re-parses every concept
name and rebuilds both TF-IDF vectors for every (segment, concept) pair;
here everything concept-side is precomputed once — parsed aliases, compiled
whole-phrase regexes, and an L2-ready TF-IDF matrix over a fixed vocabulary —
so scoring one segment against N concepts is one numpy matvec for cosine,
one sparse overlap pass, and short-circuited fuzzy with a pair cache.
"""
from __future__ import annotations

import math
import re
from difflib import SequenceMatcher
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

from synapta_tpu_torch.config import LinkerConfig

STOP_WORDS = {
    "the", "and", "for", "with", "from", "this", "that",
    "are", "was", "were", "been", "have", "has", "had",
    "will", "would", "could", "should", "may", "might",
    "can", "about", "into", "through", "over", "under",
}

_ACRONYM_RE = re.compile(r"[A-Za-z][A-Za-z0-9\-]{1,15}s?$")
_ACRONYM_SCORE_RE = re.compile(r"[a-z]{2,10}(-[a-z]{1,10})?s?$")


def normalize_text(text: str) -> str:
    """(ref :2041-2048)"""
    if not text:
        return ""
    t = str(text).lower().strip()
    t = t.replace("–", "-").replace("—", "-")
    return re.sub(r"\s+", " ", t)


def extract_terms(text: str) -> Set[str]:
    """Lowercase, strip punctuation, split (incl. hyphen parts), drop stop
    words and short tokens (ref :2003-2039)."""
    if not text:
        return set()
    text = re.sub(r"[^\w\s-]", " ", text.lower().strip())
    terms: Set[str] = set()
    for word in text.split():
        word = word.strip("-_")
        if len(word) >= 3 and word not in STOP_WORDS:
            terms.add(word)
        if "-" in word:
            for part in word.split("-"):
                part = part.strip("-_")
                if len(part) >= 3 and part not in STOP_WORDS:
                    terms.add(part)
    return terms


def parse_concept_name(name: str) -> Dict[str, Any]:
    """Parentheticals -> aliases/acronyms + hyphen variants + the t-bill /
    LIBOR expansions (ref :1923-1980)."""
    if not name:
        return {"main": "", "acronyms": set(), "aliases": set()}
    text = str(name).strip()
    acronyms: Set[str] = set()
    aliases: Set[str] = set()
    for p in re.findall(r"\(([^)]+)\)", text):
        p = p.strip()
        if p:
            aliases.add(p)
            if _ACRONYM_RE.fullmatch(p):
                acronyms.add(p.lower())
    main = re.sub(r"\s*\([^)]*\)\s*", " ", text).strip()
    if _ACRONYM_RE.fullmatch(main):
        acronyms.add(main.lower())
    variants: Set[str] = set()
    for a in list(aliases) + [main]:
        a = (a or "").strip()
        if not a:
            continue
        variants.add(a)
        variants.add(a.replace("-", " "))
        variants.add(re.sub(r"\s+", " ", a))
    aliases |= variants
    joined = " ".join([main.lower()] + [x.lower() for x in aliases])
    if "t-bill" in joined:
        aliases |= {
            "treasury bill", "treasury bills", "treasury-bill",
            "treasury-bills", "t bill", "t bills",
        }
        acronyms |= {"t-bill", "t-bills"}
    if "libor" in joined:
        aliases |= {"london interbank offer rate", "london interbank offered rate"}
        acronyms |= {"libor"}
    acronyms = {normalize_text(a) for a in acronyms if a}
    return {"main": main, "acronyms": acronyms, "aliases": aliases}


def _phrase_regex(needle: str) -> re.Pattern:
    """Whole-phrase, hyphen<->space tolerant (ref :2391-2400)."""
    escaped = re.escape(needle).replace(r"\-", r"[-\s]")
    return re.compile(rf"(?<!\w){escaped}(?!\w)", re.IGNORECASE)


def generate_concept_id(name: str, index: int) -> str:
    """(ref :2083-2092)"""
    n = re.sub(r"[^\w\s-]", "", name.lower().strip())
    n = re.sub(r"[-\s]+", "_", n)[:50]
    return f"concept_{n}_{index:03d}"


class _Concept:
    __slots__ = (
        "concept_id", "name", "bloom_level", "tag", "pages",
        "primary_terms", "context_terms", "all_terms", "aliases", "acronyms",
        "exact_candidates", "main_terms", "vec_idx", "vec_val", "norm",
    )


class ConceptLinker:
    def __init__(self, taxonomy_rows: Sequence[Dict[str, Any]],
                 cfg: LinkerConfig = LinkerConfig()):
        """taxonomy_rows: dicts with Level / Concept / Tag(s) / Page(s) keys
        (from io.xlsx.read_taxonomy)."""
        self.cfg = cfg
        self.concepts: List[_Concept] = []
        self.term_frequencies: Dict[str, int] = {}
        self.term_in_multiword: Dict[str, int] = {}
        self._fuzzy_cache: Dict[tuple, float] = {}

        for idx, row in enumerate(taxonomy_rows):
            name = (row.get("Concept") or "").strip()
            if not name:
                continue
            c = _Concept()
            c.concept_id = generate_concept_id(name, idx)
            c.name = name
            c.bloom_level = _coerce_level(row.get("Level", ""))
            c.tag = row.get("Tag(s)", "") or ""
            c.pages = row.get("Page(s)", "") or ""
            parsed = parse_concept_name(name)
            c.primary_terms = extract_terms(parsed["main"])
            c.acronyms = parsed["acronyms"]
            c.aliases = parsed["aliases"]
            c.main_terms = sorted(c.primary_terms)
            all_terms = set(c.primary_terms) | set(parsed["acronyms"])
            for alias in parsed["aliases"]:
                all_terms |= extract_terms(alias)
            c.context_terms = extract_terms(str(c.tag)) if c.tag else set()
            all_terms |= c.context_terms
            c.all_terms = all_terms
            # precompiled exact-match candidates with their score tier
            cands = {name, parsed["main"]} | parsed["aliases"] | parsed["acronyms"]
            c.exact_candidates = []
            for cand in cands:
                cn = normalize_text(cand)
                if not cn:
                    continue
                strong = len(cn.split()) >= 2 or bool(_ACRONYM_SCORE_RE.fullmatch(cn))
                c.exact_candidates.append(
                    (_phrase_regex(cn), 1.0 if strong else cfg.single_word_exact_frac, cn)
                )
            self.concepts.append(c)

        # term statistics (ref :1982-2001)
        for c in self.concepts:
            for t in c.all_terms:
                self.term_frequencies[t] = self.term_frequencies.get(t, 0) + 1
            if len(c.primary_terms) >= 2:
                for t in c.primary_terms:
                    self.term_in_multiword[t] = self.term_in_multiword.get(t, 0) + 1
        self.document_count = len(self.concepts)

        # dense TF-IDF matrix over the concept vocabulary
        vocab = sorted(
            {t for c in self.concepts for t in (c.primary_terms | c.context_terms)}
        )
        self.vocab_index = {t: i for i, t in enumerate(vocab)}
        self._idf = np.array(
            [self.idf(t) for t in vocab], np.float64
        )
        mat = np.zeros((len(self.concepts), len(vocab)), np.float64)
        for ci, c in enumerate(self.concepts):
            counts: Dict[str, float] = {}
            for t in c.primary_terms:
                counts[t] = counts.get(t, 0.0) + cfg.concept_primary_weight
            for t in c.context_terms:
                counts[t] = counts.get(t, 0.0) + cfg.concept_context_weight
            total = sum(counts.values())
            for t, cnt in counts.items():
                mat[ci, self.vocab_index[t]] = (cnt / total) * self.idf(t) if total else 0.0
        self._concept_mat = mat
        self._concept_norms = np.linalg.norm(mat, axis=1)

    # ------------------------------------------------------------- helpers

    def idf(self, term: str) -> float:
        """Smoothed IDF (ref :2572-2583)."""
        df = self.term_frequencies.get(term, 1)
        return math.log((self.document_count + 1) / (df + 1)) + 1.0

    def is_generic_single_term(self, term: str) -> bool:
        """(ref :2050-2072)"""
        term = normalize_text(term)
        if not term or self.document_count <= 0:
            return False
        df = self.term_frequencies.get(term, 0)
        if self.term_in_multiword.get(term, 0) >= 1 and df >= 2:
            return True
        if df < self.cfg.generic_min_df:
            return False
        return (df / self.document_count) >= self.cfg.generic_df_ratio

    # ------------------------------------------------------------ scoring

    def link_concepts(self, segment) -> List[Dict[str, Any]]:
        """Score all concepts against a VisualSegment (ref :2094-2171)."""
        ctx = self._build_search_context(segment)
        return self.link_context(ctx)

    def link_context(self, ctx: Dict[str, str]) -> List[Dict[str, Any]]:
        cfg = self.cfg
        combined_norm = normalize_text(ctx["combined_text"])
        search_terms = extract_terms(ctx["combined_text"])
        search_words = sorted(set(
            re.findall(r"[a-z0-9]+(?:-[a-z0-9]+)?", combined_norm)
        ))
        caption_norm = normalize_text(ctx.get("caption", ""))
        caption_low = ctx.get("caption", "").lower()
        summary_low = ctx.get("summary", "").lower()
        nearby_low = ctx.get("nearby", "").lower()

        # vectorized cosine over all concepts
        svec = self._search_vector(ctx)
        if svec is not None:
            dots = self._concept_mat @ svec["dense"]
            denom = self._concept_norms * svec["norm"]
            cosines = np.divide(
                dots, denom, out=np.zeros_like(dots), where=denom > 0
            )
            np.clip(cosines, 0.0, 1.0, out=cosines)
        else:
            cosines = np.zeros(len(self.concepts))

        matches: List[Dict[str, Any]] = []
        for ci, c in enumerate(self.concepts):
            if self._gate_generic(c, caption_norm, combined_norm):
                continue
            details = {
                "exact_phrase": self._score_exact(c, combined_norm) * cfg.exact_weight,
                "cosine_similarity": float(cosines[ci]) * cfg.cosine_weight,
                "term_overlap": self._score_overlap(search_terms, c) * cfg.overlap_weight,
                "fuzzy_match": self._score_fuzzy(c, search_words) * cfg.fuzzy_weight,
                "context_bonus": self._score_context(
                    c, caption_low, summary_low, nearby_low
                ) * cfg.context_weight,
            }
            total = min(sum(details.values()) / 100.0, 1.0)
            if total > cfg.score_threshold:
                method_map = {
                    "exact_phrase": "exact_phrase_match",
                    "cosine_similarity": "cosine_similarity",
                    "term_overlap": "term_overlap",
                    "fuzzy_match": "fuzzy_match",
                    "context_bonus": "context_match",
                }
                best_signal = max(details, key=lambda k: details[k])
                matches.append(
                    {
                        "concept_id": c.concept_id,
                        "concept_name": c.name,
                        "bloom_level": c.bloom_level,
                        "tag": c.tag,
                        "pages": c.pages,
                        "confidence": total,
                        "match_method": method_map[best_signal],
                        "match_details": details,
                    }
                )
        matches.sort(key=lambda m: m["confidence"], reverse=True)
        # dedup by name keeping lowest bloom level (ref :2139-2163)
        dedup: Dict[str, Dict] = {}
        for m in matches:
            prev = dedup.get(m["concept_name"])
            if prev is None:
                dedup[m["concept_name"]] = m
            elif _level_key(m["bloom_level"]) < _level_key(prev["bloom_level"]):
                dedup[m["concept_name"]] = m
            elif (
                _level_key(m["bloom_level"]) == _level_key(prev["bloom_level"])
                and m["confidence"] > prev["confidence"]
            ):
                dedup[m["concept_name"]] = m
        out = sorted(dedup.values(), key=lambda m: m["confidence"], reverse=True)
        return out

    # ------------------------------------------------------ signal pieces

    def _build_search_context(self, segment) -> Dict[str, str]:
        """(ref :2173-2209)"""
        ctx = {
            "caption": segment.caption_text or "",
            "summary": segment.summary or "",
            "ocr": segment.ocr_result.raw_text if segment.ocr_result else "",
            "nearby": segment.nearby_text or "",
        }
        ctx["combined_text"] = " ".join(v for v in
                                        (ctx["caption"], ctx["summary"],
                                         ctx["ocr"], ctx["nearby"]) if v)
        return ctx

    def _search_vector(self, ctx: Dict[str, str]):
        """Weighted search TF-IDF (ref :2490-2541). Dense over the concept
        vocab for the dot product; the norm includes out-of-vocab terms,
        matching the reference's full-vector norm."""
        cfg = self.cfg
        counts: Dict[str, float] = {}
        for field_name, weight in zip(
            ("caption", "summary", "ocr", "nearby"), cfg.context_weights
        ):
            text = ctx.get(field_name, "")
            if text:
                for t in extract_terms(text):
                    counts[t] = counts.get(t, 0.0) + weight
        total = sum(counts.values())
        if total <= 0:
            return None
        dense = np.zeros(len(self.vocab_index), np.float64)
        sq = 0.0
        for t, cnt in counts.items():
            v = (cnt / total) * self.idf(t)
            sq += v * v
            i = self.vocab_index.get(t)
            if i is not None:
                dense[i] = v
        return {"dense": dense, "norm": math.sqrt(sq)}

    def _gate_generic(self, c: _Concept, caption_norm: str,
                      combined_norm: str) -> bool:
        """(ref :2301-2349)"""
        if len(c.primary_terms) >= 2:
            return False
        only = next(iter(c.primary_terms), "")
        if not only or not self.is_generic_single_term(only):
            return False
        if caption_norm and len(caption_norm) <= 80:
            if re.match(rf"^{re.escape(only)}(\b|[\s:\-])", caption_norm, re.IGNORECASE):
                return False
        for a in c.acronyms:
            if a != only and a and _phrase_regex(a).search(combined_norm):
                return False
        for alias in c.aliases:
            an = normalize_text(alias)
            if an != only and an and _phrase_regex(an).search(combined_norm):
                return False
        return True

    def _score_exact(self, c: _Concept, text_norm: str) -> float:
        """(ref :2351-2389)"""
        if not text_norm:
            return 0.0
        best = 0.0
        for rx, tier, _ in c.exact_candidates:
            if tier > best and rx.search(text_norm):
                best = tier
                if best >= 1.0:
                    break
        return best

    def _score_overlap(self, search_terms: Set[str], c: _Concept) -> float:
        """(ref :2402-2443)"""
        if not search_terms or not c.all_terms:
            return 0.0
        score = 0.0
        for t in search_terms & c.primary_terms:
            score += 1.0 * self.idf(t)
        for t in search_terms & (c.all_terms - c.primary_terms):
            score += 0.5 * self.idf(t)
        max_score = sum(self.idf(t) for t in c.primary_terms)
        return min(score / max_score, 1.0) if max_score > 0 else 0.0

    def _similarity(self, a: str, b: str) -> float:
        if a == b:
            return 1.0
        # ratio >= 0.88 needs length agreement within ~13%
        la, lb = len(a), len(b)
        if min(la, lb) * 2.0 / (la + lb) < 0.80:
            return 0.0
        key = (a, b)
        v = self._fuzzy_cache.get(key)
        if v is None:
            v = SequenceMatcher(None, a, b).ratio()
            self._fuzzy_cache[key] = v
        return v

    def _score_fuzzy(self, c: _Concept, words: List[str]) -> float:
        """(ref :2585-2650)"""
        if not words:
            return 0.0
        if len(c.main_terms) == 1 and self.is_generic_single_term(c.main_terms[0]):
            return 0.0
        best = 0.0
        thresh = self.cfg.fuzzy_token_sim
        for ac in c.acronyms:
            if not ac:
                continue
            for w in words:
                sim = self._similarity(ac, w)
                if sim >= thresh:
                    best = max(best, sim)
        term_hits = 0
        for t in c.main_terms:
            tn = t.replace("-", "")
            local = 0.0
            for w in words:
                local = max(local, self._similarity(tn, w.replace("-", "")))
                if local >= thresh:
                    break
            if local >= thresh:
                term_hits += 1
        if len(c.main_terms) >= 2 and term_hits >= self.cfg.fuzzy_min_hits:
            best = max(best, 0.9)
        elif len(c.main_terms) == 1 and term_hits == 1:
            best = max(best, 0.82)
        return best if best >= 0.8 else 0.0

    def _score_context(self, c: _Concept, caption: str, summary: str,
                       nearby: str) -> float:
        """(ref :2666-2690)"""
        name = c.name.lower()
        score = 0.0
        if name in caption:
            score += self.cfg.context_bonus_caption
        if name in summary:
            score += self.cfg.context_bonus_summary
        if name in nearby:
            score += self.cfg.context_bonus_nearby
        return min(score, 1.0)


def _coerce_level(v: Any) -> Any:
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except (TypeError, ValueError):
        return v if v is not None else ""


def _level_key(v: Any):
    try:
        return (0, float(v))
    except (TypeError, ValueError):
        return (1, str(v))


def load_linker(taxonomy_path: str, cfg: LinkerConfig = LinkerConfig()) -> ConceptLinker:
    from synapta_tpu_torch.io.xlsx import read_taxonomy

    return ConceptLinker(read_taxonomy(taxonomy_path), cfg)
