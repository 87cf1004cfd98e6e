"""Synthetic text-line generator for recognizer training.

Renders random textbook-like strings (financial vocabulary, numbers,
currencies, figure labels) with the same DejaVu font family our PDF
fixtures embed, normalized to the recognizer's (32, W) tile. Because the
deployment domain is *rendered* PDF rasters (not camera scans), synthetic
training data is distribution-matched by construction.
"""
from __future__ import annotations

import numpy as np

from synapta_tpu_torch.io.pdf_writer import DEJAVU, DEJAVU_BOLD
from synapta_tpu_torch.models import charset

DEJAVU_SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"
DEJAVU_MONO = "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf"

# Foreign-to-the-oracle fonts (VERDICT round-3 item 1a): the clean eval
# renders DejaVu through the spdf rasterizer and the scanned fixture
# renders DejaVu through PIL — training must also see glyph families
# NEITHER oracle uses, or accuracy numbers stay in-domain. STIX is a
# Times-like serif with full Greek/math coverage (matplotlib's mathtext
# font); the oblique/italic variants add slanted forms textbooks use for
# variables. Fonts are filtered by actual cmap coverage at load time so
# a missing glyph can never poison a label with a .notdef box.
_MPL_TTF = None


def _mpl_ttf_dir() -> str:
    global _MPL_TTF
    if _MPL_TTF is None:
        import os

        try:
            import matplotlib

            _MPL_TTF = os.path.join(
                matplotlib.get_data_path(), "fonts", "ttf"
            )
        except Exception:
            _MPL_TTF = ""
    return _MPL_TTF


def _candidate_fonts() -> list:
    import os

    d = _mpl_ttf_dir()
    extra = [
        os.path.join(d, n)
        for n in (
            "STIXGeneral.ttf", "STIXGeneralBol.ttf",
            "STIXGeneralItalic.ttf", "STIXGeneralBolIta.ttf",
            "DejaVuSans-Oblique.ttf", "DejaVuSerif-Italic.ttf",
        )
    ] if d else []
    return [DEJAVU, DEJAVU_BOLD, DEJAVU_SERIF, DEJAVU_MONO] + [
        p for p in extra if os.path.exists(p)
    ]


FONTS = _candidate_fonts()

# per-font set of charset codepoints the font actually covers
_COVERAGE = {}


def _coverage(path: str) -> set:
    if path not in _COVERAGE:
        try:
            from fontTools.ttLib import TTFont

            cmap = TTFont(path, fontNumber=0).getBestCmap()
            _COVERAGE[path] = {c for c in charset.CHARS if ord(c) in cmap}
        except Exception:
            _COVERAGE[path] = set(charset.CHARS)  # assume full (DejaVu is)
    return _COVERAGE[path]


def _pick_font(text: str, rng: np.random.Generator) -> str:
    """A random font that covers every char of `text` (DejaVu fallback)."""
    order = rng.permutation(len(FONTS))
    need = set(text)
    for i in order:
        if need <= _coverage(FONTS[i]):
            return FONTS[i]
    return DEJAVU

WORDS = (
    "the of portfolio return risk asset bond stock equity market value price "
    "rate interest yield option futures swap hedge capital income expected "
    "variance deviation correlation beta alpha index fund investor allocation "
    "weight diversification model theory figure exhibit chart table period "
    "quarter year annual growth dividend earnings ratio margin cost revenue "
    "cash flow discount present future net gross total average percent basis "
    "Start Screen Approve Execute Risk Check Assets Inputs Output Model "
    "Black-Scholes-Merton Binomial Quarterly Cumulative Performance Stocks "
    "Bonds Cash Alts Equities Year Return Time Value Price Amount Q1 Q2 Q3 Q4 "
    # full-alphabet coverage: the original vocabulary had NO lowercase
    # j/z and little q/x/v — the recognizer systematically confused
    # unseen letters (z->2, j->i on the scanned fixture). General prose
    # words covering every letter in common contexts:
    "maximizes subject objective adjust adjacent junior project zero zone "
    "horizon optimize size seize jazz quiz quote quickly require frequency "
    "exact excess example exchange taxes proxy vertex zigzag lazy dozen "
    "analyze utilize amortize organize equilibrium adjustment rejected "
    "majority journal judgment joint venture injection trajectory extra "
    "expenditure explicit voluntarily equivalent quantity qualified very "
    "leverage over every novel violation java objective offset suffix "
    "effective offer coefficient efficient different difference buffer"
).split()


_SOUP = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789.,;:()%$-+/"
)

# extended soup: Greek/math classes need raw gradient signal too —
# doubled so a uniform draw gives them comparable per-class frequency
_SOUP_EXT = _SOUP + 2 * (
    charset.GREEK_LOWER + charset.GREEK_UPPER
    + charset.MATH + charset.SUPERSCRIPTS
)

# finance-notation formula templates ({g}=greek var, {v}=value, {p}=pct):
# the line class the reference's PaddleOCR read natively ("βp = 1.2",
# ref :1088-1126) and round-3's charset could not even label
_FORMULAS = (
    "{g} = {v}",
    "{g}p = {v}",
    "{g} ≈ {p}%",
    "{g} ≥ {v}",
    "{g} ≤ {v}",
    "{g}² = {v}",
    "σ = √{v}",
    "σ² ≤ {v}",
    "E(rp) = rf + βp(E(rm) - rf)",
    "E(r) ≈ {p}%",
    "∑ wi = 1",
    "∑ wi ri = E(rp)",
    "Δ = ∂V/∂S",
    "Θ = ∂V/∂t",
    "Γ = ∂²V/∂S²",
    "ρ = σij/(σi × σj)",
    "√252 ≈ {v}",
    "μ ≠ {p}%",
    "α + β × rm",
    "x¹ + x² + x³",
    "½(a + b)",
    "∫ f(x) dx ≈ {v}",
    "∏(1 + rt)",
    "Π = S - K",
    "βi = σim/σm²",
    "λ ≥ 0, θ · x′",
    "Φ(d1) ≈ {v}",
    "Ψ = Ξ + Λ",
)
_GREEKS = "αβγδεθλμνπρστφχψωΔΣΩ"


def _formula(rng: np.random.Generator) -> str:
    t = _FORMULAS[rng.integers(0, len(_FORMULAS))]
    return (
        t.replace("{g}", _GREEKS[rng.integers(0, len(_GREEKS))])
        .replace("{v}", f"{rng.uniform(0, 30):.2f}")
        .replace("{p}", f"{rng.uniform(0, 25):.1f}")
    )


def random_text(rng: np.random.Generator) -> str:
    kind = rng.random()
    if kind < 0.04:
        # charset soup: uniform random characters so EVERY class gets
        # gradient signal (rare glyphs otherwise never appear and steal
        # probability mass from lookalikes at inference)
        n = int(rng.integers(3, 14))
        soup = _SOUP_EXT if rng.random() < 0.5 else _SOUP
        return "".join(soup[rng.integers(0, len(soup))] for _ in range(n))
    if kind < 0.16 and kind >= 0.04:
        # Greek/math finance notation (12% of batches)
        s = _formula(rng)
        if rng.random() < 0.25:  # compound: two clauses on one line
            s += ", " + _formula(rng)
        return s
    kind = (kind - 0.16) / 0.84 if kind >= 0.16 else kind  # renormalize
    if kind < 0.14:
        # bare axis-tick tokens (chart y/x labels): SHORT digit or
        # letter+digit strings that appear tiny on charts and upscale
        # blurry — paired with the tiny-glyph blur augmentation below
        t = rng.integers(0, 3)
        if t == 0:
            return f"{rng.choice(['Q', 'H', 'T', 'FY', 'Y'])}{rng.integers(0, 10)}"
        if t == 1:
            return f"{5 * rng.integers(0, 21)}"
        return f"{rng.integers(0, 10)}"
    if kind < 0.25:  # numeric / currency / ticks
        style = rng.integers(0, 7)
        v = rng.uniform(-5000, 100000)
        return [
            f"{v:,.2f}",
            f"${abs(v):,.0f}",
            f"{rng.uniform(-99, 99):.1f}%",
            f"{rng.integers(1900, 2030)}",
            f"{rng.uniform(0, 100):.2f}",
            f"{rng.uniform(0.1, 9.9):.1f}{rng.choice(['K', 'M', 'B'])}",
            # axis tick labels: short letter+digit tokens (Q1, H2, FY9)
            # rendered tiny on charts \u2014 see the blur augmentation below
            f"{rng.choice(['Q', 'H', 'T', 'FY', 'Y'])}{rng.integers(0, 10)}",
        ][style] + ("\u2030" if style == 2 and rng.random() < 0.1 else "")
    if kind < 0.35:  # figure labels
        return (
            f"{rng.choice(['Figure', 'Fig.', 'Exhibit', 'Chart', 'Diagram'])} "
            f"{rng.integers(1, 30)}.{rng.integers(1, 20)}"
        )
    # 20% long lines (7-13 words): inference tiles run up to
    # cfg.split_squash x the natural width; dense long lines must be
    # in-distribution or the squashed frames decode short
    n = int(rng.integers(7, 14)) if kind > 0.8 else int(rng.integers(1, 7))
    words = [WORDS[rng.integers(0, len(WORDS))] for _ in range(n)]
    s = " ".join(words)
    if rng.random() < 0.3:
        s = s.capitalize()
    if rng.random() < 0.1:
        s = s.upper()
    if rng.random() < 0.15:  # flowchart/caption punctuation
        s += rng.choice(["?", ":", ";", "!", ".", ")", "%", "\u2030"])
    return s


# ---------------------------------------------------------------------------
# screenshot / spreadsheet domain (round 5)
#
# The reference's golden crop (extracted_visuals_excelSS) is an Excel
# screenshot: ~10-13px antialiased UI text, light grid lines, grey cell
# fills, dense numeric cells. First golden-crop measurement (eval --golden)
# scored CER 0.87 — the recognizer had never seen small-raster UI text or
# grid-line artifacts clipped into its tiles. These generators model the
# DOMAIN (tiny upscaled sans text, grids, fills, number-heavy cells) with
# generic finance/spreadsheet vocabulary — deliberately NOT the golden
# crop's literal strings, which are the eval set.
# ---------------------------------------------------------------------------

_SS_LABELS = (
    "Price Call Put Steps Model Inputs Outputs Rate Value Delta Gamma "
    "Theta Vega Rho Strike Spot Maturity Volatility Dividend Yield Total "
    "Mean Median Stdev Min Max Sum Count Cell Sheet Table Row Column "
    "European American Asian Forward Spot Implied Weighted Net Gross "
    "Expected Annual Monthly Daily Cumulative Discount Present Future"
).split()

_SS_SYMS = "XTSKNrqdtvabcgkmnpsuwxyz"


def _screenshot_text(rng: np.random.Generator) -> str:
    t = rng.random()
    if t < 0.30:  # bare numbers in spreadsheet formats
        style = rng.integers(0, 6)
        return [
            f"{rng.uniform(-100, 200):.4f}",
            f"{rng.uniform(-100, 200):.2f}",
            f"{rng.uniform(0, 1):.4f}",
            f"-{rng.uniform(0, 99):.4f}",
            f"{rng.integers(0, 10000)}",
            f"{rng.uniform(0, 500):,.2f}",
        ][style]
    if t < 0.42:  # percents
        return f"{rng.uniform(0, 100):.2f}%"
    if t < 0.58:  # label with parenthesized symbol: "Strike price (X)"
        w = _SS_LABELS[rng.integers(0, len(_SS_LABELS))]
        sym = _SS_SYMS[rng.integers(0, len(_SS_SYMS))]
        if rng.random() < 0.3:
            sym += str(rng.integers(0, 3))
        if rng.random() < 0.25:
            sym = f"{sym} or {_SS_SYMS[rng.integers(0, len(_SS_SYMS))]}"
        low = w.lower() if rng.random() < 0.5 else w
        tail = rng.choice(["price", "rate", "value", "ratio", "factor"])
        return (f"{low} {tail} ({sym})" if rng.random() < 0.6
                else f"{low} ({sym})")
    if t < 0.72:  # short label words / header-ish
        n = int(rng.integers(1, 4))
        ws = [_SS_LABELS[rng.integers(0, len(_SS_LABELS))] for _ in range(n)]
        s = " ".join(ws)
        return s + (":" if rng.random() < 0.3 else "")
    if t < 0.84:  # function-ish tokens: N(d1), PV of strike, S - PV
        a = _SS_SYMS[rng.integers(0, len(_SS_SYMS))].upper()
        b = _SS_SYMS[rng.integers(0, len(_SS_SYMS))]
        style = rng.integers(0, 5)
        return [
            f"N({b}{rng.integers(1, 3)})",
            f"PV of {_SS_LABELS[rng.integers(0, len(_SS_LABELS))].lower()}",
            f"{a} - PV divs",
            f"{b}{rng.integers(1, 3)}",
            f"{a}({b})",
        ][style]
    # mixed row fragment: label + number (adjacent cells in one box)
    w = _SS_LABELS[rng.integers(0, len(_SS_LABELS))]
    return f"{w} {rng.uniform(-50, 150):.{rng.integers(2, 5)}f}"


def fit_text(text: str, max_label: int = 48) -> str:
    """Trim to <= max_label chars at a word boundary.

    charset.encode() hard-truncates LABELS at max_label, but the image
    renders the full string — without this trim every long line trains
    the recognizer that text past char 48 does not exist (measured:
    'yield table Price taxes' rendered, label ends at 'tab'), which
    poisons ~20% of batches and collapses decode confidence.
    """
    if len(text) <= max_label:
        return text
    cut = text.rfind(" ", 1, max_label + 1)
    return text[: cut if cut > 0 else max_label]


_FONT_CACHE = {}


def _font(path: str, size: int):
    from PIL import ImageFont

    key = (path, size)
    if key not in _FONT_CACHE:
        _FONT_CACHE[key] = ImageFont.truetype(path, size)
    return _FONT_CACHE[key]


def render_line(
    text: str,
    rng: np.random.Generator,
    height: int = 32,
    max_width: int = 384,
    style: str | None = None,
) -> np.ndarray:
    """Render one line to a (height, max_width) float32 tile in [0,1]
    (1.0 = white background, matching rendered-PDF polarity).

    ``style="shot"``: screenshot/spreadsheet domain — tiny (9-14px) UI
    text bilinear-UPSCALED to tile height (matching inference tiles cut
    from ~10-13px screenshot lines), light-grey cell backgrounds, grid-
    line artifacts clipped into the tile, JPEG ringing."""
    from PIL import Image, ImageDraw

    shot = style == "shot"
    font_path = _pick_font(text, rng)
    px = int(rng.integers(9, 15)) if shot else int(rng.integers(14, 30))
    font = _font(font_path, px)
    # measure
    tmp = Image.new("L", (8, 8))
    d = ImageDraw.Draw(tmp)
    l, t, r, b = d.textbbox((0, 0), text, font=font)
    w = max(r - l, 1)
    h = max(b - t, 1)
    # scanned-page domain (30% of samples): grey paper, lighter ink —
    # matches the full-page-raster fixtures (io/pdf_writer.make_scanned_book)
    scanned = (not shot) and rng.random() < 0.2
    if shot:
        bg = 255 if rng.random() < 0.4 else int(rng.integers(225, 252))
    else:
        bg = int(rng.integers(215, 245)) if scanned else 255
    img = Image.new("L", (w + 8, h + 8), bg)
    d = ImageDraw.Draw(img)
    if shot:
        gray = int(rng.integers(0, 70))
    else:
        gray = int(rng.integers(10, 70)) if scanned else int(rng.integers(0, 90))
    d.text((4 - l, 4 - t), text, fill=gray, font=font)
    # scale to target height
    scale = (height - 2 * int(rng.integers(0, 4))) / img.height
    new_w = max(1, min(int(img.width * scale), max_width))
    img = img.resize((new_w, max(1, int(img.height * scale))), Image.BILINEAR)
    if scanned and rng.random() < 0.7:
        # JPEG round trip: block artifacts + ringing like embedded scans
        import io as _io

        bio = _io.BytesIO()
        img.save(bio, format="JPEG", quality=int(rng.integers(78, 95)))
        bio.seek(0)
        img = Image.open(bio).convert("L")
    tile = np.full((height, max_width), bg, np.uint8)
    y0 = (height - img.height) // 2
    tile[y0 : y0 + img.height, : img.width] = np.asarray(img)[:, :max_width]
    out = tile.astype(np.float32) / 255.0
    if scanned:
        # scanner skew: integer row-step shear like digitized pages (and
        # the make_scanned_book fixture) — glyphs get 1px horizontal
        # staircases the recognizer must tolerate
        if rng.random() < 0.5:
            slope = rng.uniform(-0.02, 0.02)
            shift = (np.arange(out.shape[0]) * slope * out.shape[1]
                     / out.shape[0]).astype(int)
            for r in range(out.shape[0]):
                if shift[r]:
                    out[r] = np.roll(out[r], shift[r])
        # sensor noise at scan level (sigma ~5/255)
        out = np.clip(
            out + rng.normal(0, rng.uniform(0.01, 0.035), out.shape)
            .astype(np.float32), 0, 1,
        )
    elif shot:
        # grid-line artifacts: spreadsheet cell borders clip into
        # detection boxes — light vertical rules near either edge,
        # horizontal rules along top/bottom rows. Grid grey (0.45-0.8)
        # sits well above ink (<=0.27) so the recognizer learns to
        # IGNORE rules rather than decode them as 'l' / '_'
        g = rng.uniform(0.45, 0.8)
        if rng.random() < 0.6:  # vertical rule(s)
            for side in ([0] if rng.random() < 0.5 else [0, 1]):
                col = (int(rng.integers(0, 4)) if side == 0
                       else out.shape[1] - 1 - int(rng.integers(0, 4)))
                out[:, col] = np.minimum(out[:, col], g)
        if rng.random() < 0.6:  # horizontal rule at top or bottom
            row = (int(rng.integers(0, 3)) if rng.random() < 0.5
                   else out.shape[0] - 1 - int(rng.integers(0, 3)))
            c0 = int(rng.integers(0, out.shape[1] // 2))
            c1 = int(rng.integers(c0 + 20, out.shape[1] + 1))
            out[row, c0:c1] = np.minimum(out[row, c0:c1], g)
        if rng.random() < 0.5:  # JPEG ringing (screenshots embed as DCT)
            import io as _io

            from PIL import Image as _Image

            bio = _io.BytesIO()
            _Image.fromarray((out * 255).astype(np.uint8)).save(
                bio, format="JPEG", quality=int(rng.integers(72, 95))
            )
            bio.seek(0)
            out = np.asarray(_Image.open(bio)).astype(np.float32) / 255.0
        if rng.random() < 0.4:  # sensor/compression noise
            out = np.clip(
                out + rng.normal(0, rng.uniform(0.005, 0.02), out.shape)
                .astype(np.float32), 0, 1,
            )
    elif rng.random() < 0.3:  # mild contrast/noise jitter
        out = np.clip(out + rng.normal(0, 0.02, out.shape).astype(np.float32), 0, 1)
    if (not shot) and len(text) <= 8 and rng.random() < (
        0.45 if len(text) <= 4 else 0.25
    ):
        # tiny-glyph blur: chart tick labels ('Q1', '25') are detected in
        # ~10-14px boxes and bilinear-UPSCALED ~2-3x to tile height, so
        # their edges smear; '1'/'z'-class lookalikes need training
        # signal at exactly this blur level. Short strings only — long
        # lines at 9px then upscaled are unreadable mush and would just
        # be label noise.
        from PIL import Image as _Image

        small_h = int(rng.integers(9, 15))
        small_w = max(1, int(out.shape[1] * small_h / out.shape[0]))
        im = _Image.fromarray((out * 255).astype(np.uint8))
        im = im.resize((small_w, small_h), _Image.BILINEAR)
        im = im.resize((out.shape[1], out.shape[0]), _Image.BILINEAR)
        out = np.asarray(im).astype(np.float32) / 255.0
    if rng.random() < 0.12:
        # tile-border artifacts: detection boxes clip within a pixel or
        # two of neighboring ink (specks, descenders of the line above, a
        # partial stroke of an adjacent word). Without these the model
        # reads a dark leading edge as a thin letter ('lower'->'Ilower').
        edge = rng.integers(0, 4)
        dark = rng.uniform(0.0, 0.35)
        n_rows = int(rng.integers(4, out.shape[0]))
        r0 = int(rng.integers(0, out.shape[0] - n_rows + 1))
        if edge == 0:
            out[r0:r0 + n_rows, 0] = dark
        elif edge == 1:
            out[r0:r0 + n_rows, -1] = dark
        elif edge == 2:
            c0 = int(rng.integers(0, out.shape[1]))
            out[0, c0:c0 + int(rng.integers(2, 9))] = dark
        else:
            c0 = int(rng.integers(0, out.shape[1]))
            out[-1, c0:c0 + int(rng.integers(2, 9))] = dark
    return out


def make_batch(
    rng: np.random.Generator,
    batch: int = 64,
    height: int = 32,
    width: int = 384,
    max_label: int = 48,
    shot_frac: float = 0.16,
):
    """-> (images (B,H,W,1) f32, labels (B,max_label) i32, label_lens (B,))"""
    imgs = np.zeros((batch, height, width, 1), np.float32)
    labels = np.zeros((batch, max_label), np.int32)
    lens = np.zeros((batch,), np.int32)
    for i in range(batch):
        # screenshot/spreadsheet domain: 16% of PIL-rendered lines (the
        # golden-crop content class; see _screenshot_text)
        shot = rng.random() < shot_frac
        if shot:
            text = fit_text(_screenshot_text(rng), max_label)
            imgs[i, :, :, 0] = render_line(
                text, rng, height, width, style="shot"
            )
        else:
            text = fit_text(random_text(rng), max_label)
            imgs[i, :, :, 0] = render_line(text, rng, height, width)
        ids, n = charset.encode(text, max_label)
        labels[i] = ids
        lens[i] = n
    return imgs, labels, lens


# ---------------------------------------------------------------------------
# renderer-matched generation: lines rasterized by the spdf engine, exactly
# like inference tiles (pdf -> native raster -> PIL bilinear resize to 28px)
# ---------------------------------------------------------------------------


def make_batch_spdf(
    rng: np.random.Generator,
    batch: int = 64,
    height: int = 32,
    width: int = 384,
    max_label: int = 48,
):
    """Render `batch` random lines through the native PDF engine.

    Builds ONE multi-line PDF page per batch, rasterizes it once at a
    random crop-like scale, and cuts per-line tiles — matching the
    inference distribution (synapta_tpu rasterizer AA, bilinear resize)
    rather than PIL's text rendering."""
    from PIL import Image

    from synapta_tpu_torch.io.ingest import Document
    from synapta_tpu_torch.io.pdf_writer import SyntheticBook

    from synapta_tpu_torch.models import charset as _cs

    texts = [fit_text(random_text(rng), max_label) for _ in range(batch)]
    book = SyntheticBook(width=1000.0, height=float(batch * 28 + 40))
    c = book.new_page()
    metas = []
    y = 16.0
    for t in texts:
        size = float(rng.integers(8, 19))
        bold = bool(rng.random() < 0.25)
        bbox = c.text(20.0, y, t, size=size, bold=bold, record=False)
        metas.append(bbox)
        y += 28.0
    doc = Document(data=book.tobytes())
    scale = float(rng.uniform(1.1, 2.2))  # crop-render scale range
    page = doc.render(0, dpi=72.0 * scale)
    imgs = np.zeros((batch, height, width, 1), np.float32)
    labels = np.zeros((batch, max_label), np.int32)
    lens = np.zeros((batch,), np.int32)
    target_h = height - 4
    for i, (t, bb) in enumerate(zip(texts, metas)):
        # +-1px crop jitter: inference line boxes land within a pixel or
        # two of the glyphs; the recognizer must be shift-robust
        jx, jy = int(rng.integers(-1, 2)), int(rng.integers(-1, 2))
        x0 = max(0, int((bb[0] - 1) * scale) + jx)
        y0 = max(0, int((bb[1] - 1) * scale) + jy)
        x1 = min(page.shape[1], int((bb[2] + 2) * scale) + jx)
        y1 = min(page.shape[0], int((bb[3] + 2) * scale) + jy)
        sub = page[y0:y1, x0:x1]
        gray = (
            0.299 * sub[..., 0] + 0.587 * sub[..., 1] + 0.114 * sub[..., 2]
        ).astype(np.uint8)
        h, w = gray.shape
        s = target_h / max(h, 1)
        new_w = max(1, min(int(w * s), width))
        img = Image.fromarray(gray).resize((new_w, target_h), Image.BILINEAR)
        tile = np.full((height, width), 255, np.uint8)
        tile[2 : 2 + target_h, :new_w] = np.asarray(img)
        imgs[i, :, :, 0] = tile.astype(np.float32) / 255.0
        ids, n = _cs.encode(t, max_label)
        labels[i] = ids
        lens[i] = n
    doc.close()
    return imgs, labels, lens


def make_batch_mixed(
    rng: np.random.Generator,
    batch: int = 64,
    height: int = 32,
    width: int = 384,
    max_label: int = 48,
    spdf_frac: float = 0.5,
    shot_frac: float = 0.16,
):
    """Mix PIL-rendered and spdf-rendered lines in one batch."""
    n_spdf = int(batch * spdf_frac)
    if n_spdf <= 0:
        return make_batch(rng, batch, height, width, max_label, shot_frac)
    a = make_batch_spdf(rng, n_spdf, height, width, max_label)
    b = make_batch(rng, batch - n_spdf, height, width, max_label, shot_frac)
    return tuple(np.concatenate([x, y]) for x, y in zip(a, b))
