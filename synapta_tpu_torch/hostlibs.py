"""Make the native PDF engine loadable where the system lacks libjpeg.

The host side of the pipeline parses and rasterizes PDFs through
``synapta_tpu/io/_pdf_native.so``, which links ``libjpeg.so.62``
(libjpeg-turbo's 6.2 ABI). Where the system has no such library, the
libjpeg-turbo that Pillow's wheel bundles provides the same ABI. The dynamic
loader reads ``LD_LIBRARY_PATH`` only at process start, so the fix is a
re-exec: a directory in the checkout gets a ``libjpeg.so.62`` symlink to
Pillow's copy, and the process restarts with that directory on the path.

Where the system lacks the DejaVu faces or fontTools, the synthetic books
(``ensure_fixture_fonts``) and the training-line generator
(``ensure_synthdata_fonts``) use the faces shipped in
``synapta_tpu_torch/fonts/`` and read glyph tables from their files.
"""
from __future__ import annotations

import ctypes
import glob
import os
import sys
from pathlib import Path

_MARK = "SYNAPTA_LIBJPEG_SHIM"


def _native_so() -> str:
    # The engine binary stays in the JAX package's tree, where native/Makefile
    # builds it; the port's ingest reads it by file path from the repo root
    # (SPDF_NATIVE_SO overrides it) and never imports that package.
    from synapta_tpu_torch.io.ingest import _SO_PATH

    return _SO_PATH


def ensure_native_engine(argv) -> None:
    """Return if the native engine loads. If it fails only for want of
    libjpeg.so.62, re-exec ``[sys.executable, *argv]`` with Pillow's
    bundled libjpeg-turbo on LD_LIBRARY_PATH (once); otherwise raise."""
    try:
        ctypes.CDLL(_native_so())
        return
    except OSError as e:
        if "libjpeg" not in str(e) or os.environ.get(_MARK):
            raise
        err = e
    import PIL

    site = Path(PIL.__file__).resolve().parent.parent
    cands = sorted(glob.glob(str(site / "pillow.libs" / "libjpeg-*.so.62*")))
    if not cands:
        raise OSError(f"{err}; and Pillow bundles no libjpeg.so.62") from err
    shim = Path(__file__).resolve().parent / "_build" / "hostlibs"
    shim.mkdir(parents=True, exist_ok=True)
    link = shim / "libjpeg.so.62"
    if link.is_symlink() or link.exists():
        link.unlink()
    link.symlink_to(cands[0])
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        p for p in (str(shim), env.get("LD_LIBRARY_PATH", "")) if p
    )
    env[_MARK] = "1"
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, [sys.executable, *argv], env)


def ensure_fixture_fonts() -> None:
    """The synthetic books (``synapta_tpu_torch.io.pdf_writer``: the test
    book embeds DejaVu Sans, the scanned book draws its page rasters with
    it) read DejaVu Sans from the system font directory. Where those files
    are missing, point the writer at the copies shipped in
    ``synapta_tpu_torch/fonts/``, so the books are the same on every
    machine (the recognizer was trained on DejaVu glyphs). User PDFs carry
    their own fonts."""
    import synapta_tpu_torch.io.pdf_writer as pw

    try:
        import fontTools.ttLib  # noqa: F401
    except ImportError:
        # the writer's Greek/math (CID) text asks fontTools for glyph ids
        pw._CIDFontInfo = _GlyphTable
    if os.path.exists(pw.DEJAVU) and os.path.exists(pw.DEJAVU_BOLD):
        return
    fonts = Path(__file__).resolve().parent / "fonts"
    pw.DEJAVU = str(fonts / "DejaVuSans.ttf")
    pw.DEJAVU_BOLD = str(fonts / "DejaVuSans-Bold.ttf")
    # text_width binds DEJAVU as its default argument at definition time
    pw.text_width.__defaults__ = (pw.DEJAVU,)


def ensure_synthdata_fonts() -> None:
    """The training-line generator (``synapta_tpu_torch.models.synthdata``)
    binds its faces when it is imported: DejaVu Sans and Sans Bold from the
    book writer, DejaVu Serif and Sans Mono by system path, matplotlib's
    STIX faces where matplotlib is installed, and it asks fontTools which
    characters each face covers. Where a DejaVu file is missing, point the
    generator at the copy shipped in ``synapta_tpu_torch/fonts/``; where
    fontTools is missing, read each face's coverage from its cmap. Without
    matplotlib the STIX faces stay out, so the same seed draws other lines
    than on a machine that has them."""
    import synapta_tpu_torch.io.pdf_writer as pw
    import synapta_tpu_torch.models.synthdata as sd

    ensure_fixture_fonts()
    fonts = Path(__file__).resolve().parent / "fonts"
    sd.DEJAVU, sd.DEJAVU_BOLD = pw.DEJAVU, pw.DEJAVU_BOLD
    if not os.path.exists(sd.DEJAVU_SERIF):
        sd.DEJAVU_SERIF = str(fonts / "DejaVuSerif.ttf")
    if not os.path.exists(sd.DEJAVU_MONO):
        sd.DEJAVU_MONO = str(fonts / "DejaVuSansMono.ttf")
    sd.FONTS = sd._candidate_fonts()
    try:
        import fontTools.ttLib  # noqa: F401
    except ImportError:
        for path in sd.FONTS:
            if path not in sd._COVERAGE:
                cmap = _GlyphTable(path)._cmap
                sd._COVERAGE[path] = {c for c in sd.charset.CHARS
                                      if ord(c) in cmap}


class _GlyphTable:
    """char -> (glyph id, advance in 1000/em) read straight from a TrueType
    file's cmap (format 4 or 12), head and hmtx tables: the one query
    ``pdf_writer._CIDFontInfo`` answers with fontTools."""

    def __init__(self, path: str):
        import struct

        data = Path(path).read_bytes()
        n = struct.unpack_from(">H", data, 4)[0]
        tables = {}
        for i in range(n):
            tag, _, off, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            tables[tag.decode("latin-1")] = (off, length)
        self._upem = struct.unpack_from(">H", data, tables["head"][0] + 18)[0]
        n_hm = struct.unpack_from(">H", data, tables["hhea"][0] + 34)[0]
        hmtx = tables["hmtx"][0]
        self._adv = [struct.unpack_from(">H", data, hmtx + 4 * i)[0]
                     for i in range(n_hm)]
        self._cmap = self._read_cmap(data, tables["cmap"][0])
        self._cache = {}

    @staticmethod
    def _read_cmap(data: bytes, base: int) -> dict:
        import struct

        n = struct.unpack_from(">H", data, base + 2)[0]
        subs = {}
        for i in range(n):
            plat, enc, off = struct.unpack_from(">HHI", data, base + 4 + 8 * i)
            subs[(plat, enc)] = base + off
        out = {}
        for key in ((3, 10), (0, 4), (3, 1), (0, 3)):
            if key not in subs:
                continue
            off = subs[key]
            fmt = struct.unpack_from(">H", data, off)[0]
            if fmt == 12:
                groups = struct.unpack_from(">I", data, off + 12)[0]
                for g in range(groups):
                    lo, hi, gid = struct.unpack_from(">III", data, off + 16 + 12 * g)
                    for cp in range(lo, hi + 1):
                        out[cp] = gid + cp - lo
                return out
            if fmt == 4:
                segs = struct.unpack_from(">H", data, off + 6)[0] // 2
                ends = off + 14
                starts = ends + 2 * segs + 2
                deltas = starts + 2 * segs
                ranges = deltas + 2 * segs
                for sgm in range(segs):
                    end, start = (struct.unpack_from(">H", data, a + 2 * sgm)[0]
                                  for a in (ends, starts))
                    delta = struct.unpack_from(">h", data, deltas + 2 * sgm)[0]
                    roff = struct.unpack_from(">H", data, ranges + 2 * sgm)[0]
                    for cp in range(start, min(end, 0xFFFE) + 1):
                        if roff == 0:
                            gid = (cp + delta) & 0xFFFF
                        else:
                            at = ranges + 2 * sgm + roff + 2 * (cp - start)
                            gid = struct.unpack_from(">H", data, at)[0]
                            gid = (gid + delta) & 0xFFFF if gid else 0
                        if gid:
                            out[cp] = gid
                return out
        return out

    def glyph(self, ch: str):
        """-> (gid, width in 1000/em) or None if the font lacks the char."""
        if ch not in self._cache:
            gid = self._cmap.get(ord(ch))
            if gid is None:
                self._cache[ch] = None
            else:
                adv = self._adv[min(gid, len(self._adv) - 1)]
                self._cache[ch] = (gid, adv * 1000 // self._upem)
        return self._cache[ch]
