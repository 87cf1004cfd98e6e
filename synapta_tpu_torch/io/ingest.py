"""PDF ingest: Python binding over the native spdf engine.

Replaces the reference's PyMuPDF usage (ref pdf_image_segmentation.py:2731,
3154, 3274, 3290-3298, 3638-3657) with the first-party C++ engine in
``native/`` (built to ``synapta_tpu/io/_pdf_native.so``). The public surface
mirrors what the detection layers need:

  - ``Document.page_count`` / ``page_size(i)``
  - ``page_text_blocks(i)``   -> [{text, bbox, size}]   (fitz get_text("dict"))
  - ``page_spans(i)``         -> raw spans with font size
  - ``page_drawings(i)``      -> [{bbox, kind, is_rect, items}]  (get_drawings)
  - ``page_images(i)``        -> [{obj, bbox, width, height}]    (get_image_rects)
  - ``decode_image(obj)``     -> np.uint8 HxWx3                  (extract_image)
  - ``render(i, dpi, clip)``  -> np.uint8 HxWx3                  (get_pixmap)

All geometry is top-left-origin PDF points, matching the reference.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# SPDF_NATIVE_SO overrides the engine binary — used by the fuzz/sanitizer
# harness to point at an ASan build without touching the installed lib
# The port shares the engine binary that native/Makefile builds into the JAX
# package's tree: it is read by file path from the repo root, never imported.
_SO_PATH = os.environ.get(
    "SPDF_NATIVE_SO",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "synapta_tpu", "io", "_pdf_native.so"),
)

_lib = None

# JPEG2000 (JPXDecode) host decoder: the engine calls back into Python and
# we decode via PIL/OpenJPEG — the same codec family fitz/MuPDF links for
# JPX (ref pdf_image_segmentation.py:2731). The callback fills the engine's
# pre-allocated w*h*3 RGB8 buffer (w/h from the image dict); any failure
# returns 0 and the engine degrades to its neutral plate. ctypes re-acquires
# the GIL inside the callback, so it is safe from the engine's caller thread
# even though the outer foreign call released it.
_JPX_CB_TYPE = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
)
_jpx_cb_ref = None  # must outlive the library: module-lifetime reference


def _jpx_decode_host(data, n, out, w, h):
    try:
        import io as _io

        from PIL import Image

        im = Image.open(_io.BytesIO(ctypes.string_at(data, n)))
        im.load()
        im = im.convert("RGB")
        if im.size != (w, h):  # spec requires match; be lenient like fitz
            im = im.resize((w, h))
        arr = np.ascontiguousarray(np.asarray(im, dtype=np.uint8))
        ctypes.memmove(out, arr.ctypes.data, w * h * 3)
        return 1
    except Exception:
        return 0


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        raise RuntimeError(
            f"native PDF engine not built: {_SO_PATH} missing — run `make -C native`"
        )
    lib = ctypes.CDLL(_SO_PATH)
    lib.spdf_open.argtypes = [ctypes.c_char_p]
    lib.spdf_open.restype = ctypes.c_void_p
    lib.spdf_open_bytes.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.spdf_open_bytes.restype = ctypes.c_void_p
    lib.spdf_open_pw.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.spdf_open_pw.restype = ctypes.c_void_p
    lib.spdf_open_bytes_pw.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
    ]
    lib.spdf_open_bytes_pw.restype = ctypes.c_void_p
    lib.spdf_close.argtypes = [ctypes.c_void_p]
    lib.spdf_page_count.argtypes = [ctypes.c_void_p]
    lib.spdf_page_count.restype = ctypes.c_int
    lib.spdf_page_size.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.spdf_page_metadata.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.spdf_page_metadata.restype = ctypes.c_void_p
    lib.spdf_render.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.spdf_render.restype = ctypes.c_void_p
    lib.spdf_decode_image.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.spdf_decode_image.restype = ctypes.c_void_p
    lib.spdf_free.argtypes = [ctypes.c_void_p]
    lib.spdf_png_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.spdf_png_encode.restype = ctypes.c_void_p
    lib.spdf_gray_quarter.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.spdf_gray_quarter.restype = None
    lib.spdf_box_downscale.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.spdf_box_downscale.restype = None
    try:
        lib.spdf_line_tiles.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.spdf_line_tiles.restype = None
    except AttributeError:  # stale .so: processor keeps the Python path
        pass
    try:
        lib.spdf_set_jpx_decoder.argtypes = [_JPX_CB_TYPE]
        lib.spdf_set_jpx_decoder.restype = None
        global _jpx_cb_ref
        _jpx_cb_ref = _JPX_CB_TYPE(_jpx_decode_host)
        lib.spdf_set_jpx_decoder(_jpx_cb_ref)
    except AttributeError:  # stale .so without the hook: keep plate degrade
        pass
    _lib = lib
    return lib


def png_encode(rgb: "np.ndarray") -> bytes:
    """PNG-encode an (H, W, 3) uint8 array via the native engine (filter-
    NONE rows + fast deflate — ~3x cheaper than PIL's adaptive-filter
    encoder on crop renders; profiled as the largest host CPU stage of
    the 1,000-page bench). ctypes releases the GIL for the call, so pool
    threads overlap it like the PIL path it replaces."""
    import numpy as np

    lib = _load_lib()
    arr = np.ascontiguousarray(rgb)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("png_encode expects (H, W, 3) uint8")
    n = ctypes.c_long(0)
    p = lib.spdf_png_encode(
        arr.ctypes.data_as(ctypes.c_char_p), arr.shape[1], arr.shape[0],
        ctypes.byref(n),
    )
    if not p:
        raise RuntimeError("native PNG encode failed")
    try:
        return ctypes.string_at(p, n.value)
    finally:
        lib.spdf_free(p)


def gray_quarter_native(rgb: "np.ndarray"):
    """Native fused luma + 2x2 subsample over an (N, H, W, 3) uint8 batch.
    Bit-identical to ops/color.gray_quarter_host's numpy path; one
    memory-speed GIL-free pass. Returns (gray (N,H,W), rgbq (N,H/2,W/2,3))."""
    import numpy as np

    lib = _load_lib()
    arr = np.ascontiguousarray(rgb)
    n, h, w, _ = arr.shape
    gray = np.empty((n, h, w), np.uint8)
    rgbq = np.empty((n, h // 2, w // 2, 3), np.uint8)
    lib.spdf_gray_quarter(
        arr.ctypes.data_as(ctypes.c_char_p), n, h, w,
        gray.ctypes.data_as(ctypes.c_char_p),
        rgbq.ctypes.data_as(ctypes.c_char_p),
    )
    return gray, rgbq


def box_downscale(rgb: "np.ndarray", oh: int, ow: int) -> "np.ndarray":
    """Native area-average downscale of an (H, W, 3) uint8 image.

    Coverage-exact box filter: each output pixel is the mean of its
    (fractional) source footprint — the same integral the rasterizer's
    antialiasing computes when rendering directly at the lower DPI, so a
    downscaled 150-DPI render is a faithful stand-in for a second
    fitted-DPI rasterization (unlike bilinear point-sampling, which drops
    sub-pixel strokes). Used by io/loader to halve region raster cost."""
    import numpy as np

    lib = _load_lib()
    arr = np.ascontiguousarray(rgb)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("box_downscale expects (H, W, 3) uint8")
    out = np.empty((oh, ow, 3), np.uint8)
    lib.spdf_box_downscale(
        arr.ctypes.data_as(ctypes.c_char_p), arr.shape[0], arr.shape[1],
        out.ctypes.data_as(ctypes.c_char_p), oh, ow,
    )
    return out


def line_tiles_native(src: "np.ndarray", boxes: "np.ndarray",
                      tile_h: int, tile_w: int):
    """Batched OCR line-tile build via the native engine — the C form of
    ocr/processor.TPUOCR._line_tile, bit-identical (integer luma,
    histogram percentile stretch, PIL-parity BILINEAR resize; locked by
    tests/test_ocr.py). Replaces the per-tile Python+PIL loop that
    profiled at ~1.4 ms/tile on the 1-core host.

    src: (H, W, 3) uint8; boxes: (N, 4) int32 in src coords (caller
    applies any hires ratio). Returns (tiles (N, tile_h, tile_w) uint8,
    content_w (N,) int32) or None when the .so lacks the entry point."""
    import numpy as np

    lib = _load_lib()
    if not hasattr(lib, "spdf_line_tiles"):
        return None
    arr = np.ascontiguousarray(src)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("line_tiles_native expects (H, W, 3) uint8")
    b = np.ascontiguousarray(boxes, np.int32)
    n = b.shape[0]
    tiles = np.empty((n, tile_h, tile_w), np.uint8)
    cw = np.empty(n, np.int32)
    lib.spdf_line_tiles(
        arr.ctypes.data_as(ctypes.c_char_p), arr.shape[0], arr.shape[1],
        b.ctypes.data_as(ctypes.c_char_p), n, tile_h, tile_w,
        tiles.ctypes.data_as(ctypes.c_char_p),
        cw.ctypes.data_as(ctypes.c_char_p),
    )
    return tiles, cw


class Document:
    """One open PDF. Thread-compatible for read-only page access."""

    def __init__(self, path: Optional[str] = None, data: Optional[bytes] = None,
                 password: str = ""):
        lib = _load_lib()
        pw = password.encode() if password else b""
        if path is not None:
            self._h = lib.spdf_open_pw(path.encode(), pw)
        elif data is not None:
            self._h = lib.spdf_open_bytes_pw(data, len(data), pw)
        else:
            raise ValueError("need path or data")
        if not self._h:
            raise IOError(f"failed to parse PDF: {path or '<bytes>'}")
        self._lib = lib
        self._meta_cache: Dict[int, Dict[str, Any]] = {}
        self._blocks_cache: Dict[int, List[Dict[str, Any]]] = {}
        self.path = path or "<bytes>"

    def close(self) -> None:
        if self._h:
            self._lib.spdf_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- pages ---------------------------------------------------------------

    @property
    def page_count(self) -> int:
        return self._lib.spdf_page_count(self._h)

    def __len__(self) -> int:
        return self.page_count

    def page_size(self, index: int) -> Tuple[float, float]:
        w = ctypes.c_double()
        h = ctypes.c_double()
        self._lib.spdf_page_size(self._h, index, ctypes.byref(w), ctypes.byref(h))
        return w.value, h.value

    def _metadata(self, index: int) -> Dict[str, Any]:
        if index not in self._meta_cache:
            p = self._lib.spdf_page_metadata(self._h, index)
            try:
                raw = ctypes.string_at(p)
            finally:
                self._lib.spdf_free(p)
            self._meta_cache[index] = json.loads(raw.decode("utf-8", "replace"))
        return self._meta_cache[index]

    def page_spans(self, index: int) -> List[Dict[str, Any]]:
        return self._metadata(index)["spans"]

    def page_drawings(self, index: int) -> List[Dict[str, Any]]:
        return self._metadata(index)["drawings"]

    def page_images(self, index: int) -> List[Dict[str, Any]]:
        return [im for im in self._metadata(index)["images"] if not im["inline"]]

    def page_text_blocks(self, index: int) -> List[Dict[str, Any]]:
        """Spans merged into reading blocks (the fitz 'dict' block analog):
        spans whose baselines are vertically adjacent and horizontally
        overlapping merge into one block.

        Cached per page: detection walks the blocks of one page ~4x
        (captions, boundaries, embedded validation), and re-merging spans
        was ~2s/1000-page book. Callers treat blocks as read-only."""
        cached = self._blocks_cache.get(index)
        if cached is not None:
            return cached
        spans = self.page_spans(index)
        blocks: List[Dict[str, Any]] = []
        for s in sorted(spans, key=lambda s: (round(s["bbox"][1], 1), s["bbox"][0])):
            sb = s["bbox"]
            merged = False
            for b in blocks:
                bb = b["bbox"]
                v_gap = sb[1] - bb[3]
                x_overlap = min(sb[2], bb[2]) - max(sb[0], bb[0])
                same_line = abs(sb[1] - bb[1]) < s["size"] * 0.6
                if (same_line and -2.0 <= sb[0] - bb[2] <= s["size"] * 1.2) or (
                    -2.0 <= v_gap <= s["size"] * 0.62 and x_overlap > -s["size"]
                ):
                    b["text"] += (" " if not same_line or sb[0] - bb[2] > 0.1 else "") + s["text"]
                    b["bbox"] = [
                        min(bb[0], sb[0]), min(bb[1], sb[1]),
                        max(bb[2], sb[2]), max(bb[3], sb[3]),
                    ]
                    b["size"] = max(b["size"], s["size"])
                    merged = True
                    break
            if not merged:
                blocks.append(
                    {"text": s["text"], "bbox": list(sb), "size": s["size"]}
                )
        self._blocks_cache[index] = blocks
        return blocks

    def decode_image(self, obj_num: int) -> Optional[np.ndarray]:
        w = ctypes.c_int()
        h = ctypes.c_int()
        p = self._lib.spdf_decode_image(self._h, obj_num, ctypes.byref(w), ctypes.byref(h))
        if not p:
            return None
        try:
            buf = ctypes.string_at(p, w.value * h.value * 3)
        finally:
            self._lib.spdf_free(p)
        return np.frombuffer(buf, dtype=np.uint8).reshape(h.value, w.value, 3).copy()

    def render(
        self,
        index: int,
        dpi: float = 150.0,
        clip: Optional[Sequence[float]] = None,
    ) -> np.ndarray:
        """Rasterize a page (or clip region, page points top-left origin)
        to RGB uint8 at the given DPI."""
        if not 0 <= index < self.page_count:
            raise IndexError(f"page {index} out of range (0..{self.page_count - 1})")
        scale = dpi / 72.0
        w = ctypes.c_int()
        h = ctypes.c_int()
        carr = None
        if clip is not None:
            carr = (ctypes.c_double * 4)(*[float(v) for v in clip])
        p = self._lib.spdf_render(self._h, index, scale, carr, ctypes.byref(w), ctypes.byref(h))
        if not p:
            raise RuntimeError(f"render failed for page {index}")
        try:
            buf = ctypes.string_at(p, w.value * h.value * 3)
        finally:
            self._lib.spdf_free(p)
        return np.frombuffer(buf, dtype=np.uint8).reshape(h.value, w.value, 3).copy()


def open_pdf(path: str, password: str = "") -> Document:
    return Document(path=path, password=password)
