"""How ``correct`` is decided: what the timed path produced, held to the
plain reference in ``portbench/reference/`` once the window has closed.

During the window ``Captures`` keeps a sample, drawn from the seed by
reservoir sampling, of the calls the window made into the device layers,
with their inputs and the program's outputs as the program returned them:

- analyze chunks (``device_analyze_dispatch``: the host crop chunk, its
  true sizes, the packed result on the device);
- recognizer stacks (``TorchOCR.recognize_dispatch``: the tiles and each
  128-tile batch's [argmax class, max softmax] frames on the device);
- DB chunks (``boxes_device`` and the ``db_logits`` it calls: the 16 views,
  the probability logits and the (16, 128, 5) boxes on the device).

Afterwards ``compare`` runs the reference on the same inputs and reads one
number a comparison (``NUMBERS``); ``outputs`` reads what every finished
book wrote. A configuration adds comparisons of its own as files,
``compare/<name>.py``, listed by name under its ``"compare"`` key
(``comparisons``). The reference imports nothing of the program; it reads the
program's outputs only to judge them. The DB post stage is followed step by
step from the program's own mask (thresholded program logits); the logits
themselves are judged by ``db_gap``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import threading

import numpy as np

# name -> what it compares (printed beside each number and its limit)
NUMBERS = {
    "analyze_diff": "largest |program - reference| of any packed analyze "
                    "output of a real crop (features, CC censuses, edge-stats "
                    "counts, line boxes) on the sampled chunks",
    "rec_gap": "widest gap, over every frame of the sampled real tiles, by "
               "which the reference float32 logit of the class the program "
               "served lies below the reference's best",
    "db_gap": "widest distance, in logits, by which the reference float32 "
              "logit lies on the other side of the DB threshold from the "
              "program's mask pixel, over the sampled real views",
    "db_boxes_diff": "largest |program - reference| of the DB boxes, the "
                     "reference post stage run on the program's mask",
    "books_incomplete": "finished books missing their JSON, CSV, a PNG, the "
                        "JSONL checkpoint or a done manifest entry",
    "visuals_missed": "truth visuals with no segment on their page at IoU > 0.5",
    "scanned_cer": "mean character error rate of the scanned pages' OCR text",
}


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []
        self.lock = threading.Lock()

    def slot(self):
        """-> the index the offered item goes to, or None to drop it."""
        with self.lock:
            self.n += 1
            if len(self.items) < self.k:
                self.items.append(None)
                return len(self.items) - 1
            j = int(self.rng.integers(self.n))
            return j if j < self.k else None

    def put(self, i, item):
        with self.lock:
            self.items[i] = item


SAMPLES = 6  # calls each comparison keeps


class Captures:
    """Wraps the device layers' entry points for the run (``install``) and
    keeps the sampled calls."""

    def __init__(self, seed: int, k: int = SAMPLES):
        ss = np.random.SeedSequence([seed, 2])
        r = [np.random.default_rng(s) for s in ss.spawn(3)]
        self.analyze, self.rec, self.db = (Reservoir(k, g) for g in r)
        self._logits = threading.local()

    def install(self):
        import synapta_tpu_torch.models.detector as det
        import synapta_tpu_torch.ops.features as feat
        from synapta_tpu_torch.ocr.processor import TorchOCR

        cap = self
        undo = []

        orig_an = feat.device_analyze_dispatch

        def analyze(rgb, sizes=None, **kw):
            out = orig_an(rgb, sizes=sizes, **kw)
            i = cap.analyze.slot()
            if i is not None:
                cap.analyze.put(i, (np.array(rgb), np.array(sizes), out))
            return out

        feat.device_analyze_dispatch = analyze
        undo.append(lambda: setattr(feat, "device_analyze_dispatch", orig_an))

        orig_rec = TorchOCR.__dict__["recognize_dispatch"]

        def recognize(ocr, tiles):
            out = orig_rec(ocr, tiles)
            i = cap.rec.slot()
            if i is not None:
                cap.rec.put(i, (np.array(tiles), list(out)))
            return out

        TorchOCR.recognize_dispatch = recognize
        undo.append(lambda: setattr(TorchOCR, "recognize_dispatch", orig_rec))

        orig_logits, orig_boxes = det.db_logits, det.boxes_device

        def db_logits(model, gray_u8):
            out = orig_logits(model, gray_u8)
            cap._logits.last = out
            return out

        def boxes_device(model, gray_u8, prob_thresh):
            cap._logits.last = None
            out = orig_boxes(model, gray_u8, prob_thresh)
            i = cap.db.slot()
            if i is not None:
                cap.db.put(i, (np.array(gray_u8), cap._logits.last, out,
                               float(prob_thresh)))
            return out

        det.db_logits, det.boxes_device = db_logits, boxes_device
        undo.append(lambda: (setattr(det, "db_logits", orig_logits),
                             setattr(det, "boxes_device", orig_boxes)))
        return undo

    def to_host(self):
        """Copy every sampled device output to the host (after the window)."""
        self.analyze.items = [(r, s, o.cpu().numpy())
                              for r, s, o in self.analyze.items]
        self.rec.items = [(t, [(p.cpu().numpy(), n, pad) for p, n, pad in pend])
                          for t, pend in self.rec.items]
        self.db.items = [(v, lg.cpu().numpy(), bx.cpu().numpy(), th)
                         for v, lg, bx, th in self.db.items]


# ----------------------------------------------------------- comparisons


def analyze_diff(samples, device) -> float:
    from portbench.reference.features import reference_analyze

    worst = 0.0
    for rgb, sizes, prog in samples:
        real = ~np.all(sizes == 1, axis=1)
        for i0 in range(0, rgb.shape[0], 16):
            ref = reference_analyze(rgb[i0:i0 + 16], sizes[i0:i0 + 16],
                                    device).cpu().numpy()
            part = prog[i0:i0 + 16]
            keep = real[i0:i0 + 16]
            if part.shape != ref.shape:
                return math.inf
            d = np.abs(part[keep].astype(np.float64) - ref[keep])
            d = np.where(np.isnan(d), math.inf, d)
            worst = max(worst, float(d.max()) if d.size else 0.0)
    return worst


def _served(pending):
    """Real rows' served classes (N, T) of a recognizer stack."""
    return np.concatenate([p[: n - pad, :, 0] for p, n, pad in pending]).astype(np.int64)


def _gap(ref_logits: np.ndarray, chosen: np.ndarray) -> float:
    """Widest ref.max - ref[chosen] over every frame."""
    if chosen.max(initial=0) >= ref_logits.shape[-1] or chosen.min(initial=0) < 0:
        return math.inf
    best = ref_logits.max(axis=-1)
    got = np.take_along_axis(ref_logits, chosen[..., None], axis=-1)[..., 0]
    g = best - got
    return float(np.nan_to_num(g, nan=math.inf).max()) if g.size else 0.0


def rec_gaps(samples, rec_ref, ctrl_ref=None) -> dict:
    """-> {"rec_gap"}: the program's served classes read against the
    reference, or with ``ctrl_ref`` the control's, its own best class at
    each frame, in the program's place."""
    gap = 0.0
    for tiles, pending in samples:
        served = _served(pending)
        for i0 in range(0, served.shape[0], 128):
            ref = rec_ref(tiles[i0:i0 + 128]).cpu().numpy().astype(np.float64)
            chosen = served[i0:i0 + 128]
            if ctrl_ref is not None:
                chosen = ctrl_ref(tiles[i0:i0 + 128]).cpu().numpy().argmax(axis=-1)
            gap = max(gap, _gap(ref, chosen))
    return {"rec_gap": gap}


def _real_views(views):
    return views.reshape(views.shape[0], -1).min(axis=1) < 255


def _mask_gap(prog_mask, ref_logits, t) -> float:
    g = np.where(prog_mask, t - ref_logits, ref_logits - t)
    return float(max(0.0, np.nan_to_num(g, nan=math.inf).max())) if g.size else 0.0


def db_numbers(samples, det_ref, device, ctrl_ref=None) -> dict:
    """-> {"db_gap", "db_boxes_diff"}; with ``ctrl_ref`` the gap is the
    control's, its own mask read against the reference in the program's
    place (the boxes stay the program's: the control has no post stage)."""
    import torch

    from portbench.reference.cc import component_stats_device, connected_components
    from portbench.reference.filters import dilate, erode

    gap, boxes_diff = 0.0, 0.0
    for views, logits, boxes, thresh in samples:
        t = math.log(thresh / (1.0 - thresh))
        real = _real_views(views)
        ref = det_ref(views).cpu().numpy().astype(np.float64)
        # the program's mask, as the program thresholds its logits
        lg = torch.from_numpy(logits).to(device)
        mask = (torch.sigmoid(lg) > thresh).to(torch.float32)
        served = (mask.cpu().numpy() > 0 if ctrl_ref is None
                  else ctrl_ref(views).cpu().numpy() > t)
        gap = max(gap, _mask_gap(served[real], ref[real], t))
        closed = erode(dilate(mask, 1, 9), 1, 9).contiguous()
        stats = component_stats_device(connected_components(closed, max_iters=10),
                                       k=128)
        want = torch.stack([stats["x0"], stats["y0"], stats["x1"] + 1.0,
                            stats["y1"] + 1.0, stats["area"]], dim=-1).cpu().numpy()
        if want.shape != boxes.shape:
            boxes_diff = math.inf
        else:
            d = np.abs(want.astype(np.float64) - boxes)
            boxes_diff = max(boxes_diff, float(np.nan_to_num(d, nan=math.inf).max()))
    return {"db_gap": gap, "db_boxes_diff": boxes_diff}


def compare(caps: Captures, device, control: bool = False) -> dict:
    """The per-call numbers; with ``control`` the fp8 reference stands in
    the program's place for ``rec_gap`` and ``db_gap``, so that the verdict
    judges the control by the same limits."""
    import torch

    from portbench.reference import models as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if caps.analyze.items:
        out["analyze_diff"] = analyze_diff(caps.analyze.items, device)
    if caps.rec.items:
        tree = M.read_tree(M.RECOGNIZER_WEIGHTS)
        ref = M.RecognizerRef(tree, device)
        ctrl = M.RecognizerRef(tree, device, fp8=True) if control else None
        out.update(rec_gaps(caps.rec.items, ref, ctrl))
    if caps.db.items:
        tree = M.read_tree(M.DETECTOR_WEIGHTS)
        ref = M.DetectorRef(tree, device)
        ctrl = M.DetectorRef(tree, device, fp8=True) if control else None
        out.update(db_numbers(caps.db.items, ref, device, ctrl))
    return out


# ------------------------------------------- a configuration's own comparisons

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def comparisons(names, root: str) -> dict:
    """The modules ``<root>/compare/<name>.py`` of the names a configuration
    lists, by name. Each has

    - ``install(seed, k) -> (captures, undo callables)``: wraps the calls it
      compares for the window and keeps ``k`` of them, drawn from the seed
      (``Reservoir``);
    - ``to_host(captures) -> captures``: the kept outputs copied to the host
      once the window has closed;
    - ``numbers(captures, device, control) -> {name: number}``: its reference
      on the kept inputs, run after the program is freed and after
      ``compare``, so with TF32 off; with ``control`` its control stands in
      the program's place.

    A name without its file fails the run; none is skipped."""
    mods = {}
    for name in names:
        path = os.path.join(root, "compare", f"{name}.py")
        if not (isinstance(name, str) and NAME.fullmatch(name) and os.path.isfile(path)):
            raise SystemExit(f"portbench: the configuration lists comparison "
                             f"{name!r}, and there is no compare/{name}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_compare_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[name] = mod
    return mods


def merge(numbers: dict, more: dict, source: str) -> None:
    """Add ``more`` to ``numbers``; a name that is there already fails the
    run rather than replace a reading."""
    clash = sorted(set(numbers) & set(more))
    if clash:
        raise SystemExit(f"portbench: {source} reads {clash}, which another "
                         "comparison reads already")
    numbers.update(more)


# ------------------------------------------------------------ written books


def _book_outputs_ok(out_dir: str, book_id: str, manifest: dict):
    """-> (segments list or None when an output is missing)."""
    rec = manifest.get("books", {}).get(book_id)
    if not rec or rec.get("status") != "done":
        return None
    paths = [os.path.join(out_dir, f"{book_id}_visual_segments.json"),
             os.path.join(out_dir, f"{book_id}_visual_summary.csv"),
             os.path.join(out_dir, f".{book_id}_segments.jsonl")]
    if not all(os.path.isfile(p) for p in paths):
        return None
    try:
        with open(paths[0]) as f:
            segs = json.load(f)["segments"]
    except (OSError, ValueError, KeyError):
        return None
    if len(segs) != rec.get("segments"):
        return None
    if not all(os.path.isfile(s.get("image_path") or "") for s in segs):
        return None
    return segs


def outputs(books, output_root: str, scanned: bool) -> dict:
    """The written books against their truth: ``books_incomplete``,
    ``visuals_missed`` and, for scanned books, ``scanned_cer``."""
    from portbench.reference.text import cer, iou, norm_text

    with open(os.path.join(output_root, "queue_manifest.json")) as f:
        manifest = json.load(f)
    incomplete = missed = 0
    cers = []
    for b in books:
        segs = _book_outputs_ok(os.path.join(output_root, b["book_id"]),
                                b["book_id"], manifest)
        if segs is None:
            incomplete += 1
            continue
        by_page = {}
        for s in segs:
            bb = s["bbox"]
            by_page.setdefault(s["page_no"] - 1, []).append(
                ((bb["x0"], bb["y0"], bb["x1"], bb["y1"]), s))
        for p, visuals in enumerate(b["visuals"]):
            page = by_page.get(p, [])
            for _, box in visuals:
                if not any(iou(box, sb) > 0.5 for sb, _ in page):
                    missed += 1
            if scanned:
                want = norm_text(b["texts"][p].replace("\n", " "))
                if not page:
                    cers.append(1.0)
                    continue
                seg = max(page, key=lambda e: (e[0][2] - e[0][0]) * (e[0][3] - e[0][1]))[1]
                raw = (seg.get("ocr_result") or {}).get("raw_text") or ""
                cers.append(cer(want, norm_text(raw.replace("\n", " "))))
    out = {"books_incomplete": incomplete, "visuals_missed": missed}
    if scanned:
        out["scanned_cer"] = float(np.mean(cers)) if cers else 1.0
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over every number that has a
    limit; a number without a reading is not correct."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        table[name] = {"value": v, "limit": limit}
        if v is None or not (v <= limit):
            ok = False
    return ok, table
