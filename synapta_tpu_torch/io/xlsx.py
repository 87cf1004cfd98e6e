"""Minimal XLSX read/write (no openpyxl in this environment).

The taxonomy arrives as an Excel workbook (ref pdf_image_segmentation.py:2713
uses pandas.read_excel); xlsx is a zip of XML, so a small stdlib reader
covers the Level/Concept/Tag(s)/Rationale/Page(s) sheets the linker needs.
The writer emits inline-string workbooks for test fixtures.
"""
from __future__ import annotations

import re
import zipfile
from typing import Dict, List, Optional
from xml.etree import ElementTree as ET

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def _col_index(ref: str) -> int:
    """'C7' -> 2"""
    col = 0
    for ch in ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return col - 1


def read_xlsx(path: str, sheet: int = 0) -> List[List[Optional[str]]]:
    """Return the sheet as a list of rows of cell strings (None for gaps)."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter(
                    "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}t"
                )))
        sheets = sorted(
            n for n in z.namelist()
            if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)
        )
        if not sheets:
            raise ValueError(f"no worksheets in {path}")
        root = ET.fromstring(z.read(sheets[min(sheet, len(sheets) - 1)]))
        rows: List[List[Optional[str]]] = []
        for row in root.iter(
            "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}row"
        ):
            cells: List[Optional[str]] = []
            for c in row:
                ref = c.get("r", "")
                idx = _col_index(ref) if ref else len(cells)
                while len(cells) < idx:
                    cells.append(None)
                ctype = c.get("t", "n")
                v = c.find("m:v", _NS)
                ist = c.find("m:is", _NS)
                if ctype == "s" and v is not None:
                    cells.append(shared[int(v.text)])
                elif ctype == "inlineStr" and ist is not None:
                    cells.append("".join(t.text or "" for t in ist.iter(
                        "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}t"
                    )))
                elif v is not None:
                    cells.append(v.text)
                else:
                    cells.append(None)
            rows.append(cells)
        return rows


def read_taxonomy(path: str) -> List[Dict[str, str]]:
    """Read a taxonomy file (.xlsx or .csv) into row dicts keyed by header."""
    if path.lower().endswith(".csv"):
        import csv

        with open(path, encoding="utf-8") as f:
            return [dict(r) for r in csv.DictReader(f)]
    rows = read_xlsx(path)
    if not rows:
        return []
    header = [h or "" for h in rows[0]]
    out = []
    for r in rows[1:]:
        d = {}
        for i, h in enumerate(header):
            if h:
                d[h] = r[i] if i < len(r) and r[i] is not None else ""
        if any(v for v in d.values()):
            out.append(d)
    return out


def _esc(s: str) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def write_xlsx(path: str, rows: List[List[str]]) -> None:
    """Minimal single-sheet xlsx with inline strings (fixtures only)."""
    def colname(i: int) -> str:
        s = ""
        i += 1
        while i:
            i, r = divmod(i - 1, 26)
            s = chr(65 + r) + s
        return s

    sheet_rows = []
    for ri, row in enumerate(rows, 1):
        cells = "".join(
            f'<c r="{colname(ci)}{ri}" t="inlineStr"><is><t>{_esc(v)}</t></is></c>'
            for ci, v in enumerate(row)
        )
        sheet_rows.append(f'<row r="{ri}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(sheet_rows)}</sheetData></worksheet>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" '
        'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
