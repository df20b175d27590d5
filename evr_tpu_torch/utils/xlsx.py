"""Dependency-free .xlsx read/write (stdlib zipfile + ElementTree).

A copy of ``evr_tpu/utils/xlsx.py`` (stdlib only; the port imports nothing
of the JAX package). The reference exports its model-comparison report as a
multi-sheet Excel workbook (`Backend/content/Test_compare_model/
compare_models.py:1359-1381`) and its test sets arrive as .xlsx sheets; this
module implements the small OOXML-spreadsheet subset those flows need, with
no openpyxl:

- ``write_xlsx(path, sheets)``: multi-sheet workbooks with inline strings,
  numbers and booleans, readable by Excel, LibreOffice, openpyxl and pandas.
- ``read_xlsx(path)``: cell values per sheet, handling shared strings,
  inline strings, numbers, booleans and sparse rows (cells addressed by
  reference, gaps padded with None).

Formulas, styles, merged cells and dates-as-dates are out of scope (dates
round-trip as their serial numbers). ``zipfile`` stamps each part with the
current time, so two workbooks of the same cells differ byte for byte:
compare them through ``read_xlsx`` or part by part.
"""

from __future__ import annotations

import pathlib
import re
import zipfile
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

__all__ = ["write_xlsx", "read_xlsx"]

_INVALID_SHEET_CHARS = re.compile(r"[\[\]:*?/\\]")


def _sheet_name(name: str, used: set[str]) -> str:
    clean = _INVALID_SHEET_CHARS.sub(" ", str(name)).strip() or "Sheet"
    clean = clean[:31]
    base, i = clean, 2
    while clean.lower() in used:
        suffix = f" ({i})"
        clean, i = base[: 31 - len(suffix)] + suffix, i + 1
    used.add(clean.lower())
    return clean


def _col_letter(idx: int) -> str:
    """0-based column index → A1-style letters (0→A, 25→Z, 26→AA)."""
    letters = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return letters


def _col_index(ref: str) -> int:
    """A1-style cell reference → 0-based column index ("B7" → 1)."""
    n = 0
    for c in ref:
        if not c.isalpha():
            break
        n = n * 26 + (ord(c.upper()) - ord("A") + 1)
    return n - 1


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        # repr round-trips floats exactly; ints stay ints
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    space = ' xml:space="preserve"' if text != text.strip() else ""
    return f'<c r="{ref}" t="inlineStr"><is><t{space}>{text}</t></is></c>'


def write_xlsx(path, sheets) -> pathlib.Path:
    """Write a workbook. ``sheets`` is a mapping (or iterable of pairs)
    sheet-name → rows, where rows is an iterable of iterables of cell
    values (str/int/float/bool/None). Returns the written path."""
    items = list(sheets.items() if hasattr(sheets, "items") else sheets)
    if not items:
        items = [("Sheet1", [])]
    used: set[str] = set()
    names = [_sheet_name(n, used) for n, _ in items]

    sheet_xmls = []
    for _, rows in items:
        body = []
        for r, row in enumerate(rows, start=1):
            cells = "".join(
                _cell_xml(f"{_col_letter(c)}{r}", v) for c, v in enumerate(row)
            )
            body.append(f'<row r="{r}">{cells}</row>')
        sheet_xmls.append(
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main"><sheetData>'
            + "".join(body)
            + "</sheetData></worksheet>"
        )

    sheet_entries = "".join(
        f'<sheet name="{escape(n)}" sheetId="{i}" r:id="rId{i}"/>'
        for i, n in enumerate(names, start=1)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
        f'relationships"><sheets>{sheet_entries}</sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i}" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i}.xml"/>'
            for i in range(1, len(names) + 1)
        )
        + "</Relationships>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-'
        'package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i}.xml" '
            'ContentType="application/vnd.openxmlformats-officedocument.'
            'spreadsheetml.worksheet+xml"/>'
            for i in range(1, len(names) + 1)
        )
        + "</Types>"
    )

    path = pathlib.Path(path)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, xml in enumerate(sheet_xmls, start=1):
            zf.writestr(f"xl/worksheets/sheet{i}.xml", xml)
    return path


def _text_of(elem) -> str:
    """Concatenate every <t> descendant (rich-text runs split one string
    across multiple <r><t> children)."""
    return "".join(t.text or "" for t in elem.iter() if t.tag.endswith("}t") or t.tag == "t")


def _cell_value(cell, shared: list[str]):
    ctype = cell.get("t", "n")
    if ctype == "inlineStr":
        is_elem = cell.find("{*}is")
        return _text_of(is_elem) if is_elem is not None else None
    v = cell.find("{*}v")
    if v is None or v.text is None:
        return None
    if ctype == "s":
        return shared[int(v.text)]
    if ctype == "str":
        return v.text
    if ctype == "b":
        return v.text.strip() in ("1", "true", "TRUE")
    if ctype == "e":
        return None
    num = float(v.text)
    return int(num) if num.is_integer() and abs(num) < 2**53 else num


def read_xlsx(path) -> dict[str, list[list]]:
    """Read every sheet → {sheet_name: rows}. Rows are dense lists padded
    with None up to the rightmost populated cell of that row; trailing
    all-empty rows are kept only if the file materialises them."""
    with zipfile.ZipFile(path) as zf:
        shared: list[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            shared = [_text_of(si) for si in root.findall("{*}si")]

        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rels_root = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rid_ns = (
            "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id"
        )
        targets = {
            rel.get("Id"): rel.get("Target") for rel in rels_root.findall("{*}Relationship")
        }

        out: dict[str, list[list]] = {}
        for sheet in wb.find("{*}sheets").findall("{*}sheet"):
            target = targets.get(sheet.get(rid_ns), "")
            if target.startswith("/"):
                part = target.lstrip("/")
            else:
                part = "xl/" + target
            ws = ET.fromstring(zf.read(part))
            rows: list[list] = []
            for row in ws.find("{*}sheetData").findall("{*}row"):
                r_idx = int(row.get("r", len(rows) + 1)) - 1
                while len(rows) < r_idx:
                    rows.append([])
                values: list = []
                for cell in row.findall("{*}c"):
                    ref = cell.get("r")
                    c_idx = _col_index(ref) if ref else len(values)
                    while len(values) < c_idx:
                        values.append(None)
                    values.append(_cell_value(cell, shared))
                rows.append(values)
            out[sheet.get("name")] = rows
        return out
