"""Translate the caption column of a 3-column test set (vi→en).

Counterpart of ``evr_tpu/data_prep/translate_testset.py``. Reference:
`content/Translate_file_test_caption/translate.py` + `Backend/testtrans.py`
— GoogleTranslator over the Excel test set's caption column
(`README.md:153-158` format: folder | caption | image with ';'-separated
multi-ground-truth).

The translator is pluggable, with the zero-egress
``query.translate.DictionaryTranslator`` as the bundled local default; a
network provider can be injected for full-fidelity output. Reads and writes
both the native .xlsx sheet (the stdlib OOXML reader/writer in
``utils.xlsx``, no openpyxl) and its .csv rendering;
``evaluation.datasets.load_excel_testset`` consumes either::

    python -m evr_tpu_torch.data_prep.translate_testset testset_vi.xlsx testset_en.xlsx
"""

from __future__ import annotations

import csv
import pathlib
from typing import Callable


def translate_testset_csv(
    in_path,
    out_path,
    translator: Callable[[str], str] | None = None,
    caption_column: str = "caption",
) -> int:
    """Translate ``caption_column`` of a CSV or .xlsx test set in place of
    structure; all other columns pass through untouched. Returns rows
    written. .xlsx IO rides the stdlib OOXML reader/writer
    (``utils.xlsx``), so the reference's Excel sheets are handled
    directly — no openpyxl, no CSV round-trip."""
    if translator is None:
        from evr_tpu_torch.query.translate import DictionaryTranslator

        translator = DictionaryTranslator()

    in_path, out_path = pathlib.Path(in_path), pathlib.Path(out_path)
    if in_path.suffix.lower() == ".xlsx":
        from evr_tpu_torch.utils.xlsx import read_xlsx

        sheets = read_xlsx(in_path)
        raw = next(iter(sheets.values()), [])
        rows = [["" if v is None else v for v in r] for r in raw]
    else:
        with open(in_path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f)
            rows = list(reader)
    if not rows:
        raise ValueError(f"empty test set: {in_path}")
    header = rows[0]
    cols = {c.lower().strip(): i for i, c in enumerate(header)}
    if caption_column.lower() not in cols:
        raise ValueError(
            f"column {caption_column!r} not in header {header} of {in_path.name}"
        )
    ci = cols[caption_column.lower()]

    out_rows = [header]
    n = 0
    for row in rows[1:]:
        if not row:
            continue
        row = list(row)
        if len(row) <= ci:
            raise ValueError(
                f"{in_path.name}: row {n + 2} has {len(row)} columns, "
                f"caption column is #{ci + 1}: {row!r}"
            )
        try:
            row[ci] = translator(str(row[ci]))
        except Exception:
            pass  # translator failure keeps the untranslated caption,
            # as the reference does; structural errors raise above
        out_rows.append(row)
        n += 1

    if out_path.suffix.lower() == ".xlsx":
        from evr_tpu_torch.utils.xlsx import write_xlsx

        write_xlsx(out_path, {"Sheet1": out_rows})
    else:
        with open(out_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerows(out_rows)
    return n


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", help="3-column CSV test set (folder,caption,image)")
    ap.add_argument("output", help="translated CSV path")
    ap.add_argument("--caption-column", default="caption")
    args = ap.parse_args(argv)
    n = translate_testset_csv(args.input, args.output,
                              caption_column=args.caption_column)
    print(f"translated {n} rows → {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
