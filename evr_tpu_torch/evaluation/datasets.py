"""Evaluation dataset loaders.

Counterpart of ``evr_tpu/evaluation/datasets.py``. Reference inputs
(`compare_models.py`, `README.md:153-158`):

- Flickr30k-style CSV: ``image_name| comment_number| comment`` rows, 5
  captions per image (`Flickr30kDataset`, `compare_models.py:90-150`);
- Excel test sets with 3 columns — ``folder``, ``caption``, ``image`` where
  ``image`` holds ``;``-separated multi-ground-truth filenames, as ``.xlsx``
  (the stdlib reader, ``utils.xlsx``) or ``.csv`` (the ``csv`` module);
- fallback fixture generation: "a photo of {name}" captions synthesized from
  an image folder when no caption file exists (`compare_models.py:1710-1731`).

The JAX package reads the test sets through a pandas DataFrame; the port
reads their cells as text with no pandas (the card's machine has none), so
the cells keep their spelling: a folder named ``01`` in a CSV stays ``01``
where pandas would infer the integer 1, and an empty CSV cell is ``""``
where pandas gives ``"nan"``. Only the legacy ``.xls`` format needs pandas.
"""

from __future__ import annotations

import csv
import pathlib
from dataclasses import dataclass, field


@dataclass
class CaptionsTable:
    """Image paths + captions with image-id alignment for retrieval eval."""

    image_ids: list[str] = field(default_factory=list)  # unique image ids
    image_paths: dict[str, str] = field(default_factory=dict)  # id → path
    captions: list[str] = field(default_factory=list)
    caption_image_ids: list[str] = field(default_factory=list)
    # multi-ground-truth: caption index → list of valid image ids
    caption_gt_ids: list[list[str]] | None = None

    def add_image(self, image_id: str, path: str) -> None:
        if image_id not in self.image_paths:
            self.image_ids.append(image_id)
        self.image_paths[image_id] = path

    def add_caption(self, caption: str, image_id: str, gt_ids: list[str] | None = None):
        self.captions.append(caption)
        self.caption_image_ids.append(image_id)
        if gt_ids is not None:
            if self.caption_gt_ids is None:
                self.caption_gt_ids = [[cid] for cid in self.caption_image_ids[:-1]]
            self.caption_gt_ids.append(gt_ids)

    @property
    def ordered_paths(self) -> list[str]:
        return [self.image_paths[i] for i in self.image_ids]


def load_captions_csv(
    csv_path,
    images_dir,
    delimiter: str = "|",
    max_images: int | None = 1000,
) -> CaptionsTable:
    """Flickr30k-results-style CSV (image_name| comment_number| comment)."""
    images_dir = pathlib.Path(images_dir)
    table = CaptionsTable()
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=delimiter)
        next(reader, None)  # header
        for row in reader:
            if len(row) < 3:
                continue
            name = row[0].strip()
            caption = row[2].strip()
            if max_images is not None and name not in table.image_paths and len(table.image_ids) >= max_images:
                continue
            path = images_dir / name
            if not path.exists():
                continue
            table.add_image(name, str(path))
            table.add_caption(caption, name)
    return table


def _table_rows(path: pathlib.Path) -> tuple[list[str], list[list]]:
    """(header, data rows) of a test set's first sheet or its CSV, each data
    row padded with None to the header's width."""
    suffix = path.suffix.lower()
    if suffix == ".xlsx":
        from evr_tpu_torch.utils.xlsx import read_xlsx

        rows = next(iter(read_xlsx(path).values()), [])
        if not rows:
            raise ValueError(f"{path.name}: first sheet is empty")
    elif suffix == ".xls":
        import pandas as pd  # legacy BIFF needs a real engine

        df = pd.read_excel(path)
        rows = [list(df.columns)] + df.values.tolist()
    else:
        with open(path, newline="", encoding="utf-8") as f:
            rows = [r for r in csv.reader(f)]
        if not rows:
            raise ValueError(f"{path.name}: empty test set")
    width = max(len(r) for r in rows)
    rows = [list(r) + [None] * (width - len(r)) for r in rows]
    return [str(c) for c in rows[0]], rows[1:]


def load_excel_testset(path, images_root) -> CaptionsTable:
    """3-column test set: folder | caption | image (';'-separated multi-GT),
    as .xlsx, .csv (or legacy .xls, through pandas)."""
    path = pathlib.Path(path)
    images_root = pathlib.Path(images_root)
    header, rows = _table_rows(path)
    cols = {c.lower().strip(): i for i, c in enumerate(header)}
    folder_col = cols.get("folder", 0)
    caption_col = cols.get("caption", 1)
    image_col = cols.get("image", 2)

    table = CaptionsTable()
    table.caption_gt_ids = []
    for row in rows:
        folder = str(row[folder_col]).strip()
        caption = str(row[caption_col]).strip()
        images = [s.strip() for s in str(row[image_col]).split(";") if s.strip()]
        gt_ids = []
        for img in images:
            image_id = f"{folder}/{img}"
            p = images_root / folder / img
            if not p.exists():
                continue
            table.add_image(image_id, str(p))
            gt_ids.append(image_id)
        if not gt_ids:
            continue
        table.captions.append(caption)
        table.caption_image_ids.append(gt_ids[0])
        table.caption_gt_ids.append(gt_ids)
    return table


def synthesize_from_folder(images_dir, max_images: int | None = None) -> CaptionsTable:
    """Fixture generator parity (`compare_models.py:1710-1731`): caption each
    image 'a photo of {stem}'."""
    images_dir = pathlib.Path(images_dir)
    table = CaptionsTable()
    names = sorted(
        p for p in images_dir.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    if max_images:
        names = names[:max_images]
    for p in names:
        table.add_image(p.name, str(p))
        table.add_caption(f"a photo of {p.stem}", p.name)
    return table
