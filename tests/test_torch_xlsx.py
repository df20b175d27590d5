"""The port's workbook reader and writer (``utils.xlsx``), the Excel test
set (``evaluation.datasets.load_excel_testset``) and the test-set
translation (``data_prep.translate_testset``) against ``evr_tpu``'s on the
CPU. ``zipfile`` stamps each part with the time of writing, so workbooks are
compared part by part and through ``read_xlsx``, never byte for byte."""

import zipfile

import pytest

from evr_tpu.data_prep.translate_testset import translate_testset_csv as j_translate
from evr_tpu.evaluation.datasets import load_excel_testset as j_load_excel
from evr_tpu.utils import xlsx as jx
from evr_tpu_torch.data_prep import translate_testset_csv
from evr_tpu_torch.evaluation.datasets import load_excel_testset
from evr_tpu_torch.utils import xlsx as tx

SHEETS = {
    "Text-to-Image": [["", "R@1", "R@5"], ["clip_original", 0.25, 1.0], ["clip_finetuned", 1 / 3, True]],
    "Bad[name]:with*chars? and a very long tail beyond 31 chars": [["một túi thịt gà", None, -7, " pad "]],
    "Mean Metrics": [["m", 2, 2.5e-17], [], ["after a gap", "&<>\"'"]],
}

TESTSET = [
    ["Folder", "Caption", "Image"],
    ["vidA", "hai người đánh nhau trong phòng", "10.jpg;25.jpg"],
    ["vidA", "a caption already in english", "40.jpg"],
    ["vidB", "xe máy trên đường phố", " 5.jpg ; 99.jpg"],  # 99.jpg is missing
    ["vidB", "no image exists", "404.jpg"],
    ["vidA", "người đàn ông đang chạy", "25.jpg;10.jpg;40.jpg"],
]


def _parts(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("writer,reader", [(tx, tx), (tx, jx), (jx, tx)])
def test_workbooks_round_trip_across_packages(tmp_path, writer, reader):
    path = writer.write_xlsx(tmp_path / "w.xlsx", SHEETS)
    got = reader.read_xlsx(path)
    assert got == jx.read_xlsx(path)
    names = list(got)
    assert names[0] == "Text-to-Image" and names[2] == "Mean Metrics"
    assert "[" not in names[1] and len(names[1]) <= 31
    assert got["Text-to-Image"] == SHEETS["Text-to-Image"]
    assert got["Mean Metrics"] == [["m", 2, 2.5e-17], [], ["after a gap", "&<>\"'"]]
    assert isinstance(got["Mean Metrics"][0][1], int)


def test_written_parts_equal_jax_parts(tmp_path):
    t = _parts(tx.write_xlsx(tmp_path / "t.xlsx", SHEETS))
    j = _parts(jx.write_xlsx(tmp_path / "j.xlsx", SHEETS))
    assert t == j
    assert _parts(tx.write_xlsx(tmp_path / "e.xlsx", {})) == _parts(jx.write_xlsx(tmp_path / "f.xlsx", {}))


def _images(root):
    for folder, names in (("vidA", ("10.jpg", "25.jpg", "40.jpg")), ("vidB", ("5.jpg",))):
        (root / folder).mkdir(parents=True)
        for n in names:
            (root / folder / n).write_bytes(b"x")


@pytest.mark.parametrize("suffix", [".xlsx", ".csv"])
def test_excel_testset_matches_jax(tmp_path, suffix):
    _images(tmp_path / "imgs")
    path = tmp_path / f"testset{suffix}"
    if suffix == ".xlsx":
        tx.write_xlsx(path, {"Sheet1": TESTSET})
    else:
        path.write_text("\n".join(",".join(r) for r in TESTSET), encoding="utf-8")
    got = load_excel_testset(path, tmp_path / "imgs")
    ref = j_load_excel(path, tmp_path / "imgs")
    assert got.__dict__ == ref.__dict__
    assert got.caption_gt_ids[0] == ["vidA/10.jpg", "vidA/25.jpg"]
    assert got.caption_gt_ids[2] == ["vidB/5.jpg"] and len(got.captions) == 4


@pytest.mark.parametrize("suffix", [".xlsx", ".csv"])
def test_translate_testset_matches_jax(tmp_path, suffix):
    src = tmp_path / f"vi{suffix}"
    if suffix == ".xlsx":
        tx.write_xlsx(src, {"Sheet1": TESTSET + [["vidC", 3, None]]})
    else:
        src.write_text("\n".join(",".join(r) for r in TESTSET) + "\n\nvidC,3\n", encoding="utf-8")
    n = translate_testset_csv(src, tmp_path / f"t{suffix}")
    assert n == j_translate(src, tmp_path / f"j{suffix}") == len(TESTSET)
    if suffix == ".xlsx":
        got, ref = tx.read_xlsx(tmp_path / "t.xlsx"), jx.read_xlsx(tmp_path / "j.xlsx")
        rows = got["Sheet1"]
    else:
        got = (tmp_path / "t.csv").read_text(encoding="utf-8")
        ref = (tmp_path / "j.csv").read_text(encoding="utf-8")
        rows = [r.split(",") for r in got.splitlines()]
    assert got == ref
    assert "two people fighting in a room" in rows[1][1] and rows[1][2] == "10.jpg;25.jpg"
    # a translator that fails keeps the caption, as in the JAX package
    def broken(_):
        raise RuntimeError("offline")

    assert translate_testset_csv(src, tmp_path / f"k{suffix}", translator=broken) == n


def test_translate_testset_refuses_what_jax_refuses(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\n")
    for fn in (translate_testset_csv, j_translate):
        with pytest.raises(ValueError, match="caption"):
            fn(bad, tmp_path / "out.csv")
    short = tmp_path / "short.csv"
    short.write_text("folder,image,caption\nvidA,1.jpg\n")
    for fn in (translate_testset_csv, j_translate):
        with pytest.raises(ValueError, match="columns"):
            fn(short, tmp_path / "out.csv")
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        translate_testset_csv(empty, tmp_path / "out.csv")
