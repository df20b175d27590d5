"""The port's benchmark CLIs (``tools.evaluate``, ``ab_compare``,
``diagnose``) against the JAX package's, on the CPU (``--device cpu``).

Both packages' ``EmbeddingEngine`` are replaced by subclasses that start
from the same seeded ViT-Tiny-Test params (the CLIs otherwise draw random
weights from each package's own generator); the fine-tuned model is one
reference ``.pt`` file of perturbed weights with a 3-class head, read by
both. The reports must hold the same cells: metrics within 1e-5, ranks,
predictions and frames equal; the encode seconds are each run's own.
"""

import contextlib
import csv
import io
import json

import numpy as np
import pytest

import evr_tpu.index as jindex
import evr_tpu_torch.index as tindex
from evr_tpu.tools import ab_compare as j_ab
from evr_tpu.tools import diagnose as j_diag
from evr_tpu.tools import evaluate as j_eval
from evr_tpu.utils.xlsx import read_xlsx as j_read_xlsx
from evr_tpu_torch.models import ClassifierConfig, get_model_config, init_classifier_params, init_clip_params
from evr_tpu_torch.models.torch_export import save_reference_checkpoint
from evr_tpu_torch.tools import ab_compare as t_ab
from evr_tpu_torch.tools import diagnose as t_diag
from evr_tpu_torch.tools import evaluate as t_eval
from evr_tpu_torch.utils.xlsx import read_xlsx, write_xlsx
from torch_threads import one_torch_thread  # noqa: F401

MODEL = "ViT-Tiny-Test"
TOL = 1e-5
CLASSES = ("Violence", "Sensitive", "NonViolence")
WORDS = ("a", "red", "car", "crowd", "street", "dog", "boat", "sign", "night", "fight", "water")


def _close(got, ref, where=""):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), where
        for k in ref:
            if not k.endswith("_seconds"):
                _close(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{where}[{i}]")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=where)
    else:
        assert got == ref, where


def _jpegs(folder, n, rng):
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = np.zeros((60, 80, 3), np.uint8)
        img[:] = rng.integers(0, 255, 3)
        x, y = rng.integers(0, 40, 2)
        img[y : y + 20, x : x + 30] = rng.integers(0, 255, 3)
        cv2.imwrite(str(folder / f"{i:02d}.jpg"), img)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Images with a captions CSV, an Excel test set over two folders,
    three class folders, and the fine-tuned reference file."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    _jpegs(root / "imgs", 12, rng)
    rows = ["image_name| comment_number| comment"]
    rows += [f"{i:02d}.jpg| {c}| {' '.join(rng.choice(WORDS, size=5))}" for i in range(12) for c in range(3)]
    (root / "captions.csv").write_text("\n".join(rows))
    for folder in ("vidA", "vidB"):
        _jpegs(root / "excel" / folder, 6, rng)
    sheet = [["folder", "caption", "image"]]
    for j in range(10):
        folder = ("vidA", "vidB")[j % 2]
        imgs = sorted({f"{int(rng.integers(0, 6)):02d}.jpg" for _ in range(1 + j % 3)})
        sheet.append([folder, " ".join(rng.choice(WORDS, size=4)), ";".join(imgs)])
    write_xlsx(root / "testset.xlsx", {"Sheet1": sheet})
    for c in CLASSES:
        _jpegs(root / "cls" / c, 5, rng)
    cfg = get_model_config(MODEL)
    params = init_clip_params(41, cfg)
    tuned = dict(params, visual=dict(params["visual"], proj=params["visual"]["proj"]
                                     + 0.05 * rng.standard_normal(params["visual"]["proj"].shape).astype(np.float32)))
    head = init_classifier_params(42, ClassifierConfig(embed_dim=cfg.embed_dim, num_classes=3))
    save_reference_checkpoint(root / "ft.pt", tuned, head)
    return root, params


@pytest.fixture
def engines(monkeypatch, data):
    """Both packages' engines, from the same seeded params."""
    _, params = data

    class TEngine(tindex.EmbeddingEngine):
        def __init__(self, model_name=MODEL, **kw):
            super().__init__(model_name, params=kw.pop("params", params), batch_size=8, **kw)

    class JEngine(jindex.EmbeddingEngine):
        def __init__(self, model_name=MODEL, **kw):
            super().__init__(model_name, params=kw.pop("params", params), batch_size=8, **kw)

    monkeypatch.setattr(tindex, "EmbeddingEngine", TEngine)
    monkeypatch.setattr(jindex, "EmbeddingEngine", JEngine)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _cell(v: str):
    try:
        return float(v)
    except ValueError:
        return v


def _reports(folder):
    with open(folder / "comparison_results.csv", newline="") as f:
        table = [[_cell(c) for c in r] for r in csv.reader(f)]
    return json.loads((folder / "comparison_results.json").read_text()), table


@pytest.mark.parametrize("source", ["captions", "excel"])
def test_evaluate_retrieval_matches_jax_cli(tmp_path, data, engines, source):
    root, _ = data
    args = ["--model", MODEL, "--checkpoint", str(root / "ft.pt")]
    if source == "captions":
        args += ["--images-dir", str(root / "imgs"), "--captions-csv", str(root / "captions.csv")]
    else:
        args += ["--images-dir", str(root / "excel"), "--excel", str(root / "testset.xlsx")]
    results = t_eval.main(args + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    _run(j_eval.main, args + ["--output-dir", str(tmp_path / "j")])
    got, ref = _reports(tmp_path / "t"), _reports(tmp_path / "j")
    _close(got, ref)
    _close(read_xlsx(tmp_path / "t" / "comparison_results.xlsx"),
           j_read_xlsx(tmp_path / "j" / "comparison_results.xlsx"))
    assert list(results) == ["clip_original", "clip_finetuned"]
    assert results["clip_original"]["mean"] != results["clip_finetuned"]["mean"]
    assert ("multi_gt" in got[0]["clip_original"]) == (source == "excel")


@pytest.mark.parametrize("zeroshot", [False, True])
def test_evaluate_classification_matches_jax_cli(tmp_path, data, engines, zeroshot):
    root, _ = data
    args = ["--model", MODEL, "--images-dir", str(root / "imgs"), "--checkpoint", str(root / "ft.pt"),
            "--classification-dirs", *(f"{c}={root / 'cls' / c}" for c in CLASSES)]
    args += ["--zeroshot"] if zeroshot else []
    t_eval.main(args + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    _run(j_eval.main, args + ["--output-dir", str(tmp_path / "j")])
    got = json.loads((tmp_path / "t" / "classification_results.json").read_text())
    ref = json.loads((tmp_path / "j" / "classification_results.json").read_text())
    _close(got, ref)
    modes = {m: r["mode"] for m, r in got.items()}
    assert modes == ({"original": "zeroshot", "finetuned": "zeroshot"} if zeroshot
                     else {"original": "linear_probe", "finetuned": "trained_head"})


def test_ab_compare_matches_jax_cli(tmp_path, data, engines):
    root, _ = data
    args = ["--frames-dir", str(root / "imgs"), "--queries", "a red car", "a crowd at night",
            "--model", MODEL, "--checkpoint", str(root / "ft.pt"), "--top-k", "5"]
    t_ab.main(args + ["--output", str(tmp_path / "t.json"), "--device", "cpu"])
    _run(j_ab.main, args + ["--output", str(tmp_path / "j.json")])
    got, ref = json.loads((tmp_path / "t.json").read_text()), json.loads((tmp_path / "j.json").read_text())
    _close(got, ref)
    assert len(got["finetuned"]["a red car"]) == 5 and got["original"] != got["finetuned"]


@pytest.mark.parametrize("checkpoint", [False, True])
def test_diagnose_matches_jax_cli(data, engines, checkpoint):
    root, _ = data
    args = ["--model", MODEL, "--batch-sizes", "1", "3"]
    args += ["--checkpoint", str(root / "ft.pt")] if checkpoint else []
    rc, out = _run(t_diag.main, args + ["--device", "cpu"])
    jrc, jout = _run(j_diag.main, args)
    got, ref = json.loads(out), json.loads(jout)
    _close(got, ref)
    assert rc == jrc == 0 and got["dtype"]["dtypes"] == ["float32"]


def test_the_tools_need_a_card_unless_the_cpu_is_asked_for(monkeypatch, data, tmp_path):
    import torch

    root, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, ft = str(root / "imgs"), str(root / "ft.pt")
    for main, args in ((t_eval.main, ["--images-dir", imgs, "--output-dir", str(tmp_path)]),
                       (t_diag.main, []),
                       (t_ab.main, ["--frames-dir", imgs, "--queries", "x", "--checkpoint", ft,
                                    "--output", str(tmp_path / "o.json")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + ["--model", MODEL])
