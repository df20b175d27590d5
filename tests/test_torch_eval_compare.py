"""The port's comparison harness (``evaluation.compare``) over the port's
``EmbeddingEngine`` against ``evr_tpu``'s harness over the JAX engine, on
the CPU: the same seeded ViT-Tiny-Test params ("original" and a perturbed
"finetuned"), the same JPEGs and captions (with multi-ground-truth rows, so
the P@K pass runs). Metrics within 1e-5, ranks equal; the JSON, CSV and
XLSX reports hold the same cells (numbers within 1e-5; the encode seconds
are each run's own)."""

import csv
import json

import numpy as np
import pytest

from evr_tpu.evaluation import EngineAdapter as JEngineAdapter
from evr_tpu.evaluation import ModelComparison as JModelComparison
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.utils.xlsx import read_xlsx as j_read_xlsx
from evr_tpu_torch.evaluation import CaptionsTable, EngineAdapter, ModelComparison
from evr_tpu_torch.index import EmbeddingEngine
from evr_tpu_torch.models import get_model_config, init_clip_params
from evr_tpu_torch.utils.xlsx import read_xlsx

MODEL = "ViT-Tiny-Test"
TOL = 1e-5
WORDS = ("a", "red", "car", "crowd", "street", "dog", "boat", "sign", "night", "fight", "water")


def _close(got, ref, where=""):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), where
        for k in ref:
            _close(got[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=where)
    else:
        assert got == ref, where


def _cell(v: str):
    try:
        return float(v)
    except ValueError:
        return v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("compare")
    rng = np.random.default_rng(0)
    ds = CaptionsTable()
    for i in range(16):
        img = np.zeros((60, 80, 3), np.uint8)
        img[:] = rng.integers(0, 255, 3)
        x, y = rng.integers(0, 60, 2)
        img[y % 40 : y % 40 + 20, x : x + 20] = rng.integers(0, 255, 3)
        path = root / f"{i:02d}.jpg"
        cv2.imwrite(str(path), img)
        ds.add_image(path.name, str(path))
    for j in range(40):
        gts = sorted({ds.image_ids[j % 16], ds.image_ids[int(rng.integers(0, 16))]})
        ds.add_caption(" ".join(rng.choice(WORDS, size=5)), gts[0], gt_ids=gts)
    cfg = get_model_config(MODEL)
    np_params = init_clip_params(31, cfg)
    tuned = {k: v for k, v in np_params.items()}
    proj = np_params["visual"]["proj"]
    tuned["visual"] = dict(np_params["visual"],
                           proj=proj + proj.std() * rng.standard_normal(proj.shape).astype(np.float32))
    engine = EmbeddingEngine(MODEL, params=np_params, device="cpu", batch_size=8)
    jengine = JEngine(MODEL, params=np_params, batch_size=8)
    for e in (engine, jengine):
        e.register_model("finetuned", tuned)
    out = {}
    for tag, comp_cls, adapter in (("port", ModelComparison, EngineAdapter),
                                   ("jax", JModelComparison, JEngineAdapter)):
        e = engine if tag == "port" else jengine
        kw = {"device": "cpu"} if tag == "port" else {}
        comp = comp_cls(output_dir=root / tag, log=lambda *_: None, **kw)
        comp.register("clip_original", lambda e=e: adapter(e, "original"))
        comp.register("clip_finetuned", lambda e=e: adapter(e, "finetuned"))
        comp.run_evaluation(ds)
        out[tag] = comp
    return out


def test_results_match_jax(runs):
    got, ref = runs["port"].results, runs["jax"].results
    assert list(got) == list(ref) == ["clip_original", "clip_finetuned"]
    for name in ref:
        g = {k: v for k, v in got[name].items() if not k.endswith("_seconds")}
        r = {k: v for k, v in ref[name].items() if not k.endswith("_seconds")}
        _close(g, r, name)
        assert {"P@1", "P@5", "P@10"} <= set(g["multi_gt"])
    assert got["clip_original"]["mean"] != got["clip_finetuned"]["mean"]


def test_json_and_csv_reports_match_jax(runs):
    g = json.loads(runs["port"].save_json().read_text())
    r = json.loads(runs["jax"].save_json().read_text())
    drop = lambda d: {n: {k: v for k, v in res.items() if not k.endswith("_seconds")} for n, res in d.items()}
    _close(drop(g), drop(r))
    assert not any(k.endswith("_ranks") for res in g.values() for k in res)
    rows = {}
    for tag in ("port", "jax"):
        with open(runs[tag].save_csv(), newline="") as f:
            rows[tag] = [[_cell(c) for c in row] for row in csv.reader(f)]
    _close(rows["port"], rows["jax"])
    assert rows["port"][0] == ["model", "direction", "R@1", "R@5", "R@10", "MRR", "Median_Rank",
                               "Mean_Rank", "rsum"]


def test_xlsx_report_and_table_match_jax(runs):
    g = read_xlsx(runs["port"].save_xlsx())
    r = j_read_xlsx(runs["jax"].save_xlsx())
    assert list(g) == ["Text-to-Image", "Image-to-Text", "Mean Metrics"]
    _close(g, r)
    assert g["Mean Metrics"][0][-1] == "rsum" and len(g["Text-to-Image"]) == 3
    assert runs["port"].format_table().splitlines()[0] == runs["jax"].format_table().splitlines()[0]
    chart = runs["port"].save_charts()
    assert chart is not None and chart.exists()
