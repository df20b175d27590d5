"""The port's classification benchmark (``evaluation.classification``,
``zeroshot``, ``projection_align``) against ``evr_tpu.evaluation`` on the
CPU: ``_prf`` and the ridge probe on seeded features and labels (equal, the
same numpy), the trained-head mode through both engines' ``classify`` over
one reference checkpoint, and zero-shot classifiers built by both engines'
text towers from the same seeded ViT-Tiny-Test params (class embeddings
within 1e-5; predictions and metrics then equal).
"""

import jax
import numpy as np
import pytest

from evr_tpu.evaluation import classification as jcls
from evr_tpu.evaluation import projection_align as jproj
from evr_tpu.evaluation import zeroshot as jzs
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models import init_classifier_params as jinit_classifier
from evr_tpu.models import torch_export as jexport
from evr_tpu_torch.evaluation import classification as tcls
from evr_tpu_torch.evaluation import projection_align as tproj
from evr_tpu_torch.evaluation import zeroshot as tzs
from evr_tpu_torch.index import EmbeddingEngine
from evr_tpu_torch.models import get_model_config, init_clip_params

MODEL = "ViT-Tiny-Test"
CLASSES = ["Violence", "Sensitive", "NonViolence"]


def _assert_reports_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_reports_equal(got[k], v)
        elif isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.fixture(scope="module")
def engines():
    np_params = init_clip_params(21, get_model_config(MODEL))
    return (EmbeddingEngine(MODEL, params=np_params, device="cpu", batch_size=8),
            JEngine(MODEL, params=np_params, batch_size=8))


def _features(seed=0, n=60, d=32, c=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, size=n)
    centres = rng.standard_normal((c, d))
    feats = (centres[labels] + 1.2 * rng.standard_normal((n, d))).astype(np.float32)
    return feats / np.linalg.norm(feats, axis=1, keepdims=True), labels


@pytest.mark.parametrize("case", ["seeded", "never_predicted", "perfect"])
def test_prf_matches_jax(case):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 3, size=50)
    pred = {"seeded": rng.integers(0, 3, size=50), "never_predicted": np.where(y == 2, 0, y),
            "perfect": y.copy()}[case]
    _assert_reports_equal(tcls._prf(y, pred, 3), jcls._prf(y, pred, 3))


def test_linear_probe_and_its_evaluation_match_jax():
    feats, labels = _features()
    W = tcls.fit_linear_probe(feats, labels, 3)
    np.testing.assert_array_equal(W, jcls.fit_linear_probe(feats, labels, 3))
    np.testing.assert_array_equal(tcls.probe_predict(W, feats), jcls.probe_predict(W, feats))
    mask = np.arange(len(labels)) % 3 != 0
    for kw in ({}, {"train_mask": mask}):
        got = tcls.evaluate_classification(feats, labels, n_classes=3, **kw)
        ref = jcls.evaluate_classification(feats, labels, n_classes=3, **kw)
        assert got["mode"] == "linear_probe"
        _assert_reports_equal(got, ref)


def test_trained_head_mode_through_both_engines(tmp_path, engines):
    engine, jengine = engines
    head = jax.tree.map(np.asarray, jinit_classifier(
        jax.random.PRNGKey(3), JClassifierConfig(embed_dim=32, num_classes=3)))
    np_params = init_clip_params(21, get_model_config(MODEL))
    jexport.save_reference_checkpoint(tmp_path / "ref.pt", np_params, head)
    engine.load_finetuned(tmp_path / "ref.pt")
    jengine.load_finetuned(str(tmp_path / "ref.pt"))
    engine.set_active_model("finetuned")
    jengine.set_active_model("finetuned")
    try:
        feats, labels = _features(seed=4)
        np.testing.assert_allclose(engine.classify(feats), jengine.classify(feats), rtol=0, atol=1e-5)
        got = tcls.evaluate_classification(feats, labels, 3, classifier_fn=engine.classify)
        ref = jcls.evaluate_classification(feats, labels, 3, classifier_fn=jengine.classify)
        assert got["mode"] == "trained_head"
        _assert_reports_equal(got, ref)
    finally:
        engine.set_active_model("original")
        jengine.set_active_model("original")


def test_zeroshot_classifier_and_metrics_match_jax(engines):
    engine, jengine = engines
    got_w = tzs.build_zeroshot_classifier(lambda p: engine.encode_texts(p, normalise=False), CLASSES)
    ref_w = jzs.build_zeroshot_classifier(lambda p: jengine.encode_texts(p, normalise=False), CLASSES)
    assert got_w.shape == (32, 3)
    np.testing.assert_allclose(got_w, ref_w, rtol=0, atol=1e-5)
    feats, labels = _features(seed=5)
    np.testing.assert_array_equal(tzs.zeroshot_predict(feats, ref_w), jzs.zeroshot_predict(feats, ref_w))
    for topk in ((1, 5), (1, 2)):
        _assert_reports_equal(tzs.evaluate_zeroshot(feats, labels, ref_w, topk),
                              jzs.evaluate_zeroshot(feats, labels, ref_w, topk))
    assert tzs.DEFAULT_TEMPLATES == jzs.DEFAULT_TEMPLATES


def test_projection_alignment_matches_jax():
    rng = np.random.default_rng(6)
    src = rng.standard_normal((40, 24)).astype(np.float32)
    tgt = rng.standard_normal((40, 16)).astype(np.float32)
    W = tproj.fit_projection(src, tgt)
    np.testing.assert_array_equal(W, jproj.fit_projection(src, tgt))
    out = tproj.apply_projection(src, W)
    np.testing.assert_array_equal(out, jproj.apply_projection(src, W))
    mean, std = tgt.mean(0), tgt.std(0)
    np.testing.assert_array_equal(tproj.statistical_renormalize(out, mean, std),
                                  jproj.statistical_renormalize(out, mean, std))
