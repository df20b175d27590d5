"""The int8 serving gate of the PyTorch port
(``evr_tpu_torch.models.quant_gate``) against ``evr_tpu.models.quant_gate``.

Both gates run on engines holding the same ViT-Tiny-Test params (carried
across as numpy) over the same staged frames: the reports must agree, the
ranking statistics exactly and the worst frame cosine within 1e-5 (both
encode in fp32 on the CPU; the int8 towers may differ where a LayerNorm
output in its last bit moves an activation across a quantisation step).
"""

import json
import logging

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models import quant_gate as jgate
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.models import quant_gate as tgate

MODEL = "ViT-Tiny-Test"


@pytest.fixture(scope="module")
def params():
    cfg = get_model_config(MODEL)
    return cfg, jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))


def _engines(params, **kw):
    cfg, p = params
    return (JEngine(MODEL, params=p, cfg=cfg, batch_size=8, **kw),
            TEngine(MODEL, params=p, batch_size=8, device="cpu", **kw))


def _frames(n, seed=0, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_gate_constants_match_jax():
    assert tgate.DEFAULT_GATE_QUERIES == jgate.DEFAULT_GATE_QUERIES
    assert list(tgate.GateReport.__dataclass_fields__) == list(jgate.GateReport.__dataclass_fields__)


@pytest.mark.parametrize("top_k", [1, 10, 50])
def test_ranking_agreement_matches_jax(top_k):
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((30, 6)).astype(np.float32)
    test = ref + 0.05 * rng.standard_normal(ref.shape).astype(np.float32)
    test[:, 2] = ref[:, 2]  # one query ranks identically
    assert tgate.ranking_agreement(ref, test, top_k) == jgate.ranking_agreement(ref, test, top_k)


def test_run_quant_gate_matches_jax(params):
    jeng, teng = _engines(params)
    staged = _frames(12)
    ref = jgate.run_quant_gate(jeng, staged).as_dict()
    got = tgate.run_quant_gate(teng, staged).as_dict()
    assert abs(got.pop("min_frame_cosine") - ref.pop("min_frame_cosine")) <= 1e-5
    assert got == ref
    # the gate leaves the engine's serving weights as they were
    assert teng.params_dtype == "float32"
    assert "kernel" in teng.params["visual"]["blocks"][0]["attn"]["qkv"]


def test_sample_corpus_frames_match_jax(tmp_path):
    """An empty data root gives the seeded synthetic frames; a root with
    frames gives the same evenly strided sample, staged alike."""
    jroot, troot = JRoot(tmp_path / "jax"), TRoot(tmp_path / "torch")
    np.testing.assert_array_equal(tgate.sample_corpus_frames(troot, 64),
                                  jgate.sample_corpus_frames(jroot, 64))
    for root in (jroot, troot):
        root.ensure()
        for v in range(2):
            d = root.frames_dir / f"video{v}"
            d.mkdir(parents=True)
            for i, f in enumerate(_frames(5, seed=v, size=80)):
                cv2.imwrite(str(d / f"{i}.jpg"), f)
    got = tgate.sample_corpus_frames(troot, 64, limit=4)
    np.testing.assert_array_equal(got, jgate.sample_corpus_frames(jroot, 64, limit=4))
    assert got.shape == (4, 64, 64, 3)


@pytest.mark.parametrize("passed", [True, False])
def test_auto_params_dtype_follows_the_gate(params, tmp_path, monkeypatch, caplog, passed):
    """``--params-dtype auto``: int8 when the gate passes, bfloat16 when it
    fails; the decision is logged."""
    _, teng = _engines(params)
    report = tgate.run_quant_gate(teng, tgate.sample_corpus_frames(TRoot(tmp_path), 64))
    report.passed = passed
    monkeypatch.setattr(tgate, "run_quant_gate", lambda engine, staged: report)
    log = logging.getLogger("test_auto_params_dtype")
    with caplog.at_level(logging.INFO, logger=log.name):
        got = tgate.auto_params_dtype(teng, TRoot(tmp_path), log=log)
    assert got is report
    assert teng.params_dtype == ("int8" if passed else "bfloat16")
    assert ("PASSED" if passed else "FAILED") in caplog.text
    assert teng.params_dtype in caplog.text


def test_auto_params_dtype_decides_as_jax(params, tmp_path):
    """Unpatched, on the same params and data root, both packages reach the
    same report and serve the same format."""
    jeng, teng = _engines(params)
    ref = jgate.auto_params_dtype(jeng, JRoot(tmp_path))
    got = tgate.auto_params_dtype(teng, TRoot(tmp_path))
    assert got.passed == ref.passed
    assert teng.params_dtype == jeng.params_dtype == ("int8" if got.passed else "bfloat16")
    print("gate on random ViT-Tiny-Test weights:", json.dumps(got.as_dict()))


def test_int8_weights_cannot_widen_back(params):
    """int8 → float raises; float → int8 quantizes every registered model and
    clears the text cache."""
    cfg, p = params
    teng = TEngine(MODEL, params=p, batch_size=8, device="cpu")
    teng.register_model("second", p)
    teng.get_text_features("a cached query")
    assert teng._text_cache
    teng.set_params_dtype("int8")
    assert not teng._text_cache
    for slot in teng.models.values():
        assert "kernel_q" in slot["clip"]["text"]["blocks"][0]["attn"]["qkv"]
    with pytest.raises(ValueError, match="cannot widen int8"):
        teng.set_params_dtype("bfloat16")
    with pytest.raises(ValueError, match="cannot widen int8"):
        TEngine(MODEL, params=p, device="cpu", params_dtype="int8").set_params_dtype("float32")
