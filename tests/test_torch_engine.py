"""The PyTorch port's EmbeddingEngine against the JAX package's, on the CPU.

Same ViT-Tiny-Test params carried across, same frames and queries; float32
on both sides. Tolerance: atol 2e-4 on embeddings, the fp32 encode bound.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax

from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu_torch.index import EmbeddingEngine as TEngine

ATOL = 2e-4


@pytest.fixture(scope="module")
def engines():
    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(1), cfg))
    j = JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4)
    t = TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu")
    return j, t, params


def test_engine_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine("ViT-Tiny-Test")


def test_engine_defaults(engines):
    _, t, _ = engines
    assert t.device == torch.device("cpu") and t.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="unknown params_dtype"):
        TEngine("ViT-Tiny-Test", device="cpu", params_dtype="float16")
    assert TEngine("ViT-Tiny-Test", device="cpu", params_dtype="int8").params_dtype == "int8"


@pytest.mark.parametrize("n", [3, 4, 9])  # padded last batch, exact batch, several
def test_encode_staged_images_matches_jax(engines, n):
    j, t, _ = engines
    size = t.cfg.vision.image_size
    staged = np.random.default_rng(n).integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    for normalise in (False, True):
        got = t.encode_staged_images(staged, normalise=normalise)
        ref = j.encode_staged_images(staged, normalise=normalise)
        assert got.shape == (n, t.cfg.embed_dim) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_text_features_and_cache_match_jax(engines):
    j, t, _ = engines
    queries = ["a person riding a bike", "night traffic", "a cat"]
    np.testing.assert_allclose(t.encode_texts(queries), j.encode_texts(queries), rtol=0, atol=ATOL)
    a = t.get_text_features("night traffic")
    assert t.get_text_features("night traffic") is a  # cached
    np.testing.assert_allclose(a, j.get_text_features("night traffic"), rtol=0, atol=ATOL)


def test_model_registry_switches_weights(engines):
    _, t, params = engines
    other = jax.tree.map(np.asarray, init_clip_params(
        jax.random.PRNGKey(9), get_model_config("ViT-Tiny-Test")))
    t.register_model("finetuned", other)
    assert t.available_models() == ["original", "finetuned"]
    base = t.get_text_features("a red car")
    assert t.set_active_model("finetuned") and not t.set_active_model("missing")
    try:
        tuned = t.get_text_features("a red car")  # cache is keyed per model
        assert not np.allclose(base, tuned)
    finally:
        t.set_active_model("original")


def test_embed_folder_matches_jax(engines, tmp_path):
    j, t, _ = engines
    rng = np.random.default_rng(11)
    for i in range(6):
        img = rng.integers(0, 256, (48 + 8 * i, 80, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"{i:03d}.png"), img)
    (tmp_path / "broken.png").write_bytes(b"not an image")
    (tmp_path / "notes.txt").write_text("skipped")
    got, names = t.embed_folder(tmp_path)
    ref, ref_names = j.embed_folder(tmp_path)
    assert names == ref_names == [f"{i:03d}.png" for i in range(6)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
