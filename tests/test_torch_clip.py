"""The PyTorch port's CLIP towers and tokenizer against the JAX package.

ViT-Tiny-Test geometry, JAX params carried across with
``params_from_numpy``, inputs made with numpy from a seed, both on the CPU in
float32. Tolerance: atol 2e-4 on the unnormalised embeddings (the JAX kernel
tests' fp32 bound) and a per-row cosine of at least 0.99999; tokenizer ids
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import clip as jclip
from evr_tpu.models.variants import get_model_config as jcfg
from evr_tpu.tokenizer import ClipTokenizer as JTokenizer
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.variants import MODEL_REGISTRY, get_model_config as tcfg
from evr_tpu_torch.tokenizer import ClipTokenizer as TTokenizer

ATOL = 2e-4
MIN_COS = 0.99999
TEXTS = [
    "a red car driving on the highway at night",
    "Người đàn ông đang đi bộ",  # non-ASCII, accents
    "don't STOP!!  the 3 dogs & <|endoftext|> cats",
    "x " * 60,  # truncated past the context length
    "",
]


def _tcfg(name="ViT-Tiny-Test"):
    return tcfg(name)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), jcfg("ViT-Tiny-Test")))
    return jp, params_from_numpy(jp)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= MIN_COS, cos.min()


def _tokens(n=4):
    return JTokenizer()(TEXTS[:n])


def test_registry_matches_jax():
    from evr_tpu.models.variants import MODEL_REGISTRY as JREG

    assert set(MODEL_REGISTRY) == set(JREG)
    for name, cfg in JREG.items():
        t = MODEL_REGISTRY[name]
        assert (t.embed_dim, t.activation) == (cfg.embed_dim, cfg.activation)
        assert vars(t.vision) == vars(cfg.vision) and vars(t.text) == vars(cfg.text)
        assert t.vision.seq_len == cfg.vision.seq_len


def test_tokenizer_ids_identical():
    jt, tt = JTokenizer(), TTokenizer()
    assert tt.vocab_source == jt.vocab_source
    np.testing.assert_array_equal(tt(TEXTS), jt(TEXTS))
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text)
    assert (tt.sot_id, tt.eot_id, tt.vocab_size) == (jt.sot_id, jt.eot_id, jt.vocab_size)


@pytest.mark.parametrize("cls_fast_final", [True, False])
def test_encode_staged_u8_matches_jax(params, cls_fast_final):
    jp, tp = params
    size = jcfg("ViT-Tiny-Test").vision.image_size
    staged = np.random.default_rng(3).integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    ref = jclip.encode_staged_u8(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(staged), cls_fast_final=cls_fast_final)
    got = tclip.encode_staged_u8(tp, _tcfg(), torch.from_numpy(staged), cls_fast_final=cls_fast_final)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_encode_staged_u8_equals_normalise_then_encode_image(params):
    """The folded stem is the normalise→conv path of ``encode_image``."""
    _, tp = params
    size = _tcfg().vision.image_size
    staged = np.random.default_rng(4).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

    pixels = (staged / 255.0 - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    full = tclip.encode_image(tp, _tcfg(), torch.from_numpy(pixels.astype(np.float32)))
    folded = tclip.encode_staged_u8(tp, _tcfg(), torch.from_numpy(staged), cls_fast_final=False)
    _close(folded.numpy(), full.numpy())


@pytest.mark.parametrize("eot_fast_final", [True, False])
def test_encode_text_matches_jax(params, eot_fast_final):
    jp, tp = params
    tokens = _tokens()
    ref = jclip.encode_text(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(tokens), eot_fast_final=eot_fast_final)
    got = tclip.encode_text(tp, _tcfg(), torch.from_numpy(tokens), eot_fast_final=eot_fast_final)
    _close(got.numpy(), ref)


def test_clip_forward_matches_jax(params):
    jp, tp = params
    size = jcfg("ViT-Tiny-Test").vision.image_size
    pixels = np.random.default_rng(5).standard_normal((3, size, size, 3)).astype(np.float32)
    tokens = _tokens(3)
    ref = jclip.clip_forward(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(pixels), jnp.asarray(tokens))
    got = tclip.clip_forward(tp, _tcfg(), torch.from_numpy(pixels), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        _close(got[key].numpy(), ref[key])
    # logits carry exp(logit_scale) ≈ 14.3 on cosines: the same relative bound
    np.testing.assert_allclose(got["logits_per_image"].numpy(), ref["logits_per_image"], rtol=0, atol=15 * ATOL)
    np.testing.assert_allclose(got["logits_per_text"].numpy(), np.asarray(ref["logits_per_image"]).T, rtol=0, atol=15 * ATOL)


def test_plain_kernel_path_encode_matches_jax(params):
    """The serving encode through the kernels' plain versions (what the card
    is held to) against the JAX encode."""
    import dataclasses

    jp, tp = params
    size = jcfg("ViT-Tiny-Test").vision.image_size
    staged = np.random.default_rng(6).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    ref = jclip.encode_staged_u8(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(staged))
    cfg = dataclasses.replace(_tcfg(), attn_impl="plain")
    _close(tclip.encode_staged_u8(tp, cfg, torch.from_numpy(staged)).numpy(), ref)
    tokens = _tokens()
    ref_t = jclip.encode_text(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(tokens), eot_fast_final=True)
    _close(tclip.encode_text(tp, cfg, torch.from_numpy(tokens), eot_fast_final=True).numpy(), ref_t)


def test_init_params_layout_matches_jax():
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), jcfg("ViT-Tiny-Test")))
    tp = tclip.init_clip_params(np.random.default_rng(0), _tcfg())
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    assert [a.shape for a in jl] == [b.shape for b in tl]
    assert all(b.dtype == np.float32 for b in tl)
    # the same seed gives the same weights
    tp2 = tclip.init_clip_params(0, _tcfg())
    assert all(np.array_equal(a, b) for a, b in zip(tl, jax.tree.leaves(tp2)))


def test_encode_staged_u8_mean_std_matches_jax(params):
    """A non-CLIP normalisation (SigLIP's mean = std = 0.5) folded into the
    patch GEMM, as the JAX package folds it."""
    jp, tp = params
    size = jcfg("ViT-Tiny-Test").vision.image_size
    staged = np.random.default_rng(7).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    half = (0.5, 0.5, 0.5)
    ref = jclip.encode_staged_u8(jp, jcfg("ViT-Tiny-Test"), jnp.asarray(staged), mean=half, std=half)
    got = tclip.encode_staged_u8(tp, _tcfg(), torch.from_numpy(staged), mean=half, std=half)
    _close(got.numpy(), ref)
    clip_default = tclip.encode_staged_u8(tp, _tcfg(), torch.from_numpy(staged))
    assert not np.allclose(got.numpy(), clip_default.numpy(), atol=ATOL)
