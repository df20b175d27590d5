"""The port's SigLIP towers, converter, int8 weights and fallback
tokenizers against the JAX package (``tests/test_siglip.py``,
``tests/test_fallback_tokenizers.py``).

JAX's tiny geometries, its params carried across with ``params_from_numpy``,
inputs made with numpy from a seed, both on the CPU. Tolerances: fp32 at the
port's tower convention (atol 2e-4 on unnormalised features, row cosine ≥
0.99999); int8 at 5e-3; staged pixels, attention scores at bfloat16 and
token ids equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import siglip as js
from evr_tpu_torch.models import siglip as ts
from evr_tpu_torch.models.convert import params_from_numpy

ATOL = 2e-4
MIN_COS = 0.99999
INT8_TOL = 5e-3
BF16_TOL = 2 * 2.0 ** -8
TEXTS = ["a cat", "Hello  WORLD", "Người đàn ông đang đi bộ", "x " * 80, ""]


def _geom(mod, vocab=60, layers=2):
    return mod.SiglipConfig(
        vision=mod.SiglipVisionConfig(image_size=32, patch_size=16, width=32, layers=layers, heads=2, mlp_dim=64),
        text=mod.SiglipTextConfig(context_length=8, vocab_size=vocab, width=32, layers=layers, heads=2, mlp_dim=64),
    )


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, js.init_siglip_params(jax.random.PRNGKey(0), _geom(js)))
    return jp, params_from_numpy(jp)


def _close(got, ref, atol=ATOL, min_cos=MIN_COS):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= min_cos, cos.min()


def _inputs(seed, n=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 60, (n, 8)).astype(np.int32))


def test_towers_and_forward_match_jax(params):
    jp, tp = params
    pixels, tokens = _inputs(1)
    _close(ts.encode_image(tp, _geom(ts), torch.from_numpy(pixels)).numpy(),
           js.encode_image(jp, _geom(js), jnp.asarray(pixels)))
    _close(ts.encode_text(tp, _geom(ts), torch.from_numpy(tokens)).numpy(),
           js.encode_text(jp, _geom(js), jnp.asarray(tokens)))
    ref = js.siglip_forward(jp, _geom(js), jnp.asarray(pixels), jnp.asarray(tokens))
    got = ts.siglip_forward(tp, _geom(ts), torch.from_numpy(pixels), torch.from_numpy(tokens))
    for key in ("image_features", "text_features"):
        _close(got[key].numpy(), ref[key])
    # logits carry exp(logit_scale) = 10 on cosines: the same relative bound
    for key in ("logits_per_image", "logits_per_text"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=0, atol=10 * ATOL)


def test_hf_random_init_through_both_converters():
    """A random-init HF ``SiglipModel`` (JAX's tiny pair) converted by each
    package: the port's params equal JAX's leaf by leaf, and the port's
    towers match HF's."""
    from transformers import SiglipConfig as HFConfig, SiglipModel

    torch.manual_seed(0)
    hf = SiglipModel(HFConfig(
        vision_config={"hidden_size": 64, "intermediate_size": 112, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "image_size": 32, "patch_size": 16},
        text_config={"hidden_size": 64, "intermediate_size": 112, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "max_position_embeddings": 12, "vocab_size": 120},
    )).eval()
    jcfg, tcfg = js.siglip_config_from_hf(hf.config), ts.siglip_config_from_hf(hf.config)
    assert vars(tcfg.vision) == vars(jcfg.vision) and vars(tcfg.text) == vars(jcfg.text)
    jp = js.from_hf_siglip_state_dict(hf.state_dict(), jcfg)
    tnp = ts.from_hf_siglip_state_dict(hf.state_dict(), tcfg)
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = jax.tree_util.tree_flatten(tnp)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    tp = params_from_numpy(tnp)
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(0, 120, (3, 12)).astype(np.int32)
    with torch.no_grad():
        hf_i = hf.get_image_features(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
        hf_t = hf.get_text_features(input_ids=torch.from_numpy(tokens.astype(np.int64))).numpy()
        hf_l = hf(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
                  input_ids=torch.from_numpy(tokens.astype(np.int64))).logits_per_image.numpy()
    img = ts.encode_image(tp, tcfg, torch.from_numpy(pixels)).numpy()
    txt = ts.encode_text(tp, tcfg, torch.from_numpy(tokens)).numpy()
    _close(img, hf_i)
    _close(txt, hf_t)
    logits = ts.siglip_forward(tp, tcfg, torch.from_numpy(pixels), torch.from_numpy(tokens))["logits_per_image"]
    np.testing.assert_allclose(logits.numpy(), hf_l, rtol=0, atol=10 * ATOL)


def test_bf16_towers_match_jax(params):
    """bfloat16 compute: the towers within two bfloat16 steps (2 · 2^-8) of
    each row's largest entry of JAX's, row cosine ≥ 0.9999."""
    jp, tp = params
    pixels, tokens = _inputs(2)
    for got, ref in (
        (ts.encode_image(tp, _geom(ts), torch.from_numpy(pixels), torch.bfloat16),
         js.encode_image(jp, _geom(js), jnp.asarray(pixels), jnp.bfloat16)),
        (ts.encode_text(tp, _geom(ts), torch.from_numpy(tokens), torch.bfloat16),
         js.encode_text(jp, _geom(js), jnp.asarray(tokens), jnp.bfloat16)),
    ):
        ref = np.asarray(ref, np.float64)
        scale = np.abs(ref).max(-1, keepdims=True)
        _close(got.numpy() / scale, ref / scale, atol=BF16_TOL, min_cos=0.9999)


def test_bf16_staging_of_all_pixel_values_bit_equal_jax():
    """``x · (2/255) − 1`` at bfloat16 with the factor rounded first, as the
    JAX package's weak constant is: all 256 values bit-equal; the unrounded
    factor (the negative control) differs on 111 of them."""
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    ref = np.asarray((jnp.asarray(u8).astype(jnp.bfloat16) * (2.0 / 255.0) - 1.0).astype(jnp.float32))
    got = ts.stage_pixels(torch.from_numpy(u8), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    unrounded = (torch.from_numpy(u8).to(torch.bfloat16) * (2.0 / 255.0) - 1.0).float().numpy()
    assert (unrounded != ref).sum() == 111
    ref32 = np.asarray(jnp.asarray(u8).astype(jnp.float32) * (2.0 / 255.0) - 1.0)
    np.testing.assert_array_equal(ts.stage_pixels(torch.from_numpy(u8)).numpy(), ref32)


def test_so400m_head_dim_bf16_attention_scores():
    """At so400m's head dim 72, bfloat16 rounds √72 = 8.485 to 8.5: the
    scores divide by the rounded value, bit-equal to JAX's on exact integer
    products; a product by the reciprocal (the negative control) differs.
    The whole attention at W 144, two heads of 72, within bf16's bound."""
    rng = np.random.default_rng(4)
    q = rng.integers(-4, 5, (2, 9, 2, 72)).astype(np.float32)
    k = rng.integers(-4, 5, (2, 11, 2, 72)).astype(np.float32)
    qb, kb = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    ref = jnp.einsum("bqhd,bkhd->bhqk", qb, kb) / jnp.sqrt(jnp.asarray(72, jnp.float32)).astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32))
    got = ts.attention_scores(torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), ref)
    recip = torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16())
    recip = (recip * (1.0 / np.sqrt(72.0))).float().numpy()
    assert (recip != ref).any()

    w = 144
    p = {"qkv": {"kernel": rng.standard_normal((w, 3 * w)).astype(np.float32) * w ** -0.5,
                 "bias": np.zeros(3 * w, np.float32)},
         "out": {"kernel": rng.standard_normal((w, w)).astype(np.float32) * w ** -0.5,
                 "bias": np.zeros(w, np.float32)}}
    x = rng.standard_normal((2, 27, w)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(js._mha(xj, xj, jax.tree.map(jnp.asarray, p), 2, jnp.bfloat16).astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16()
    got = ts._mha(xt, xt, params_from_numpy(p), 2, torch.bfloat16).float().numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=INT8_TOL)


def test_int8_towers_match_jax(params):
    """``quantize_siglip_params``: the block linears int8 (both packages'
    quantised leaves equal), the MAP head, the stem, the embeddings and the
    text head untouched; the int8 towers within 5e-3 of JAX's int8 towers."""
    from evr_tpu.models.quant import quantize_siglip_params as jquant
    from evr_tpu_torch.models.quant import quantize_siglip_params as tquant

    jp, tp = params
    jq = jquant(jax.tree.map(jnp.asarray, jp))
    tq = tquant(tp)
    for tower in ("visual", "text"):
        for jb, tb in zip(jq[tower]["blocks"], tq[tower]["blocks"]):
            for part, names in (("attn", ("qkv", "out")), ("mlp", ("fc", "proj"))):
                for n in names:
                    np.testing.assert_array_equal(tb[part][n]["kernel_q"].numpy(), np.asarray(jb[part][n]["kernel_q"]))
    head = tq["visual"]["head"]
    assert "kernel" in head["attn"]["qkv"] and "kernel" in head["mlp"]["fc"] and "kernel" in tq["text"]["head"]
    assert tq["visual"]["patch_embed"]["kernel"] is tp["visual"]["patch_embed"]["kernel"]
    pixels, tokens = _inputs(3)
    for got, ref in ((ts.encode_image(tq, _geom(ts), torch.from_numpy(pixels)),
                      js.encode_image(jq, _geom(js), jnp.asarray(pixels))),
                     (ts.encode_text(tq, _geom(ts), torch.from_numpy(tokens)),
                      js.encode_text(jq, _geom(js), jnp.asarray(tokens)))):
        ref = np.asarray(ref, np.float64)
        scale = np.abs(ref).max(-1, keepdims=True)
        _close(got.numpy() / scale, ref / scale, atol=INT8_TOL, min_cos=0.9999)


def test_registry_and_init():
    assert set(ts.SIGLIP_REGISTRY) == set(js.SIGLIP_REGISTRY)
    for name, jc in js.SIGLIP_REGISTRY.items():
        tc = ts.get_siglip_config(name)
        assert vars(tc.vision) == vars(jc.vision) and vars(tc.text) == vars(jc.text), name
        assert tc.vision.grid == jc.vision.grid and tc.embed_dim == jc.embed_dim
    so = ts.get_siglip_config("siglip-so400m-patch14-384")
    assert so.vision.grid == 27 and so.vision.width // so.vision.heads == 72
    with pytest.raises(ValueError, match="unknown SigLIP"):
        ts.get_siglip_config("nope")
    cfg = _geom(ts, vocab=50, layers=1)
    p = ts.init_siglip_params(0, cfg, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape, js.init_siglip_params(jax.random.PRNGKey(0), _geom(js, 50, 1)))
    tshapes = jax.tree.map(lambda a: tuple(a.shape), p)
    assert tshapes == jshapes
    assert float(p["logit_bias"]) == -10.0 and abs(float(p["logit_scale"]) - np.log(10.0)) < 1e-6
    again = ts.init_siglip_params(0, cfg, device="cpu")
    assert torch.equal(p["text"]["token_embedding"], again["text"]["token_embedding"])
    img = ts.encode_image(p, cfg, torch.zeros(2, 32, 32, 3))
    assert img.shape == (2, 32) and torch.isfinite(img).all()


def test_siglip_fallback_tokenizer_ids_equal_jax():
    from evr_tpu.tokenizer.fallbacks import SiglipFallbackTokenizer as J
    from evr_tpu_torch.tokenizer import SiglipFallbackTokenizer as T

    for ctx, vocab in ((64, 32000), (8, 32000), (8, 50), (12, 120)):
        j, t = J(ctx, vocab), T(ctx, vocab)
        ids = t(TEXTS)
        assert ids.dtype == np.int32 and ids.shape == (len(TEXTS), ctx) and ids.max() < vocab
        np.testing.assert_array_equal(ids, j(TEXTS))
        for text in TEXTS:
            assert t.encode(text) == j.encode(text)
            assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    assert T(64, 32000).decode(T(64, 32000).encode("xin chào")) == "xin chào"
    with pytest.raises(ValueError):
        T(8, 3)


def test_whisper_fallback_tokenizer_ids_equal_jax():
    from evr_tpu.models.whisper import WHISPER_SIZES
    from evr_tpu.tokenizer.fallbacks import WhisperFallbackTokenizer as J
    from evr_tpu_torch.tokenizer import WhisperFallbackTokenizer as T

    j, t = J.for_config(WHISPER_SIZES["large-v3"]), T(eos_id=50257, sot_id=50258)
    for text in TEXTS + ["fighting in the street"]:
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode([50258] + ids + [50257, 51000]) == j.decode([50258] + ids + [50257, 51000])
    assert t.decode([]) == "" and (t.eos_id, t.sot_id) == (j.eos_id, j.sot_id)
