"""ViT-Tiny-Test through the fused kernels: the shape rules and plain versions.

The tiny test tower (W 64, four heads of 16 in both towers, vision T 17,
text T 77) reaches the fused route on the card like every tower of width
up to 1280 (``models.layers.block_apply``, as in the JAX package). Its GEMMs
have N of 64, 192 and 256 (the bf16 GEMM's 64-wide narrow tile, the fp32
CUDA-core GEMM's masked edge, the int8 GEMM's narrow tile) and its
attention head dim 16 (one 32-byte-swizzled TMA box in the bf16 forward;
one more template instantiation of the fp32 kernels). The kernels run only
on the card, where ``chip_smoke.py``'s Tiny phase holds them to these plain
versions; here the CPU checks what that rests on:

- the mirrors (``gemm_takes``, ``gemm_s8_takes``, ``attn_takes``,
  ``attn_bwd_takes``, ``ops.attention.HEAD_DIMS``) take every forward GEMM
  and attention of the tiny towers and every shape of the other registry
  towers, K5's transposed products at N 64 and its attention backward at
  head dim 16, and refuse N off the 64-wide tile and head dims other than
  16, 64 and 80, before any library loads; K5a, K5b and K5a's attention
  backward at W 64 and head dim 16 pass every wrapper check and reach their
  library;
- the plain K1, K2, K3a, K3b, K6a and K6b at W 64, H 4 against the JAX
  Pallas kernels in interpret mode on the same numpy inputs and params:
  fp32 at the JAX kernel tests' 2e-4, bf16 within one bf16 step (both round
  at the same points), int8 at 5e-3 with a least row cosine of 0.9999;
- the tiny towers on a tensor that claims to be on the card reach the fused
  wrappers (K1, K3a or K6) and raise no shape error before a library loads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.layers import init_block
from evr_tpu.models.quant import _quantize_block as jquantize_block
from evr_tpu.ops import attention as jattn
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.index.engine import EmbeddingEngine
from evr_tpu_torch.models import MODEL_REGISTRY, get_model_config
from evr_tpu_torch.models.clip import encode_staged_u8, encode_text
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.layers import FUSED_MAX_WIDTH
from evr_tpu_torch.models.quant import _quantize_block as tquantize_block
from evr_tpu_torch.ops import attention as tattn
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build

TINY = "ViT-Tiny-Test"
W, H = 64, 4  # head dim 16
TOL = dict(rtol=2e-4, atol=2e-4)
INT8_TOL = dict(rtol=5e-3, atol=5e-3)
MIN_COS = 0.9999
BF16_STEP = 2.0 ** -6  # one bf16 step below 4


def _towers(cfg):
    """(width, heads, T, causal, row counts) of each tower: one sequence, the
    serving batch (256 frames, 16 queries) and the training batch 32."""
    v, t = cfg.vision, cfg.text
    tokens = (v.image_size // v.patch_size) ** 2 + 1
    return [(v.width, v.heads, tokens, False, (1, 256, 32)), (t.width, t.heads, 77, True, (1, 16, 32))]


def _forward_gemms(width, rows):
    """(M, N, K) of a block's four forward products: QKV, out, fc, proj."""
    return [(rows, 3 * width, width), (rows, width, width), (rows, 4 * width, width), (rows, width, 4 * width)]


def _assert_taken(name):
    for width, heads, T, _, seqs in _towers(MODEL_REGISTRY[name]):
        if width > FUSED_MAX_WIDTH:
            continue
        d = width // heads
        assert d in tattn.HEAD_DIMS and d in tbf.ATTN_HEAD_DIMS, (name, d)
        for n in seqs:
            assert tbf.attn_takes(n, T, heads, d), (name, n, T, heads, d)
            for M, N, K in _forward_gemms(width, n * T):
                assert tbf.gemm_takes(M, N, K), (name, M, N, K)
                assert tbf.gemm_s8_takes(M, N, K), (name, M, N, K)


def test_mirrors_take_every_forward_shape_of_the_tiny_towers():
    cfg = MODEL_REGISTRY[TINY]
    assert [(w, h, T) for w, h, T, _, _ in _towers(cfg)] == [(64, 4, 17), (64, 4, 77)]
    _assert_taken(TINY)
    # the narrow tiles: N 64 and 192 are off the 256-wide ones
    assert [N % tbf.GEMM_TILE_N for _, N, _ in _forward_gemms(W, 17)] == [192, 64, 0, 64]
    assert tbf.attn_boxes(16) == [(0, 16, 32)]  # one 16-column box, 32-byte swizzle
    assert tbf.attn_k_slots(77, 16) == 2  # the text row's two key blocks stay resident


@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY if n != TINY])
def test_mirrors_take_every_registry_tower(name):
    """The shapes taken before the narrow tiles and head dim 16 stay taken,
    and the int8 GEMM takes every K3 product of every fused tower."""
    _assert_taken(name)


def test_mirrors_refuse_off_rule_shapes():
    assert not tbf.gemm_takes(128, 96, 64)  # N off the 64-wide narrow tile
    # the transposed products (K5's) take the narrow tile too, at N 64 and 192
    assert tbf.gemm_takes(128, 192, 64, w_t=True) and tbf.gemm_takes(64, 192, 128, a_t=True)
    assert tbf.gemm_takes(4352, 64, 64, w_t=True) and tbf.gemm_takes(64, 64, 4352, a_t=True)
    assert not tbf.gemm_takes(128, 96, 64, w_t=True) and not tbf.gemm_takes(64, 96, 128, a_t=True)
    assert not tbf.gemm_s8_takes(128, 96, 64) and not tbf.gemm_s8_takes(128, 64, 24)  # N, K off the rule
    assert not tbf.gemm_s8_takes(0, 64, 64) and not tbf.gemm_s8_takes(65535 * 128 + 1, 64, 64)
    assert tbf.gemm_s8_takes(65535 * 128, 64, 16)
    for d in (8, 24, 32, 48, 96, 128):
        assert not tbf.attn_takes(2, 17, 4, d) and d not in tattn.HEAD_DIMS
        assert not tbf.attn_bwd_takes(2, 17, 4, d)
    # the backward takes the forward's head dims, 16 among them
    assert tbf.attn_takes(2, 17, 4, 16) and tbf.attn_bwd_takes(2, 17, 4, 16)
    assert tbf.ATTN_BWD_HEAD_DIMS == (16, 64, 80) and tbf.attn_bwd_takes(2, 17, 4, 64)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def _no_load(name):
    raise RuntimeError(f"library {name} loaded")


def test_k5_at_the_tiny_geometry_raises_before_any_library_loads(monkeypatch):
    """K5a/K5b and K5a's attention backward alone at the tiny geometry (W 64,
    H 4) and at head dim 16 on a wider block (W 256, H 16), bf16 and fp32:
    no wrapper check raises any more (the transposed products take the
    narrow tile, the attention backward d 16); each call goes on to load its
    library, which raises here."""
    monkeypatch.setattr(build, "load", _no_load)

    for dt in (torch.bfloat16, torch.float32):
        def cuda(*shape):
            return torch.zeros(*shape, dtype=dt).as_subclass(_ClaimsCuda)

        for width, heads in ((64, 4), (256, 16)):
            x, g = cuda(2, 17, width), cuda(2, 17, width)
            attn = [cuda(width), cuda(width), cuda(width, 3 * width), cuda(3 * width), cuda(width, width),
                    cuda(width)]
            with pytest.raises(RuntimeError, match="library block_attn_bwd loaded"):
                tbf.fused_attn_block_bwd(x, g, *attn, n_heads=heads)
            with pytest.raises(RuntimeError, match="library block_attn_bwd loaded"):
                tbf.attn_backward(cuda(2, 17, 3 * width), cuda(2, 17, width), heads)
            mlp = [cuda(width), cuda(width), cuda(width, 4 * width), cuda(4 * width), cuda(4 * width, width),
                   cuda(width)]
            with pytest.raises(RuntimeError, match="library block_mlp_bwd loaded"):
                tbf.fused_mlp_block_bwd(x, g, *mlp)


@pytest.fixture(scope="module")
def tiny_block():
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(11), W, 2))
    rng = np.random.default_rng(0)
    for ln in ("ln_1", "ln_2"):  # non-trivial LN params and biases
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _min_cos(got, ref):
    g, r = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(((g * r).sum(1) / np.linalg.norm(g, axis=1) / np.linalg.norm(r, axis=1)).min())


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["float", "int8", "flash"])
def test_plain_kernels_at_the_tiny_geometry_match_jax_kernels(tiny_block, kind):
    """K1 and K2 (``float``), K3a and K3b (``int8``), K6a and K6b
    (``flash``) at W 64, H 4, the vision tower's T 17 and the causal text
    tower's T 77; their plain versions on CPU tensors, no launch."""
    jp, tp = tiny_block
    before = sum(f.launches for f in (tbf.fused_attn_block, tbf.fused_mlp_block, tbf.fused_attn_block_q,
                                      tbf.fused_mlp_block_q, tattn.flash_attention_full,
                                      tattn.flash_attention_blocked))
    for T, causal, seed in ((17, False, 1), (77, True, 2)):
        x = _x((3, T, W), seed)
        if kind == "float":
            ja, jm = tbf.block_half_params(jp)
            ta, tm = tbf.block_half_params(tp)
            for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
                xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dt)
                pairs = (
                    (jbf.fused_attn_block(xj, *ja, n_heads=H, causal=causal, interpret=True),
                     tbf.fused_attn_block(xt, *ta, n_heads=H, causal=causal)),
                    (jbf.fused_mlp_block(xj, *jm, interpret=True, block_rows=16), tbf.fused_mlp_block(xt, *tm)),
                )
                for ref, got in pairs:
                    assert got.dtype == dt
                    if dt == torch.float32:
                        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
                    else:
                        assert np.abs(got.float().numpy() - _bf16(ref)).max() <= BF16_STEP
        elif kind == "int8":
            jq = jax.tree.map(np.asarray, jquantize_block(jp))
            tq = tquantize_block(tp)
            for act in ("quick_gelu", "gelu"):
                ref = np.asarray(jbf.fused_quant_block_apply(jnp.asarray(x), jq, H, act, causal, interpret=True))
                got = tbf.fused_quant_block_apply(torch.from_numpy(x), tq, H, act, causal).numpy()
                np.testing.assert_allclose(got, ref, **INT8_TOL)
                assert _min_cos(got, ref) >= MIN_COS
        else:
            q, k, v = (_x((3, H, T, W // H), seed + 10 * i) for i in range(3))
            for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
                ref = jattn.flash_attention(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)), causal=causal,
                                            interpret=True)
                tq_, tk_, tv_ = (torch.from_numpy(a).to(dt) for a in (q, k, v))
                got = (tattn.flash_attention_blocked(tq_, tk_, tv_, causal) if causal
                       else tattn.flash_attention_full(tq_, tk_, tv_))
                if dt == torch.float32:
                    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
                else:
                    assert np.abs(got.float().numpy() - _bf16(ref)).max() <= BF16_STEP
    after = sum(f.launches for f in (tbf.fused_attn_block, tbf.fused_mlp_block, tbf.fused_attn_block_q,
                                     tbf.fused_mlp_block_q, tattn.flash_attention_full,
                                     tattn.flash_attention_blocked))
    assert after == before  # CPU tensors: no kernel launch


def test_tiny_engine_on_the_card_reaches_the_fused_wrappers(monkeypatch):
    """``EmbeddingEngine("ViT-Tiny-Test")``'s params and towers on a tensor
    that claims to be on the card: the default route reaches K1 (float
    params) or K3a (int8 params), the flash route K6a/K6b, and each raises
    only where its library would load, with no shape error before it."""
    engine = EmbeddingEngine(TINY, device="cpu", batch_size=2)
    cfg = engine.cfg
    size = cfg.vision.image_size
    staged = torch.zeros(2, size, size, 3, dtype=torch.uint8).as_subclass(_ClaimsCuda)
    tokens = torch.from_numpy(engine.tokenizer(["a dog"], context_length=cfg.text.context_length))
    tokens = tokens.as_subclass(_ClaimsCuda)
    monkeypatch.setattr(build, "load", _no_load)
    routes = [(cfg, engine.params, "block_attn"),
              (get_model_config(TINY, attn_impl="flash"), engine.params, "flash_attn")]
    engine.set_params_dtype("int8")
    routes.append((cfg, engine.params, "block_quant"))
    with torch.inference_mode():
        for c, params, lib in routes:
            for dt in (torch.bfloat16, torch.float32):
                with pytest.raises(RuntimeError, match=f"library {lib} loaded"):
                    encode_staged_u8(params, c, staged, dtype=dt)
                with pytest.raises(RuntimeError, match=f"library {lib} loaded"):
                    encode_text(params, c, tokens, dtype=dt, eot_fast_final=True)
