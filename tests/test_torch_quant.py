"""int8 weights of the PyTorch port (``evr_tpu_torch.models.quant``) against
the JAX package's ``evr_tpu.models.quant``.

The same numpy params go through both quantizers: ``kernel_q`` and
``kernel_scale`` must be equal bit for bit (same absmax, same division, same
round-half-even). ``quantized_linear`` on the same fp32 inputs then does the
same arithmetic in the same order, so it is held to 1e-6; the towers' int8
routes (the plain composition and the pooled-row final blocks) to the 5e-3
int8 tolerance of ROADMAP, since a LayerNorm output that differs in its last
bit can move one activation across a quantisation step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import clip as jclip
from evr_tpu.models import layers as jlayers
from evr_tpu.models import quant as jq
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models import quant as tq
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.ops.int8 import int8_matmul

INT8_TOL = dict(rtol=5e-3, atol=5e-3)
W, H = 64, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def block():
    p = _np(jlayers.init_block(jax.random.PRNGKey(5), W, 4))
    rng = np.random.default_rng(2)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = p[grp][name]["bias"]
        p[grp][name]["bias"] = (0.05 * rng.standard_normal(b.shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("shape", [(96, 128), (3072, 8)])
def test_quantize_linear_params_exact(shape):
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal(shape).astype(np.float32) * 0.05
    kernel[:, 1] = 0.0  # an all-zero column takes the 1e-12 floor
    p = {"kernel": kernel, "bias": rng.standard_normal(shape[1]).astype(np.float32)}
    ref = _np(jq.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()}))
    got = tq.quantize_linear_params(params_from_numpy(p))
    assert got["kernel_q"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["kernel_q"].numpy(), ref["kernel_q"])
    np.testing.assert_array_equal(got["kernel_scale"].numpy(), ref["kernel_scale"])
    np.testing.assert_array_equal(got["bias"].numpy(), ref["bias"])


def test_quantized_linear_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 96)).astype(np.float32)
    x[0, 0] = 0.0  # a zero row: scale 1e-12, every value 0
    p = {"kernel": rng.standard_normal((96, 128)).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(128).astype(np.float32)}
    jp = jq.quantize_linear_params({k: jnp.asarray(v) for k, v in p.items()})
    ref = np.asarray(jq.quantized_linear(jnp.asarray(x), jp))
    got = tq.quantized_linear(torch.from_numpy(x), tq.quantize_linear_params(params_from_numpy(p)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # bf16 input: output in bf16, as the JAX function gives
    ref16 = jq.quantized_linear(jnp.asarray(x).astype(jnp.bfloat16), jp)
    got16 = tq.quantized_linear(torch.from_numpy(x).bfloat16(),
                                tq.quantize_linear_params(params_from_numpy(p)))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(ref16.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_int8_product_does_not_wrap():
    """int8 @ int8 on the CPU wraps around in int8; the port's product is
    exact up to the largest sum a ViT-B/32 MLP can make, 3072 · 127²."""
    a = torch.full((2, 3072), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((3072, 3), 127, dtype=torch.int8)
    got = int8_matmul(a, b)
    assert got.dtype == torch.float32
    assert got[0, 0].item() == 3072 * 127 * 127 and got[1, 2].item() == -3072 * 127 * 127
    assert (a @ b).dtype == torch.int8  # what the exact product avoids


def test_quantize_clip_params_matches_jax():
    cfg = jclip.CLIPConfig(
        embed_dim=32,
        vision=jclip.VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=2),
        text=jclip.TextConfig(context_length=16, vocab_size=100, width=64, layers=2, heads=2),
    )
    params = _np(jclip.init_clip_params(jax.random.PRNGKey(0), cfg))
    ref = _np(jq.quantize_clip_params(params))
    got = tq.quantize_clip_params(params_from_numpy(params))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got, is_leaf=torch.is_tensor))
    assert len(ref_leaves) == len(got_leaves)
    for path, leaf in ref_leaves:
        t = got_leaves[path]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(t.numpy(), leaf, err_msg=str(path))
    # idempotent, and the linear dispatches on the int8 layout
    assert tq.quantize_clip_params(got)["visual"]["blocks"][0] is got["visual"]["blocks"][0]
    blk = got["text"]["blocks"][1]["mlp"]["fc"]
    assert tq.is_quantized_linear(blk)
    x = torch.randn(3, 64)
    torch.testing.assert_close(tlayers.linear(x, blk), tq.quantized_linear(x, blk))


@pytest.mark.parametrize("causal", [False, True])
def test_int8_block_composition_matches_jax(block, causal):
    """``block_apply`` on int8 params off the card: attention, LayerNorms and
    quantized linears composed, as the JAX package runs off the TPU."""
    x = np.random.default_rng(3).standard_normal((3, 11, W)).astype(np.float32)
    jp = jq._quantize_block(jax.tree.map(jnp.asarray, block))
    ref = np.asarray(jlayers.block_apply(jnp.asarray(x), jp, H, causal, "xla"))
    tp = tq._quantize_block(params_from_numpy(block))
    got = tlayers.block_apply(torch.from_numpy(x), tp, H, causal)
    np.testing.assert_allclose(got.numpy(), ref, **INT8_TOL)


@pytest.mark.parametrize("pool", ["cls", "eot"])
def test_int8_pooled_row_final_block_matches_jax(block, pool):
    """The int8 branch of the pooled-row final block: a full QKV through the
    quantized linear, then the pooled row's Q sliced out."""
    x = np.random.default_rng(4).standard_normal((4, 12, W)).astype(np.float32)
    jp = jq._quantize_block(jax.tree.map(jnp.asarray, block))
    tp = tq._quantize_block(params_from_numpy(block))
    if pool == "cls":
        ref = jlayers.final_block_cls(jnp.asarray(x), jp, H)
        got = tlayers.final_block_cls(torch.from_numpy(x), tp, H)
    else:
        eot = np.array([11, 3, 7, 0])
        ref = jlayers.final_block_eot(jnp.asarray(x), jp, H, jnp.asarray(eot))
        got = tlayers.final_block_eot(torch.from_numpy(x), tp, H, torch.from_numpy(eot))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **INT8_TOL)
    # and it is the full block's pooled row
    full = tlayers.block_apply(torch.from_numpy(x), tp, H, causal=pool == "eot")
    rows = full[:, 0] if pool == "cls" else full[torch.arange(4), torch.tensor([11, 3, 7, 0])]
    np.testing.assert_allclose(got.numpy(), rows.numpy(), **INT8_TOL)
