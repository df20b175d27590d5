"""Kernels K1 and K2 of the PyTorch port against the JAX package.

On the CPU the wrappers take the kernels' plain PyTorch versions; these are
held to the JAX Pallas kernels run in interpret mode on the same inputs (made
with numpy from a seed) and the same params. Tolerance: fp32 rtol = atol =
2e-4, the JAX kernel tests' own (tests/test_pallas.py); in bf16 the two share
every rounding point, so they may differ by at most one bf16 step of the
output (2^-6 below 4) where fp32 sums in another order round the other way.
The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py`` (the test suite imports JAX, which the card's
machine does not have).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.layers import init_block
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.ops import block_fused as tbf

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_STEP = 2.0 ** -6
W, H = 128, 2


@pytest.fixture(scope="module")
def block():
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(0), W, 12))
    rng = np.random.default_rng(0)
    # non-trivial LN params and biases so every parameter is exercised
    for ln in ("ln_1", "ln_2"):
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _attn_args(p):
    return tbf.block_half_params(p)[0]


def _mlp_args(p):
    return tbf.block_half_params(p)[1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 10, W), (3, 17, W)])
def test_attn_half_matches_jax_kernel(block, causal, shape):
    jp, tp = block
    x = _x(shape)
    ref = np.asarray(jbf.fused_attn_block(
        jnp.asarray(x), *_attn_args(jp), n_heads=H, causal=causal, interpret=True))
    before = tbf.fused_attn_block.launches
    got = tbf.fused_attn_block(torch.from_numpy(x), *_attn_args(tp), n_heads=H, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert tbf.fused_attn_block.launches == before  # CPU tensor: no kernel launch


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("rows", [(2, 20), (5, 13)])  # 40 / 65 rows vs 16-row blocks
def test_mlp_half_matches_jax_kernel(block, activation, rows):
    jp, tp = block
    x = _x(rows + (W,))
    ref = np.asarray(jbf.fused_mlp_block(
        jnp.asarray(x), *_mlp_args(jp), activation=activation, interpret=True, block_rows=16))
    got = tbf.fused_mlp_block(torch.from_numpy(x), *_mlp_args(tp), activation=activation)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_bf16_halves_match_jax_kernel(block, half):
    jp, tp = block
    x = _x((4, 10, W))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    if half == "attn":
        ref = jbf.fused_attn_block(xj, *_attn_args(jp), n_heads=H, causal=True, interpret=True)
        got = tbf.fused_attn_block(xt, *_attn_args(tp), n_heads=H, causal=True)
    else:
        ref = jbf.fused_mlp_block(xj, *_mlp_args(jp), interpret=True)
        got = tbf.fused_mlp_block(xt, *_mlp_args(tp))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= BF16_STEP


def test_gelu_erf_matches_jax_formula():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    ref = np.asarray(jbf._erf(jnp.asarray(x)))
    got = tbf.erf_as(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_kernel_inputs_are_checked_before_launch():
    """What a kernel reads through raw pointers is validated in Python: a
    wrong dtype, layout or parameter shape raises instead of launching."""
    x = torch.zeros(2, 3, W)
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,)]
    params = [torch.zeros(s) for s in shapes]
    tbf._check_cuda(x, params, shapes, "k1")
    short_bias = params[:3] + [torch.zeros(W)] + params[4:]
    with pytest.raises(ValueError, match=r"expected \(384,\)"):
        tbf._check_cuda(x, short_bias, shapes, "k1")
    with pytest.raises(ValueError, match="not supported"):
        tbf._check_cuda(x.half(), params, shapes, "k1")
    with pytest.raises(ValueError, match="contiguous"):
        tbf._check_cuda(x.transpose(0, 1), params, shapes, "k1")
