"""Kernel K3 of the PyTorch port (the int8 fused block halves) against the
JAX package.

On the CPU the wrappers ``fused_attn_block_q`` / ``fused_mlp_block_q`` take
the kernels' plain PyTorch versions; these are held to
``evr_tpu.ops.block_fused.fused_quant_block_apply`` run in interpret mode on
the same inputs (numpy, from a seed) and the same int8 params. Tolerance:
the 5e-3 int8 tolerance of ROADMAP (``tests/test_pallas.py`` holds the JAX
kernel to it): both sides share every rounding point, but a LayerNorm output
or head output that differs in its last bit (sums in another order) can
move one activation across a quantisation step. The smallest row cosine is
reported with each comparison. The CUDA kernels themselves are compared with
these plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.layers import init_block
from evr_tpu.models.quant import _quantize_block as jquantize_block
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.quant import _quantize_block as tquantize_block
from evr_tpu_torch.ops import block_fused as tbf

INT8_TOL = dict(rtol=5e-3, atol=5e-3)
MIN_COS = 0.9999
W, H = 128, 2


@pytest.fixture(scope="module")
def qblock():
    p = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(4), W, 12))
    rng = np.random.default_rng(0)
    for ln in ("ln_1", "ln_2"):  # non-trivial LN params and biases
        p[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        p[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = p[grp][name]["bias"]
        p[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    jp = jax.tree.map(np.asarray, jquantize_block(p))
    return jp, tquantize_block(params_from_numpy(p))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _min_cos(got, ref):
    g, r = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float(((g * r).sum(1) / np.linalg.norm(g, axis=1) / np.linalg.norm(r, axis=1)).min())


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("causal", [False, True])
def test_quant_block_matches_jax_kernel(qblock, causal, activation):
    jp, tp = qblock
    x = _x((4, 10, W))
    ref = np.asarray(jbf.fused_quant_block_apply(
        jnp.asarray(x), jp, H, activation, causal, interpret=True))
    before = (tbf.fused_attn_block_q.launches, tbf.fused_mlp_block_q.launches)
    got = tbf.fused_quant_block_apply(torch.from_numpy(x), tp, H, activation, causal).numpy()
    cos = _min_cos(got, ref)
    print(f"K3 plain vs JAX, causal={causal} {activation}: max abs "
          f"{np.abs(got - ref).max():.2e}, min row cosine {cos:.7f}")
    np.testing.assert_allclose(got, ref, **INT8_TOL)
    assert cos >= MIN_COS
    # CPU tensors: no kernel launch
    assert (tbf.fused_attn_block_q.launches, tbf.fused_mlp_block_q.launches) == before


def test_quant_block_ragged_rows_match_jax_kernel(qblock):
    """An odd sequence length and batch (17 rows of 3 sequences): the JAX
    kernel pads its MLP row blocks, the port's kernel masks its own edge."""
    jp, tp = qblock
    x = _x((3, 17, W), seed=2)
    ref = np.asarray(jbf.fused_quant_block_apply(jnp.asarray(x), jp, H, causal=True, interpret=True))
    got = tbf.fused_quant_block_apply(torch.from_numpy(x), tp, H, causal=True).numpy()
    np.testing.assert_allclose(got, ref, **INT8_TOL)
    assert _min_cos(got, ref) >= MIN_COS


def test_bf16_quant_block_matches_jax_kernel(qblock):
    """bf16 activations: qkv, the head outputs and the block output are
    rounded to bf16 at the same points on both sides; they may differ by one
    bf16 step of the output (2^-6 below 4) where a quantisation step or an
    fp32 sum rounds the other way."""
    jp, tp = qblock
    x = _x((4, 10, W), seed=3)
    ref = jbf.fused_quant_block_apply(
        jnp.asarray(x).astype(jnp.bfloat16), jp, H, causal=True, interpret=True)
    got = tbf.fused_quant_block_apply(torch.from_numpy(x).bfloat16(), tp, H, causal=True)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -6
    assert _min_cos(got, ref) >= MIN_COS


@pytest.mark.parametrize("causal", [False, True])
def test_block_apply_routes_int8_params(qblock, causal):
    """``block_apply`` on int8 params: "plain" runs K3's plain versions (the
    reference of the kernel path on the card), "auto" on a CPU tensor the
    plain composition with quantized linears; the two agree to the int8
    tolerance."""
    _, tp = qblock
    x = torch.from_numpy(_x((2, 9, W), seed=4))
    plain = tlayers.block_apply(x, tp, H, causal, attn_impl="plain")
    torch.testing.assert_close(plain, tbf.fused_quant_block_apply(x, tp, H, causal=causal))
    composed = tlayers.block_apply(x, tp, H, causal, attn_impl="auto")
    np.testing.assert_allclose(composed.numpy(), plain.numpy(), **INT8_TOL)


def test_quant_wrapper_inputs_are_checked_before_launch(qblock):
    """What K3 reads through raw pointers is validated in Python: a wrong
    parameter dtype, shape or device, or a wrong x dtype, raises ValueError
    instead of launching."""
    _, tp = qblock
    attn, _ = tbf.quant_block_half_params(tp)
    x = torch.zeros(2, 3, W)
    params = tbf.cast_quant_args(x.dtype, attn)
    shapes = [tuple(p.shape) for p in params]
    dtypes = [p.dtype for p in params]
    tbf._check_cuda(x, params, shapes, "k3a", dtypes)
    float_kernel = params[:2] + [params[2].float()] + params[3:]
    with pytest.raises(ValueError, match="dtype torch.float32, expected torch.int8"):
        tbf._check_cuda(x, float_kernel, shapes, "k3a", dtypes)
    with pytest.raises(ValueError, match=r"expected \(384,\)"):
        tbf._check_cuda(x, params[:3] + [params[4][:W]] + params[4:], shapes, "k3a", dtypes)
    with pytest.raises(ValueError, match="not supported"):
        tbf._check_cuda(x.half(), params, shapes, "k3a", dtypes)
    with pytest.raises(ValueError, match="parameter on meta"):
        tbf._check_cuda(x, params[:5] + [params[5].to("meta")] + params[6:], shapes, "k3a", dtypes)
