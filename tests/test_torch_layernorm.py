"""Kernel K8 (``fused_layer_norm``) of the PyTorch port against the JAX package.

On the CPU the wrapper takes the kernel's plain PyTorch version; it is held
to ``evr_tpu.ops.fused_layer_norm`` run in interpret mode on the same numpy
inputs: fp32 at 2e-4 (the JAX kernel tests' own tolerance). With bf16 x both
compute in fp32 from the same bf16 values and round once at the end, so an
output may differ only where an fp32 sum in another order rounds the other
way: by one bf16 step (2^-6 below 4). The CUDA kernel is compared with the
plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops import fused_layer_norm as jln
from evr_tpu_torch.ops import fused_layer_norm as tln
from evr_tpu_torch.ops import layernorm as tlayernorm

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_STEP = 2.0 ** -6


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, scale, bias


def _both(x, scale, bias, activation="none"):
    ref = jln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), activation=activation, interpret=True)
    got = tln(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), activation=activation)
    return got, ref


# rank 1; rank 3; 300 rows against the JAX kernel's 256-row blocks (a padded
# ragged block) with D = 100, not a multiple of 32 or 8
@pytest.mark.parametrize("activation", ["none", "quick_gelu"])
@pytest.mark.parametrize("shape", [(96,), (6, 50, 96), (300, 100)])
def test_fused_layer_norm_matches_jax_kernel(shape, activation):
    x, scale, bias = _inputs(shape)
    before = tln.launches
    got, ref = _both(x, scale, bias, activation)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tln.launches == before  # CPU tensor: no kernel launch


@pytest.mark.parametrize("activation", ["none", "quick_gelu"])
def test_bf16_x_matches_jax_kernel(activation):
    x, scale, bias = _inputs((6, 50, 96), seed=1)
    x16 = torch.from_numpy(x).bfloat16()
    ref = jln(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
              activation=activation, interpret=True)
    got = tln(x16, torch.from_numpy(scale), torch.from_numpy(bias), activation=activation)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert diff.max() <= BF16_STEP
    assert (diff > 0).mean() < 1e-3  # a rounding flip, not a different function


def test_bf16_scale_and_bias_with_fp32_x():
    """Scale and bias in bf16 are taken to fp32 on both sides; x stays fp32."""
    x, scale, bias = _inputs((300, 100), seed=2)
    s16 = np.array(jnp.asarray(scale).astype(jnp.bfloat16).astype(jnp.float32))
    b16 = np.array(jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32))
    ref = jln(jnp.asarray(x), jnp.asarray(scale).astype(jnp.bfloat16), jnp.asarray(bias).astype(jnp.bfloat16),
              activation="quick_gelu", interpret=True)
    got = tln(torch.from_numpy(x), torch.from_numpy(s16).bfloat16(), torch.from_numpy(b16).bfloat16(),
              activation="quick_gelu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_zero_rows():
    x, scale, bias = _inputs((0, 96))
    got, ref = _both(x, scale, bias)
    assert tuple(got.shape) == tuple(ref.shape) == (0, 96)


def test_any_other_activation_is_no_tail():
    """The JAX kernel adds the tail only for "quick_gelu"; any other value,
    "gelu" included, is the plain LayerNorm, and the port does the same."""
    x, scale, bias = _inputs((4, 96), seed=3)
    got, ref = _both(x, scale, bias, activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = tlayernorm.fused_layer_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                              torch.from_numpy(bias))
    assert torch.equal(got, plain)
