"""Kernel K9 (``fused_block_merged``, a whole block from one call) of the
PyTorch port against the JAX package.

On the CPU the wrapper takes the kernel's plain version (K1's plain version,
then K2's); it is held to ``evr_tpu.ops.block_fused.fused_block_merged`` run
in interpret mode at W = 128 (head dim 64) and W = 160 (head dim 80), H = 2,
on the same numpy inputs and params, with B = 3, which the JAX kernel's
sequence packing cannot divide, and B = 4, which it packs. Tolerances: fp32
2e-4; bf16 one bf16 step (2^-6 below 4), as the K1/K2 files. Like the JAX
pair (``tests/test_pallas.py:126-145``), the merged block must equal the
two-kernel block ``fused_block_apply`` bit for bit; the CUDA kernel is held
to that on the card by ``chip_smoke.py``.
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
H = 2


def _block(W, seed):
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(seed), W, 12))
    rng = np.random.default_rng(seed)
    for ln in ("ln_1", "ln_2"):  # non-trivial LN params and biases
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


@pytest.fixture(scope="module")
def blocks():
    return {128: _block(128, 6), 160: _block(160, 7)}


def _x(B, T, W, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, W)).astype(np.float32)


@pytest.mark.parametrize("W", [128, 160])
@pytest.mark.parametrize("B, causal, activation", [(3, True, "gelu"), (4, False, "quick_gelu")])
def test_merged_block_matches_jax_kernel(blocks, W, B, causal, activation):
    jp, tp = blocks[W]
    x = _x(B, 10, W)
    ref = np.asarray(jbf.fused_block_merged(jnp.asarray(x), jp, H, activation, causal, interpret=True))
    before = tbf.fused_block_merged.launches
    got = tbf.fused_block_merged(torch.from_numpy(x), tp, H, activation, causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert tbf.fused_block_merged.launches == before  # CPU tensor: no kernel launch


@pytest.mark.parametrize("W", [128, 160])
def test_bf16_merged_block_matches_jax_kernel(blocks, W):
    jp, tp = blocks[W]
    x = _x(3, 10, W, seed=2)
    ref = jbf.fused_block_merged(jnp.asarray(x).astype(jnp.bfloat16), jp, H, "gelu", True, interpret=True)
    got = tbf.fused_block_merged(torch.from_numpy(x).bfloat16(), tp, H, "gelu", True)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max() <= BF16_STEP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W, causal, activation", [(160, True, "gelu"), (128, False, "quick_gelu")])
def test_merged_block_equals_fused_block_apply(blocks, dtype, W, causal, activation):
    _, tp = blocks[W]
    x = torch.from_numpy(_x(3, 17, W, seed=3)).to(dtype)
    two = tbf.fused_block_apply(x, tp, H, activation, causal)
    one = tbf.fused_block_merged(x, tp, H, activation, causal)
    assert one.dtype == dtype
    np.testing.assert_array_equal(one.float().numpy(), two.float().numpy())


def test_merged_block_is_forward_only(blocks):
    """As in the JAX package K9 has no VJP: an input that requires grad is
    refused under grad mode, and taken under no_grad."""
    _, tp = blocks[128]
    x = torch.from_numpy(_x(2, 5, 128)).requires_grad_()
    with pytest.raises(RuntimeError, match="carries no autograd history"):
        tbf.fused_block_merged(x, tp, H)
    with torch.no_grad():
        assert tbf.fused_block_merged(x, tp, H).shape == x.shape
