"""The PyTorch port's block-level layers against the JAX package.

``block_apply`` on the CPU (the plain composition, and the kernels' plain
versions through ``attn_impl="plain"``) and the pooled-row final blocks
``final_block_cls`` / ``final_block_eot``, at W=128 with two heads, on the
same numpy inputs and params. Tolerance: fp32 rtol = atol = 2e-4, the JAX
kernel tests' own (tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import layers as jlayers
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
W, H = 128, 2


@pytest.fixture(scope="module")
def block():
    jp = jax.tree.map(np.asarray, jlayers.init_block(jax.random.PRNGKey(0), W, 12))
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


@pytest.mark.parametrize("causal", [False, True])
def test_plain_block_matches_jax_fused_block(block, causal):
    jp, tp = block
    x = _x((2, 12, W))
    ref = np.asarray(jbf.fused_block_apply(jnp.asarray(x), jp, H, "quick_gelu", causal, True))
    got = tlayers.block_apply(torch.from_numpy(x), tp, H, causal, attn_impl="plain")
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_block_apply_cpu_takes_plain_composition(block, causal, impl):
    """Off the card ``attn_impl="auto"`` is the XLA-path composition, as in
    the JAX package off the TPU."""
    jp, tp = block
    x = _x((2, 9, W))
    ref = np.asarray(jlayers.block_apply(jnp.asarray(x), jp, H, causal, impl))
    got = tlayers.block_apply(torch.from_numpy(x), tp, H, causal, attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
def test_final_block_cls_matches_jax(block, activation):
    jp, tp = block
    x = _x((3, 11, W))
    ref = np.asarray(jlayers.final_block_cls(jnp.asarray(x), jp, H, activation))
    got = tlayers.final_block_cls(torch.from_numpy(x), tp, H, activation)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_final_block_eot_matches_jax(block):
    jp, tp = block
    x = _x((3, 11, W))
    eot = np.array([4, 10, 0])
    ref = np.asarray(jlayers.final_block_eot(jnp.asarray(x), jp, H, jnp.asarray(eot)))
    got = tlayers.final_block_eot(torch.from_numpy(x), tp, H, torch.from_numpy(eot))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the row of the full causal block the pooled row stands for
    full = tlayers.block_apply(torch.from_numpy(x), tp, H, True, attn_impl="xla")
    np.testing.assert_allclose(got.numpy(), full[torch.arange(3), torch.from_numpy(eot)].numpy(), **TOL)
