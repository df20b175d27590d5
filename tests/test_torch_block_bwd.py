"""Kernels K5a/K5b (the fused block backward) of the PyTorch port against the
JAX package, and ``FusedBlockFunction`` against ``jax.grad``.

On the CPU the K5 wrappers take their plain PyTorch versions; these are held
to the JAX Pallas backward kernels run in interpret mode on the same numpy
inputs and params (W = 128, H = 2; B = 3 runs one sequence per tile, B = 8
at T = 20 packs eight, so both of the JAX kernel's layouts are covered).
Tolerances: fp32 dx 2e-4 (the block kernels' tolerance) and the parameter
gradients 5e-3 (ROADMAP's gradient tolerance), both absolute on values of
order one; in bf16 the two share every rounding point, so dx may differ by
one bf16 step (2^-6 below 4) and a gradient by 5e-3 of its largest entry,
where sums in another order round the other way. The CUDA kernels are
compared with these plain versions on the card by ``chip_smoke.py``.
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

W, H = 128, 2
DX_TOL, GRAD_TOL = 2e-4, 5e-3
BF16_STEP = 2.0 ** -6


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


def _inputs(B, T, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, W)).astype(np.float32),
            rng.standard_normal((B, T, W)).astype(np.float32))


def _check(got, ref, dtype):
    """got: the port's (dx, *grads) tensors; ref: the JAX kernel's arrays."""
    assert got[0].dtype == getattr(torch, dtype)
    assert all(g.dtype == torch.float32 for g in got[1:])
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape
        err = np.abs(g - r).max()
        if dtype == "float32":
            assert err <= (DX_TOL if i == 0 else GRAD_TOL), (i, err)
        else:
            assert err <= (BF16_STEP if i == 0 else GRAD_TOL * np.abs(r).max()), (i, err)


@pytest.mark.parametrize("B, T, causal, dtype", [
    (3, 10, False, "float32"), (8, 20, True, "float32"), (3, 20, True, "bfloat16"),
])
def test_attn_bwd_matches_jax_kernel(block, B, T, causal, dtype):
    jp, tp = block
    x, g = _inputs(B, T)
    ref = jbf.fused_attn_block_bwd(
        jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
        *tbf.block_half_params(jp)[0], n_heads=H, causal=causal, interpret=True)
    before = tbf.fused_attn_block_bwd.launches
    got = tbf.fused_attn_block_bwd(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g).to(getattr(torch, dtype)),
        *tbf.block_half_params(tp)[0], n_heads=H, causal=causal)
    assert tbf.fused_attn_block_bwd.launches == before  # CPU tensor: no kernel launch
    _check(got, ref, dtype)


@pytest.mark.parametrize("B, T, activation, dtype", [
    (3, 10, "quick_gelu", "float32"), (8, 20, "gelu", "float32"), (3, 10, "gelu", "bfloat16"),
])
def test_mlp_bwd_matches_jax_kernel(block, B, T, activation, dtype):
    jp, tp = block
    x, g = _inputs(B, T)
    ref = jbf.fused_mlp_block_bwd(
        jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
        *tbf.block_half_params(jp)[1], activation=activation, interpret=True, block_rows=16)
    before = tbf.fused_mlp_block_bwd.launches
    got = tbf.fused_mlp_block_bwd(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g).to(getattr(torch, dtype)),
        *tbf.block_half_params(tp)[1], activation=activation)
    assert tbf.fused_mlp_block_bwd.launches == before
    _check(got, ref, dtype)


def _torch_grads(x, tp, impl, causal=False, activation="quick_gelu"):
    """Gradients of sum(block(x)²) wrt x and the twelve parameters."""
    xt = torch.from_numpy(x).requires_grad_()
    params = params_from_numpy(jax.tree.map(lambda t: t.numpy(), tp))
    leaves = [t.requires_grad_() for half in tbf.block_half_params(params) for t in half]
    if impl == "composition":  # torch autograd straight through the plain halves
        attn, mlp = tbf.block_half_params(params)
        out = tbf.fused_mlp_block_plain(
            tbf.fused_attn_block_plain(xt, *attn, n_heads=H, causal=causal), *mlp, activation=activation)
    else:
        out = tbf.fused_block_apply(xt, params, H, activation, causal, impl=impl)
        assert out.grad_fn is not None
    (out ** 2).sum().backward()
    return [xt.grad.numpy()] + [t.grad.numpy() for t in leaves]


def test_fused_block_function_grads_match_jax_grad(block):
    """FusedBlockFunction (plain forward and backward) against jax.grad of
    the JAX custom VJP fused_block_apply (interpret mode), causal, GELU."""
    jp, tp = block
    x, _ = _inputs(4, 10, seed=2)
    gj = jax.grad(
        lambda x_, p_: jnp.sum(jbf.fused_block_apply(x_, p_, H, "gelu", True, True) ** 2),
        argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, jp))
    ref = [gj[0]] + [t for half in tbf.block_half_params(gj[1]) for t in half]
    got = _torch_grads(x, tp, "plain", causal=True, activation="gelu")
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=str(i))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_fused_block_function_grads_match_torch_autograd(block, impl):
    """The Function's backward (K5b then K5a, as plain versions on a CPU
    tensor) against torch autograd of the plain composition, mirroring
    tests/test_pallas.py:144-162; the kernel route launches nothing here."""
    _, tp = block
    x, _ = _inputs(4, 10, seed=3)
    before = (tbf.fused_attn_block_bwd.launches, tbf.fused_mlp_block_bwd.launches)
    got = _torch_grads(x, tp, impl)
    ref = _torch_grads(x, tp, "composition")
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=5e-4, err_msg=str(i))
    assert (tbf.fused_attn_block_bwd.launches, tbf.fused_mlp_block_bwd.launches) == before
