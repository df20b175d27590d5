"""K5a and K5b at ViT-Tiny-Test's geometry (W 64, four heads of 16) against
the JAX package's backward halves.

Since the bf16 attention backward takes head dim 16 (one 16-column,
32-byte-swizzled TMA box a tile, ``csrc/attn_bwd_sm90.cuh``) and the bf16
GEMM's transposed layouts take the 64-wide narrow tile (``gemm_sm90.cuh``),
and in fp32 ``flash.cuh``'s backward takes d 16 and ``gemm_t`` a ragged N
edge, K5 runs at W 64 on the card, where ``chip_smoke.py`` holds it to the
plain versions these tests check. Here, on the CPU, the plain K5a and K5b
(``fused_attn_block_bwd``, ``fused_mlp_block_bwd`` on CPU tensors) are held
to ``evr_tpu.ops.block_fused``'s Pallas kernels in interpret mode on the
same numpy inputs and params, at the vision tower's T 17 and the causal text
tower's T 77: fp32 dx within 2e-4 and every parameter gradient within the
gradient tolerance 5e-3 (absolute, on values of order one); bf16 dx within
one bf16 step and each gradient within 5e-3 of its largest entry (both
share every rounding point, so only sums in another order round the other
way). Also the Python mirrors' plan of the card at this geometry.
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

W, H = 64, 4  # head dim 16
DX_TOL, GRAD_TOL = 2e-4, 5e-3
BF16_STEP = 2.0 ** -6  # one bf16 step below 4
CASES = [(17, False), (77, True)]  # the vision and the causal text tower


@pytest.fixture(scope="module")
def block():
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(21), W, 2))
    rng = np.random.default_rng(3)
    for ln in ("ln_1", "ln_2"):  # non-trivial LN params and biases
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T, W)).astype(np.float32),
            rng.standard_normal((2, T, W)).astype(np.float32))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T, causal", CASES)
def test_plain_k5a_at_head_dim_16_matches_jax(block, T, causal, dtype):
    jp, tp = block
    x, g = _inputs(T, 5)
    ref = jbf.fused_attn_block_bwd(
        jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
        *tbf.block_half_params(jp)[0], n_heads=H, causal=causal, interpret=True)
    before = tbf.fused_attn_block_bwd.launches
    got = tbf.fused_attn_block_bwd(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g).to(getattr(torch, dtype)),
        *tbf.block_half_params(tp)[0], n_heads=H, causal=causal)
    assert tbf.fused_attn_block_bwd.launches == before  # CPU tensor: no kernel launch
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T, activation", [(17, "quick_gelu"), (77, "gelu")])
def test_plain_k5b_at_width_64_matches_jax(block, T, activation, dtype):
    jp, tp = block
    x, g = _inputs(T, 6)
    ref = jbf.fused_mlp_block_bwd(
        jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
        *tbf.block_half_params(jp)[1], activation=activation, interpret=True, block_rows=16)
    before = tbf.fused_mlp_block_bwd.launches
    got = tbf.fused_mlp_block_bwd(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g).to(getattr(torch, dtype)),
        *tbf.block_half_params(tp)[1], activation=activation)
    assert tbf.fused_mlp_block_bwd.launches == before
    _check(got, ref, dtype)


def test_the_ten_products_take_the_narrow_tile_at_width_64():
    """K5a's and K5b's ten products over the tiny towers' training rows (32
    sequences of 17 and of 77): N of 64 and 192 take the 64-wide tile, N 256
    (the hidden width) the wide one, in every layout; a weight gradient on
    fewer than 66 output tiles splits its rows, counted in narrow tiles."""
    for rows in (32 * 17, 32 * 77):
        gemms = tbf.attn_bwd_gemms(rows, W) + tbf.mlp_bwd_gemms(rows, W, 4 * W)
        assert all(tbf.gemm_takes(*g) for g in gemms)
        assert [tbf.gemm_tile_n(N) for _, N, _, _, _ in gemms] == [64, 64, 64, 64, 64, 256, 64, 256, 256, 64]
    # 2,464 rows, 39 steps of 64: two slices of 20 steps for each weight gradient
    slices = [-(-g[2] // tbf.gemm_k_slice(*g)) for g in tbf.attn_bwd_gemms(32 * 77, W)]
    assert slices == [1, 1, 2, 1, 2]
    assert tbf.gemm_k_slice(64, 192, 32 * 77, a_t=True) == 20 * 64


def test_attention_backward_plan_at_head_dim_16():
    """``attn_bwd_smem_bytes`` and ``attn_bwd_slots`` at d 16 (2 KB tiles):
    both tiny rows stay resident, the row stays resident up to T 3,456, and
    the key-tile kernel's ring fits one block an SM."""
    tile = 64 * 16 * 2
    assert tbf.attn_bwd_smem_bytes(16, 2) == 1024 + 8 * tile + 8 * 5
    assert tbf.attn_bwd_slots(17, 16) == (1, True) and tbf.attn_bwd_slots(77, 16) == (2, True)
    assert tbf.attn_bwd_slots(3456, 16) == (54, True) and tbf.attn_bwd_slots(3457, 16) == (54, False)
    assert tbf.attn_bwd_kv_smem_bytes(16) <= tbf.ATTN_BWD_SMEM_PER_BLOCK
    assert tbf.attn_bwd_takes(32, 77, H, 16) and tbf.attn_bwd_takes(1, 1, 16, 16)
