"""Head dim 80 in the port's K1, K3a and K5a, and ``block_apply``'s default.

ViT-H-14's vision tower runs 16 heads of 80, so its default route reaches
K1/K2 (K3a/K3b on int8 params) at head dim 80. On the CPU the wrappers take
their plain PyTorch versions; these are held to the JAX Pallas kernels in
interpret mode at W = 160, H = 2 (head dim 80) on the same numpy inputs and
params. Tolerances as in the head-dim-64 files: fp32 2e-4 for the forward
halves, 5e-3 for int8 and for gradients; in bf16 the two share every
rounding point (the scale 1/sqrt(80) is rounded to bf16 before it scales q,
as ``jnp.asarray(scale, dt)`` does), so an output may differ by one bf16 step
(2^-6 below 4). The CUDA kernels are compared with these plain versions at
ViT-H-14's vision shape on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.layers import block_apply as jblock_apply
from evr_tpu.models.layers import init_block
from evr_tpu.models.quant import _quantize_block as jquantize_block
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.quant import _quantize_block as tquantize_block
from evr_tpu_torch.ops import block_fused as tbf

W, H = 160, 2  # head dim 80
TOL = dict(rtol=2e-4, atol=2e-4)
INT8_TOL = dict(rtol=5e-3, atol=5e-3)
DX_TOL, GRAD_TOL = 2e-4, 5e-3
BF16_STEP = 2.0 ** -6


@pytest.fixture(scope="module")
def block():
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(5), W, 12))
    rng = np.random.default_rng(0)
    for ln in ("ln_1", "ln_2"):  # non-trivial LN params and biases
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# B = 3 runs one sequence per JAX tile; B = 4 at T = 10 packs four
@pytest.mark.parametrize("shape, causal", [((3, 17, W), False), ((4, 10, W), True)])
def test_k1_plain_d80_matches_jax_kernel(block, shape, causal):
    jp, tp = block
    x = _x(shape)
    ref = np.asarray(jbf.fused_attn_block(
        jnp.asarray(x), *tbf.block_half_params(jp)[0], n_heads=H, causal=causal, interpret=True))
    before = tbf.fused_attn_block.launches
    got = tbf.fused_attn_block(torch.from_numpy(x), *tbf.block_half_params(tp)[0], n_heads=H,
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert tbf.fused_attn_block.launches == before  # CPU tensor: no kernel launch


def test_k1_plain_d80_bf16_matches_jax_kernel(block):
    jp, tp = block
    x = _x((4, 10, W), seed=2)
    ref = jbf.fused_attn_block(jnp.asarray(x).astype(jnp.bfloat16), *tbf.block_half_params(jp)[0],
                               n_heads=H, causal=True, interpret=True)
    got = tbf.fused_attn_block(torch.from_numpy(x).bfloat16(), *tbf.block_half_params(tp)[0], n_heads=H,
                               causal=True)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - np.asarray(ref.astype(jnp.float32))).max() <= BF16_STEP


@pytest.mark.parametrize("causal, activation", [(False, "gelu"), (True, "quick_gelu")])
def test_k3_plain_d80_matches_jax_kernel(block, causal, activation):
    """K3a (and K3b behind it) over int8 weights at head dim 80."""
    jp, tp = block
    jq = jax.tree.map(np.asarray, jquantize_block(jp))
    tq = tquantize_block(tp)
    x = _x((3, 17, W), seed=3)
    ref = np.asarray(jbf.fused_quant_block_apply(jnp.asarray(x), jq, H, activation, causal, interpret=True))
    before = tbf.fused_attn_block_q.launches
    got = tbf.fused_quant_block_apply(torch.from_numpy(x), tq, H, activation, causal).numpy()
    np.testing.assert_allclose(got, ref, **INT8_TOL)
    assert tbf.fused_attn_block_q.launches == before


@pytest.mark.parametrize("B, T, causal, dtype", [
    (3, 17, False, "float32"), (4, 10, True, "float32"), (3, 10, True, "bfloat16"),
])
def test_k5a_plain_d80_matches_jax_kernel(block, B, T, causal, dtype):
    jp, tp = block
    rng = np.random.default_rng(4)
    x, g = (rng.standard_normal((B, T, W)).astype(np.float32) for _ in range(2))
    ref = jbf.fused_attn_block_bwd(
        jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype),
        *tbf.block_half_params(jp)[0], n_heads=H, causal=causal, interpret=True)
    dt = getattr(torch, dtype)
    got = tbf.fused_attn_block_bwd(torch.from_numpy(x).to(dt), torch.from_numpy(g).to(dt),
                                   *tbf.block_half_params(tp)[0], n_heads=H, causal=causal)
    assert got[0].dtype == dt and all(t.dtype == torch.float32 for t in got[1:])
    for i, (u, r) in enumerate(zip(got, ref)):
        u, r = u.float().numpy(), np.asarray(r.astype(jnp.float32))
        err = np.abs(u - r).max()
        if dtype == "float32":
            assert err <= (DX_TOL if i == 0 else GRAD_TOL), (i, err)
        else:
            assert err <= (BF16_STEP if i == 0 else GRAD_TOL * np.abs(r).max()), (i, err)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the route check of
    ``block_apply`` without a card."""

    @property
    def is_cuda(self):
        return True


def test_block_apply_default_is_xla_as_in_jax(block, monkeypatch):
    """Left out, ``attn_impl`` is "xla" in both packages: the composition,
    never the fused route, even for a tensor on the card. Under an explicit
    "auto" the same tensor reaches the fused route."""
    jp, tp = block
    routed = []
    monkeypatch.setattr(tlayers, "fused_block_apply", lambda *a, **k: routed.append("fused"))
    x = _x((2, 9, W), seed=5)
    got = tlayers.block_apply(torch.from_numpy(x).as_subclass(_ClaimsCuda), tp, H)
    assert routed == []
    ref = np.asarray(jblock_apply(jnp.asarray(x), jp, H))
    np.testing.assert_allclose(torch.Tensor(got).numpy(), ref, **TOL)
    tlayers.block_apply(torch.from_numpy(x).as_subclass(_ClaimsCuda), tp, H, attn_impl="auto")
    assert routed == ["fused"]
