"""The port's K6 wrapper (``evr_tpu_torch.ops.attention``) against the JAX
package's ``flash_attention`` on the CPU.

Same numpy inputs [B, H, T, d] (B·H ≤ 4) through JAX's Pallas kernel in
interpret mode (its CPU default) and through the port, whose CPU tensors
take K6's plain version. Shapes: T 50 (the whole-sequence route, which the
TPU kernel packs four sequences to a tile), T 257 at head dim 80, causal
T 77 at head dim 64 (the blocked route), and an explicit ``block_q``.
Tolerances: fp32 2e-4 (the same rounding points; only sums run in another
order, measured ~1e-6); bf16 one bf16 step (rtol 2^-7) on at most 1 % of
the elements, which the scale rounded to bf16 at d = 80 (1/√80 →
0.11181640625) is needed for: an unrounded scale moves ~18 % of them;
gradients 5e-3 against ``jax.vjp`` of the JAX function.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.ops import attention as jattn
from evr_tpu_torch.ops import attention as tattn

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_STEP = 2.0 ** -7  # one bf16 step, relative
BF16_MAX_DIFFERING = 0.01
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)

SHAPES = {
    "T50-packed": dict(shape=(2, 2, 50, 64), causal=False, block_q=None),
    "T257-d80": dict(shape=(1, 2, 257, 80), causal=False, block_q=None),
    "T77-causal": dict(shape=(2, 2, 77, 64), causal=True, block_q=None),
    "T257-d80-block_q": dict(shape=(1, 2, 257, 80), causal=False, block_q=128),
}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(case, dtype):
    q, k, v = _qkv(case["shape"])
    ref = jattn.flash_attention(
        *(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), causal=case["causal"],
        block_q=case["block_q"])
    got = tattn.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        causal=case["causal"], block_q=case["block_q"])
    assert got.dtype == getattr(torch, dtype) and got.shape == case["shape"]
    return got.float().numpy(), np.asarray(ref).astype(np.float32)


@pytest.mark.parametrize("name", list(SHAPES))
def test_flash_attention_fp32_matches_jax(name):
    got, ref = _both(SHAPES[name], "float32")
    np.testing.assert_allclose(got, ref, **FP32_TOL)


@pytest.mark.parametrize("name", ["T257-d80", "T77-causal"])
def test_flash_attention_bf16_matches_jax(name):
    got, ref = _both(SHAPES[name], "bfloat16")
    np.testing.assert_allclose(got, ref, rtol=BF16_STEP, atol=BF16_STEP * np.abs(ref).max())
    assert (got != ref).mean() <= BF16_MAX_DIFFERING


def test_bf16_scale_rounded_to_the_element_type():
    """For d = 80 the scale is 1/√80 rounded to bf16 (0.11181640625), as
    jnp.asarray(1/√d, q.dtype) is; q scaled by the unrounded scale moves
    ~18 % of the outputs off JAX's, which the bf16 check above would catch."""
    scale = torch.tensor(1 / math.sqrt(80), dtype=torch.bfloat16).item()
    assert scale == 0.11181640625 == float(jnp.asarray(1 / math.sqrt(80), jnp.bfloat16))
    got, ref = _both(SHAPES["T257-d80"], "bfloat16")
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(SHAPES["T257-d80"]["shape"]))
    s = (q.float() * (1 / math.sqrt(80))).bfloat16().float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    unrounded = ((p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    assert (got != ref).mean() <= BF16_MAX_DIFFERING < (unrounded.float().numpy() != ref).mean()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax_vjp(causal):
    """The backward is the plain recompute of the JAX custom VJP: q/k/v
    gradients against ``jax.vjp`` of the JAX function."""
    shape = (1, 2, 77, 80)
    q, k, v = _qkv(shape, seed=3)
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(a, b, c, causal), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got_out = tattn.flash_attention(*leaves, causal=causal)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **FP32_TOL)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **GRAD_TOL)


def test_xla_attention_matches_jax():
    q, k, v = _qkv((1, 3, 33, 64), seed=5)
    for causal in (False, True):
        ref = np.asarray(jattn._xla_attention(*map(jnp.asarray, (q, k, v)), causal))
        got = tattn.xla_attention(*map(torch.from_numpy, (q, k, v)), causal).numpy()
        np.testing.assert_allclose(got, ref, **FP32_TOL)


def test_routes_follow_the_jax_rule(monkeypatch):
    """K6a for whole sequences (not causal, no block_q, T·T·4 ≤ 4 MiB), K6b
    otherwise; a CPU tensor reaches the route and takes the plain version,
    launching nothing; an unknown impl raises."""
    assert tattn.whole_sequence_route(50, False, None)
    assert tattn.whole_sequence_route(1024, False, None)
    assert not tattn.whole_sequence_route(1025, False, None)
    assert not tattn.whole_sequence_route(50, True, None)
    assert not tattn.whole_sequence_route(50, False, 128)
    before = (tattn.flash_attention_full.launches, tattn.flash_attention_blocked.launches)
    calls = []
    for name in ("flash_attention_full", "flash_attention_blocked"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    x = torch.zeros((1, 1, 8, 64))
    tattn.flash_attention(x, x, x)
    tattn.flash_attention(x, x, x, causal=True)
    tattn.flash_attention(x, x, x, block_q=128)
    tattn.flash_attention(x, x, x, impl="plain")
    assert calls == ["flash_attention_full", "flash_attention_blocked", "flash_attention_blocked"]
    monkeypatch.undo()
    assert (tattn.flash_attention_full.launches, tattn.flash_attention_blocked.launches) == before
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.flash_attention(x, x, x, impl="cudnn")


def test_kernel_inputs_checked_before_a_launch():
    """What the CUDA kernel cannot take raises before any pointer is passed:
    a head dim other than 64/80, another dtype, a non-contiguous input, and
    q, k, v that disagree."""
    ok = torch.zeros((1, 2, 10, 80))
    tattn._check_kernel_inputs(ok, ok, ok, "t")
    bad = {
        "head dim 72": (torch.zeros((1, 2, 10, 72)),) * 3,
        "dtype torch.float16": (ok.half(),) * 3,
        "must be contiguous": (ok.transpose(1, 2).contiguous().transpose(1, 2), ok, ok),
        "k is torch.bfloat16": (ok, ok.bfloat16(), ok),
        r"v is torch.float32 \(1, 2, 11, 80\)": (ok, ok, torch.zeros((1, 2, 11, 80))),
        r"expected \[B, H, T, d\]": (ok[0],) * 3,
    }
    for pattern, args in bad.items():
        with pytest.raises(ValueError, match=pattern):
            tattn._check_kernel_inputs(*args, "t")
