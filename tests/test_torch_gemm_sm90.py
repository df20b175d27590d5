"""The Hopper GEMM under K1, K2 and K9 and the LayerNorm row pass before it.

The wgmma + TMA GEMM (``evr_tpu_torch/ops/csrc/gemm_sm90.cuh``) runs only on
the card, where ``chip_smoke.py`` holds it to ``torch.matmul`` and checks
its SASS; here the CPU checks what it rests on:

- its shape rule, mirrored by ``ops.block_fused.gemm_takes``, takes every
  GEMM the block halves run for each registry tower but the tiny test one,
  and refuses an N or K off its tile;
- the block halves now normalise in a row pass first (``ln_rows_plain``,
  K8's function on the element-type LN parameters): the y the plain halves
  multiply with is, bit for bit, K8's plain output and the old fused
  prologue's value, and the halves built on it still match the JAX Pallas
  kernels in interpret mode at the JAX kernel tests' fp32 tolerance (2e-4);
- the new header is part of the build key of the libraries that include it;
- ``gemm_bf16``, the GEMM alone, takes its plain version on a CPU tensor.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.layers import init_block
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models import MODEL_REGISTRY
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build
from evr_tpu_torch.ops.layernorm import fused_layer_norm_plain

TOL = dict(rtol=2e-4, atol=2e-4)
W, H = 128, 2


def _block_gemms(width: int, rows: int) -> list[tuple[int, int, int]]:
    """(M, N, K) of the four GEMMs of one residual block (K1: QKV and out;
    K2: fc and proj; K9 runs all four)."""
    return [(rows, 3 * width, width), (rows, width, width), (rows, 4 * width, width),
            (rows, width, 4 * width)]


def _tower_rows(cfg):
    """Row counts the towers multiply: a single sequence, the serving batch
    of 256 frames (vision) or 16 queries (text), and the training batch 32."""
    v, t = cfg.vision, cfg.text
    tokens = (v.image_size // v.patch_size) ** 2 + 1
    return ((v.width, [tokens, 256 * tokens, 32 * tokens]), (t.width, [77, 16 * 77, 32 * 77]))


@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY if n != "ViT-Tiny-Test"])
def test_gemm_takes_every_block_gemm_of_the_tower(name):
    for width, row_counts in _tower_rows(MODEL_REGISTRY[name]):
        for rows in row_counts:
            for M, N, K in _block_gemms(width, rows):
                assert tbf.gemm_takes(M, N, K), (name, width, M, N, K)


def test_gemm_takes_refuses_off_tile_shapes():
    assert tbf.gemm_takes(1, 256, 64) and tbf.gemm_takes(150, 768, 768)
    # the tiny test tower's width 64 gives N = 64, 192, 256 with K = 64, 256:
    # its QKV, out and proj GEMMs are off the 256-wide tile and take the
    # 64-wide narrow one
    tiny = MODEL_REGISTRY["ViT-Tiny-Test"].vision.width
    assert [tbf.gemm_takes(8, N, K) for _, N, K in _block_gemms(tiny, 8)] == [True, True, True, True]
    assert not tbf.gemm_takes(128, 96, 128)  # N off the 64-wide narrow tile
    assert not tbf.gemm_takes(128, 416, 128, w_t=True)  # a transposed product: N off the 64-wide tile
    assert tbf.gemm_takes(128, 384, 128, w_t=True)  # and N 384 on the narrow one
    assert not tbf.gemm_takes(128, 256, 96)  # K off the 64-wide step
    assert not tbf.gemm_takes(0, 256, 64)  # no rows
    assert not tbf.gemm_takes(65535 * 128 + 1, 256, 64)  # past the grid's row tiles
    assert tbf.gemm_takes(65535 * 128, 256, 64)


@pytest.fixture(scope="module")
def block():
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(3), W, 12))
    rng = np.random.default_rng(3)
    for ln in ("ln_1", "ln_2"):
        jp[ln]["scale"] = (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32)
        jp[ln]["bias"] = (0.1 * rng.standard_normal(W)).astype(np.float32)
    for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "fc"), ("mlp", "proj")):
        b = jp[grp][name]["bias"]
        jp[grp][name]["bias"] = (0.02 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp, params_from_numpy(jp)


def _x(shape, seed=4):
    return (np.random.default_rng(seed).standard_normal(shape) * 2 + 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_pass_is_the_y_the_plain_halves_multiply(block, monkeypatch, dtype):
    _, tp = block
    attn, mlp = tbf.block_half_params(tp)
    x = torch.from_numpy(_x((3, 50, W))).to(dtype)
    seen = []

    def recording(x_, s, b):
        y = tbf_ln_rows(x_, s, b)
        seen.append((x_, s, b, y))
        return y

    tbf_ln_rows = tbf.ln_rows_plain
    monkeypatch.setattr(tbf, "ln_rows_plain", recording)
    tbf.fused_attn_block(x, *attn, n_heads=H)
    tbf.fused_mlp_block(x, *mlp, activation="gelu")
    assert len(seen) == 2  # one row pass per half
    for (x_, s, b, y), half in zip(seen, (attn, mlp)):
        assert x_ is x and y.dtype == dtype and y.shape == x.shape
        # the LN parameters arrive cast to x's dtype, as the wrappers pass them
        assert torch.equal(s, half[0].to(dtype)) and torch.equal(b, half[1].to(dtype))
        # K8's function on the fp32 values of those element-type parameters
        assert torch.equal(y, fused_layer_norm_plain(x, s.float(), b.float()))
        # the old fused prologue's value: LN in fp32, rounded once
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        inv = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + tbf.LN_EPS)
        assert torch.equal(y, ((x32 - mean) * inv * s.float() + b.float()).to(dtype))


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_halves_on_the_row_pass_match_jax_kernels(block, half):
    jp, tp = block
    x = _x((3, 50, W))  # 150 rows: a ragged count for 128-row tiles
    if half == "attn":
        ref = jbf.fused_attn_block(jnp.asarray(x), *tbf.block_half_params(jp)[0], n_heads=H,
                                   causal=True, interpret=True)
        got = tbf.fused_attn_block(torch.from_numpy(x), *tbf.block_half_params(tp)[0], n_heads=H,
                                   causal=True)
    else:
        ref = jbf.fused_mlp_block(jnp.asarray(x), *tbf.block_half_params(jp)[1], activation="gelu",
                                  interpret=True, block_rows=16)
        got = tbf.fused_mlp_block(torch.from_numpy(x), *tbf.block_half_params(tp)[1], activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gemm_header_is_in_the_block_libraries_build_key(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("block_attn", "block_mlp", "block_merged")
    for name in names:
        assert '#include "gemm_sm90.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {name: build.library_path(name) for name in names}
    header = csrc / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert all(build.library_path(name) != before[name] for name in names)


def test_gemm_bf16_takes_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    a, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((150, 64), (64, 256), (256,)))
    before = tbf.gemm_bf16.launches
    got = tbf.gemm_bf16(a, w, b)
    assert tbf.gemm_bf16.launches == before  # CPU tensor: no kernel launch
    ref = (a.double() @ w.double() + b.double()).float().bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == (150, 256)
    # the fp32 sum and the exact one round to bf16 at most one step apart
    step = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    assert (got.float() - ref.float()).abs().max().item() <= step
