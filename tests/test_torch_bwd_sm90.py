"""K5's ten bf16 products on the Hopper GEMM, in the backward's layouts.

The wgmma + TMA GEMM (``evr_tpu_torch/ops/csrc/gemm_sm90.cuh``) runs K5a's
and K5b's bf16 products only on the card, where ``chip_smoke.py`` holds each
layout to ``torch.matmul`` and K5 to its plain versions; here the CPU checks
what that rests on:

- the per-layout shape rule (``gemm_takes`` with ``a_t``/``w_t``, mirroring
  the C rule) takes all ten products of every tower the fused route trains
  or serves, ragged K included, and a bf16 K5 call it does not take raises
  before any library loads (the bf16 rule narrowed from W % 128 to W % 256;
  fp32 calls keep the CUDA-core GEMM and its rule);
- ``gemm_bf16_plain``'s layout arguments mean what their definitions say,
  and fed the operands the plain K5 halves round, they give those halves'
  weight gradients and dy (the plain halves are held to JAX's K5 by
  ``test_torch_block_bwd.py``);
- the header is in the backward libraries' build key, and their ctypes
  declarations match the C entry points;
- the split weight gradient's plain mirror (slice sums added in slice
  order) equals the unsplit sum within fp32 order.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from evr_tpu_torch.models import MODEL_REGISTRY
from evr_tpu_torch.models.layers import FUSED_MAX_WIDTH
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build

W, H = 128, 2
BF16 = torch.bfloat16


def _tower_shapes(cfg):
    """(width, rows) the fused block route multiplies for a tower: one
    sequence, the serving batch (256 frames, 16 queries) and the training
    batch 32, vision and text."""
    v, t = cfg.vision, cfg.text
    tokens = (v.image_size // v.patch_size) ** 2 + 1
    return [(v.width, r) for r in (tokens, 256 * tokens, 32 * tokens)] + [
        (t.width, r) for r in (77, 16 * 77, 32 * 77)
    ]


@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY if n != "ViT-Tiny-Test"])
def test_k5_gemms_take_every_fused_tower(name):
    """"auto_grad" sends ViT-L/14@336px's vision tower (T 577) to K5; the
    kernel-level checks run K5 at the text and ViT-H-14 widths too. Every
    tower the fused route takes has all ten products in their layouts, with
    K = rows ragged for the weight gradients."""
    for width, rows in _tower_shapes(MODEL_REGISTRY[name]):
        if width > FUSED_MAX_WIDTH:
            continue
        gemms = tbf.attn_bwd_gemms(rows, width) + tbf.mlp_bwd_gemms(rows, width, 4 * width)
        assert len(gemms) == 10
        for M, N, K, a_t, w_t in gemms:
            assert tbf.gemm_takes(M, N, K, a_t, w_t), (name, width, rows, M, N, K, a_t, w_t)
        # the weight gradients sum over the rows, in the transposed-A layout
        assert [K for _, _, K, a_t, _ in gemms if a_t] == [rows] * 4


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def _half_args(width, half):
    z = torch.zeros
    if half == "attn":
        return [z(width), z(width), z(width, 3 * width), z(3 * width), z(width, width), z(width)]
    return [z(width), z(width), z(width, 4 * width), z(4 * width), z(4 * width, width), z(width)]


def _call_bwd(half, x, g, width):
    if half == "attn":
        return tbf.fused_attn_block_bwd(x, g, *_half_args(width, half), n_heads=width // 64)
    return tbf.fused_mlp_block_bwd(x, g, *_half_args(width, half))


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_bf16_k5_off_tile_width_raises_before_any_library_loads(half, monkeypatch):
    """W 160 (two heads of 80) puts K5's products off the wgmma GEMM's
    64-wide tile (N 160), so a bf16 call raises in the wrapper, before a
    library loads. An fp32 call at that width still goes on to its library
    (the CUDA-core GEMM, whose C side refuses it), as does a bf16 call at W
    256; a bf16 x off a 16-byte boundary raises too."""

    def no_load(name):
        raise RuntimeError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)
    for width, dt, expect in ((160, BF16, ValueError), (160, torch.float32, RuntimeError),
                              (256, BF16, RuntimeError)):
        x = torch.zeros(2, 5, width, dtype=dt).as_subclass(_ClaimsCuda)
        g = torch.zeros(2, 5, width, dtype=dt).as_subclass(_ClaimsCuda)
        with pytest.raises(expect, match="does not take" if expect is ValueError else "loaded"):
            _call_bwd(half, x, g, width)
    off = torch.zeros(2 * 5 * 256 + 1, dtype=BF16)[1:].view(2, 5, 256).as_subclass(_ClaimsCuda)
    g = torch.zeros(2, 5, 256, dtype=BF16).as_subclass(_ClaimsCuda)
    with pytest.raises(ValueError, match="16-byte"):
        _call_bwd(half, off, g, 256)
    # the rule per layout: K a multiple of 64 where it is contiguous, else
    # any K; with a transposed A, M a multiple of 8; N on the 64-wide tile
    assert tbf.gemm_takes(1024, 3072, 18464, a_t=True) and tbf.gemm_takes(256, 256, 40, a_t=True)
    assert not tbf.gemm_takes(1024, 3072, 18464) and not tbf.gemm_takes(18464, 1024, 3000, w_t=True)
    assert tbf.gemm_takes(18464, 1024, 3072, w_t=True)
    assert not tbf.gemm_takes(1020, 256, 64, a_t=True) and not tbf.gemm_takes(384, 416, 1000, a_t=True)
    assert tbf.gemm_takes(384, 384, 1000, a_t=True)


def test_gemm_bf16_plain_layouts_equal_their_definitions():
    rng = np.random.default_rng(7)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)

    M, N, K = 40, 256, 72
    a, a_stored_t, w, w_stored_t, bias = bf(M, K), bf(K, M), bf(K, N), bf(N, K), bf(N)
    exact = {
        (False, False): a.double() @ w.double(),
        (False, True): a.double() @ w_stored_t.double().T,
        (True, False): a_stored_t.double().T @ w.double(),
    }
    for (a_t, w_t), ref in exact.items():
        aa, ww = (a_stored_t if a_t else a), (w_stored_t if w_t else w)
        got32 = tbf.gemm_bf16_plain(aa, ww, a_t=a_t, w_t=w_t, out_dtype=torch.float32)
        assert got32.dtype == torch.float32 and got32.shape == (M, N)
        np.testing.assert_allclose(got32.double().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        # bf16 out: the fp32 sum plus the bias, rounded once
        got = tbf.gemm_bf16_plain(aa, ww, bias, a_t=a_t, w_t=w_t)
        assert torch.equal(got, (got32 + bias.float()).to(BF16))
    # on a CPU tensor gemm_bf16 is its plain version, in each layout it takes
    before = tbf.gemm_bf16.launches
    for a_t, w_t, out_dtype in tbf.GEMM_BF16_LAYOUTS:
        aa, ww = (a_stored_t if a_t else a), (w_stored_t if w_t else w)
        kw = dict(a_t=a_t, w_t=w_t, out_dtype=out_dtype)
        assert torch.equal(tbf.gemm_bf16(aa, ww, **kw), tbf.gemm_bf16_plain(aa, ww, **kw))
    assert tbf.gemm_bf16.launches == before
    with pytest.raises(ValueError, match="not taken"):
        tbf.gemm_bf16(a_stored_t, w, a_t=True)  # a weight gradient rounded to bf16: no K5 product
    with pytest.raises(ValueError, match="no bias"):
        tbf.gemm_bf16(a_stored_t, w, bias, a_t=True, out_dtype=torch.float32)


def _block_args(seed):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32)).to(BF16)

    attn = [t(W, std=0.1, mean=1.0), t(W, std=0.1), t(W, 3 * W, std=W ** -0.5), t(3 * W, std=0.02),
            t(W, W, std=W ** -0.5), t(W, std=0.02)]
    mlp = [t(W, std=0.1, mean=1.0), t(W, std=0.1), t(W, 4 * W, std=W ** -0.5), t(4 * W, std=0.02),
           t(4 * W, W, std=(4 * W) ** -0.5), t(W, std=0.02)]
    x, g = t(3, 50, W), t(3, 50, W, std=0.1)
    return x, g, attn, mlp


def _close(got, ref):
    """Equal within fp32 order: the same products, summed by another call."""
    scale = ref.abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_layouts_give_the_plain_halves_gradients(half):
    """The operands the plain halves round (y, round(dqkv), o, g, h,
    round(dh_pre)) through ``gemm_bf16_plain`` in the backward layouts give
    the halves' weight gradients, and the dy they feed the LN backward gives
    their dx: the layouts are what the kernel computes (bf16, W 128, H 2,
    150 rows)."""
    x, g, attn, mlp = _block_args(11)
    B, T, _ = x.shape
    rows = x.reshape(-1, W)
    g2 = g.reshape(-1, W)
    f32 = dict(out_dtype=torch.float32)
    xhat, inv, _ = tbf._ln_fwd_stats(rows.float(), attn[0] if half == "attn" else mlp[0],
                                     attn[1] if half == "attn" else mlp[1])
    if half == "attn":
        ref = tbf.fused_attn_block_bwd_plain(x, g, *attn, n_heads=H)
        y = tbf.ln_rows_plain(rows, attn[0], attn[1])
        qkv = tbf.gemm_bf16_plain(y, attn[2], attn[3])  # K5a's qkv: the forward layout, rounded
        dout = tbf.gemm_bf16_plain(g2, attn[4], w_t=True)  # do = round(g·W_outᵀ)
        o, dqkv = tbf.attn_backward_plain(qkv.reshape(B, T, 3 * W), dout.reshape(B, T, W), H)
        dqkv_r = dqkv.to(BF16)
        grads = {3: tbf.gemm_bf16_plain(y, dqkv_r, a_t=True, **f32),  # dW_qkv = yᵀ·round(dqkv)
                 5: tbf.gemm_bf16_plain(o, g2, a_t=True, **f32)}  # dW_out = oᵀ·g
        dy = tbf.gemm_bf16_plain(dqkv_r, attn[2], w_t=True, **f32)  # dy = round(dqkv)·W_qkvᵀ
        assert torch.equal(ref[4], dqkv.sum(0))
        ln_scale = attn[0]
    else:
        ref = tbf.fused_mlp_block_bwd_plain(x, g, *mlp)
        y = tbf.ln_rows_plain(rows, mlp[0], mlp[1])
        h_pre = tbf.gemm_bf16_plain(y, mlp[2], **f32) + mlp[3].float()
        h_act, dact = tbf._activate_grad(h_pre, "quick_gelu")
        h = h_act.to(BF16)
        dh_pre = tbf.gemm_bf16_plain(g2, mlp[4], w_t=True, **f32) * dact  # dh = g·W_projᵀ
        dhp = dh_pre.to(BF16)
        grads = {3: tbf.gemm_bf16_plain(y, dhp, a_t=True, **f32),  # dW_fc = yᵀ·round(dh_pre)
                 5: tbf.gemm_bf16_plain(h, g2, a_t=True, **f32)}  # dW_proj = hᵀ·g
        dy = tbf.gemm_bf16_plain(dhp, mlp[2], w_t=True, **f32)  # dy = round(dh_pre)·W_fcᵀ
        _close(dh_pre.sum(0), ref[4])
        ln_scale = mlp[0]
    for i, got in grads.items():
        _close(got, ref[i])
    dx, dls, dlb = tbf._ln_bwd(dy, xhat, inv, ln_scale, g2.float())
    _close(dls, ref[1])
    _close(dlb, ref[2])
    # dx rounds once: sums in another order may round it one bf16 step apart
    err = (dx.to(BF16).float() - ref[0].reshape(-1, W).float()).abs()
    assert err.max().item() <= 2.0 ** -6 and (err > 0).float().mean().item() < 0.01


def _c_entries(source: str) -> dict[str, list[str]]:
    """extern "C" functions of a source: name -> parameter kinds (p, i, f)."""
    kinds = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source):
        params = [q.strip() for q in m.group(2).split(",")]
        kinds[m.group(1)] = ["p" if "*" in q else "f" if q.startswith("float") else "i" for q in params]
    return kinds


class _Lib:
    """Records what ``build._declare`` sets on each entry point."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def test_backward_libraries_build_key_and_entry_points(tmp_path, monkeypatch):
    """The header is in the backward libraries' build key, and the ctypes
    declarations of their entry points (and of ``evr_gemm_bf16``) match the
    C signatures, pointer for pointer."""
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for name in ("block_attn_bwd", "block_mlp_bwd", "block_mlp"):
        lib = _Lib()
        build._declare(name, lib)
        entries = _c_entries((build.CSRC / f"{name}.cu").read_text())
        assert set(lib.fns) == set(entries), name
        for fn, params in entries.items():
            assert [kind[t] for t in lib.fns[fn].argtypes] == params, fn
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("block_attn_bwd", "block_mlp_bwd")
    for name in names:
        assert '#include "grad_common.cuh"' in (csrc / f"{name}.cu").read_text()
    assert '#include "gemm_sm90.cuh"' in (csrc / "grad_common.cuh").read_text()
    before = {name: build.library_path(name) for name in names}
    header = csrc / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    assert all(build.library_path(name) != before[name] for name in names)


def test_split_slices_sum_in_order_to_the_unsplit_sum():
    """A weight gradient on fewer output tiles than half the SMs is cut into
    at most four slices of at least 16 64-row steps: at ViT-L/14@336px K5a's
    dW_out (32 tiles) splits and nothing else does; at the text shape (20
    steps) nothing splits, at ViT-H-14's 4 x 577 rows dW_out in two. The
    slices' sums added in slice order equal the one-pass sum within fp32
    order."""
    R = 32 * 577
    slices = [-(-K // tbf.gemm_k_slice(M, N, K, a_t, w_t))
              for M, N, K, a_t, w_t in tbf.attn_bwd_gemms(R, 1024) + tbf.mlp_bwd_gemms(R, 1024, 4096)]
    assert slices == [1, 1, 1, 1, 4, 1, 1, 1, 1, 1]
    assert tbf.gemm_k_slice(1024, 1024, R, a_t=True) == 73 * 64  # 289 steps: 73, 73, 73, 70
    for rows, width, want in ((1232, 768, [1] * 5), (4 * 577, 1280, [1, 1, 1, 1, 2])):
        got = [-(-K // tbf.gemm_k_slice(M, N, K, a_t, w_t)) for M, N, K, a_t, w_t in tbf.attn_bwd_gemms(rows, width)]
        assert got == want, (rows, width)
    assert tbf.gemm_split_floats(tbf.attn_bwd_gemms(R, 1024)) == 4 * 1024 * 1024
    assert tbf.gemm_split_floats(tbf.mlp_bwd_gemms(R, 1024, 4096)) == 0
    rng = np.random.default_rng(9)
    K, M, N = 4000, 256, 256  # 63 steps: three slices of 21 steps, 1,344 rows
    a = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(BF16)
    assert tbf.gemm_k_slice(M, N, K, a_t=True) == 1344
    got = tbf.gemm_slices_plain(a, w)
    parts = [a[k:k + 1344].T.float() @ w[k:k + 1344].float() for k in range(0, K, 1344)]
    assert torch.equal(got, (parts[0] + parts[1]) + parts[2])
    _close(got, tbf.gemm_bf16_plain(a, w, a_t=True, out_dtype=torch.float32))
    # not split: one fp32 product
    big_n = tbf.gemm_k_slice(M, 66 * 256, K, a_t=True)
    assert big_n == K
