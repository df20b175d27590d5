"""The int8 GEMM under K3a and K3b: ``csrc/gemm_s8_sm90.cuh``.

K3a's and K3b's four products run on one warp-specialised TMA + wgmma s8
kernel (``wgmma`` m64n256k32 ``.s32.s8.s8``; a 64-wide tile where N is not a
multiple of 256), in both element types, with the dequantising epilogues of
the reference. wgmma reads 8-bit operands K-major only, so each [in, out]
int8 kernel is read through a K-major copy that ``ops.block_fused.k_major``
makes once on the card (``evr_transpose_s8``) and keeps beside the weight;
the params keep their layout. The kernel runs only on the card,
where ``chip_smoke.py`` holds ``ops.block_fused.gemm_s8`` to
``torch._int_mm`` and to ``gemm_s8_plain``; here the CPU checks what that
rests on:

- ``gemm_s8_plain``'s int32 sums equal numpy's int64 product exactly, at K
  up to 5,120 and a ragged M;
- its epilogues are bit-equal to the K3 plain halves at their rounding
  points (``dequant_dot`` and the activation or the residual after it);
- the K-major copies are made once per weight, beside it (again after an
  in-place change): the params, their layout and leaves, and the
  converter's output are unchanged;
- the wrapper's shape rule and routes, the new header in ``block_quant``'s
  build key, and the ctypes declarations of the changed entry points.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax

from evr_tpu.models.layers import init_block
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.quant import _quantize_block as tquantize_block
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build
from evr_tpu_torch.ops.int8 import dequant_dot, quantize_rows


def _operands(M, N, K, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    return a, w


@pytest.mark.parametrize("M, N, K", [(37, 64, 16), (150, 192, 64), (129, 256, 768), (33, 64, 5120)])
def test_gemm_s8_plain_int32_sums_are_exact(M, N, K):
    a, w = _operands(M, N, K, K)
    # the extreme rows: every product at +127 * +127 or +127 * -127
    a[0], w[:, 0] = 127, 127
    a[1] = -127
    got = tbf.gemm_s8_plain(torch.from_numpy(a), torch.ones(M), torch.from_numpy(w), torch.ones(N),
                            torch.zeros(N), "int32")
    ref = a.astype(np.int64) @ w.astype(np.int64)
    assert got.dtype == torch.int32 and ref[0, 0] == K * 127 * 127
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref)


@pytest.mark.parametrize("epilogue", ["store", "quick_gelu", "gelu", "residual"])
def test_gemm_s8_plain_epilogues_equal_the_k3_plain_halves(epilogue):
    """K3a's qkv (store) and out-proj (residual), K3b's h (an activation) and
    proj (residual), as the plain halves form them from an fp32 row block:
    per-token quantisation, then the exact product and its dequantisation."""
    rng = np.random.default_rng(3)
    M, K, N = 50, 64, 192
    y = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    ks = torch.from_numpy(rng.random(N).astype(np.float32) * 0.01)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32) * 0.02)
    yq, ys = quantize_rows(y)
    v = dequant_dot(y, kq, ks, b)
    for dt in (torch.float32, torch.bfloat16):
        res = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)).to(dt)
        got = tbf.gemm_s8_plain(yq, ys.reshape(-1), kq, ks, b, epilogue, dt,
                                res if epilogue == "residual" else None)
        if epilogue == "store":
            ref = v.to(dt)
        elif epilogue == "residual":
            ref = (res.float() + v).to(dt)
        else:
            ref = tbf._activate(v, epilogue)
        assert got.dtype == ref.dtype and torch.equal(got, ref), (epilogue, dt)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    """Records each entry point's calls and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def fn(*args):
            self.calls.setdefault(name, []).append(args)
            return 0
        return fn


class _Stream:
    cuda_stream = 0


def test_k_major_copies_are_made_once_beside_the_params_and_leave_them_unchanged(monkeypatch):
    """The K3 halves pass the int8 kernels K-major: each copy is made once
    (``evr_transpose_s8``), kept beside its weight and made anew after an
    in-place change of the weight; the params, their layout and leaves, and
    the converter's output stay as they are."""
    W = 64
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(2), W, 2))
    tp = tquantize_block(params_from_numpy(jp))
    leaves = {f"{g}.{n}": dict(tp[g][n]) for g in ("attn", "mlp") for n in tp[g]}
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in leaves.items()}
    # the converter's layout: kernel_q [in, out] int8, per-output scales, no other leaf
    for key, hid in (("attn.qkv", 3 * W), ("attn.out", W), ("mlp.fc", 4 * W), ("mlp.proj", W)):
        assert set(leaves[key]) == {"kernel_q", "kernel_scale", "bias"}
        assert leaves[key]["kernel_q"].dtype == torch.int8 and leaves[key]["kernel_scale"].shape == (hid,)
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    cuda = {k: {n: t.as_subclass(_ClaimsCuda) for n, t in v.items()} for k, v in leaves.items()}
    qp = {"ln_1": tp["ln_1"], "ln_2": tp["ln_2"],
          "attn": {n: cuda[f"attn.{n}"] for n in ("qkv", "out")},
          "mlp": {n: cuda[f"mlp.{n}"] for n in ("fc", "proj")}}
    x = torch.zeros(2, 17, W, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    tbf.fused_quant_block_apply(x, qp, 4)
    copies = lib.calls["evr_transpose_s8"]
    kernels = [cuda[n]["kernel_q"] for n in ("attn.qkv", "attn.out", "mlp.fc", "mlp.proj")]
    assert [c[0] for c in copies] == [k.data_ptr() for k in kernels]  # one copy of each, [in, out] in
    assert [c[2:4] for c in copies] == [tuple(k.shape) for k in kernels]  # K, N
    for entry, names in (("evr_fused_attn_block_q", ("attn.qkv", "attn.out")),
                         ("evr_fused_mlp_block_q", ("mlp.fc", "mlp.proj"))):
        args = lib.calls[entry][0]
        for at, name in zip((4, 7), names):  # each kernel passed as its K-major copy [out, in]
            w = cuda[name]["kernel_q"]
            w_t = tbf.k_major(w)
            assert args[at] == w_t.data_ptr() != w.data_ptr() and w_t.shape == w.shape[::-1]
    tbf.fused_quant_block_apply(x, qp, 4)  # the copies are kept: none made again
    assert len(lib.calls["evr_transpose_s8"]) == 4 and len(lib.calls["evr_fused_attn_block_q"]) == 2
    kernels[0].add_(0)  # an in-place change of a weight: its copy is made anew
    tbf.fused_quant_block_apply(x, qp, 4)
    assert len(lib.calls["evr_transpose_s8"]) == 5
    for k, v in leaves.items():
        for n, t in v.items():
            assert torch.equal(t, before[k][n]) and t.shape == before[k][n].shape, (k, n)
    assert tp["attn"]["qkv"]["kernel_q"].shape == (W, 3 * W) and tp["mlp"]["proj"]["kernel_q"].shape == (4 * W, W)


def test_gemm_s8_wrapper_routes_and_refuses_before_any_library_loads(monkeypatch):
    rng = np.random.default_rng(1)
    a, w = (torch.from_numpy(t) for t in _operands(40, 64, 32, 1))
    asc, wsc = torch.from_numpy(rng.random(40).astype(np.float32)), torch.from_numpy(rng.random(64).astype(np.float32))
    b = torch.zeros(64)
    before = tbf.gemm_s8.launches
    got = tbf.gemm_s8(a, asc, w, wsc, b, "gelu")  # a CPU tensor: the plain version
    assert tbf.gemm_s8.launches == before and got.dtype == torch.float32
    assert torch.equal(got, tbf.gemm_s8_plain(a, asc, w, wsc, b, "gelu"))
    with pytest.raises(ValueError, match="residual"):
        tbf.gemm_s8(a, asc, w, wsc, b, "residual")

    def no_load(name):
        raise RuntimeError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)

    def cuda(t):
        return t.as_subclass(_ClaimsCuda)

    with pytest.raises(RuntimeError, match="library block_quant loaded"):
        tbf.gemm_s8(cuda(a), cuda(asc), cuda(w), cuda(wsc), cuda(b), "int32")
    a24 = torch.zeros(40, 24, dtype=torch.int8)
    with pytest.raises(ValueError, match="does not take"):  # K off the 16-byte rows
        tbf.gemm_s8(cuda(a24), cuda(asc), cuda(torch.zeros(24, 64, dtype=torch.int8)), cuda(wsc), cuda(b))
    w96 = torch.zeros(32, 96, dtype=torch.int8)
    with pytest.raises(ValueError, match="does not take"):  # N off the 64-wide tile
        tbf.gemm_s8(cuda(a), cuda(asc), cuda(w96), cuda(torch.zeros(96)), cuda(torch.zeros(96)))
    # the K3 halves check the same rule first: W 96 (3 heads of 32) never loads a library
    x = torch.zeros(2, 5, 96, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    z = torch.zeros
    with pytest.raises(ValueError, match="does not take"):
        tbf.fused_mlp_block_q(x, z(96), z(96), z(96, 384, dtype=torch.int8), z(384), z(384),
                              z(384, 96, dtype=torch.int8), z(96), z(96))


def test_block_quant_runs_on_the_new_header_and_it_is_in_the_build_key(tmp_path, monkeypatch):
    src = (build.CSRC / "block_quant.cu").read_text()
    assert '#include "gemm_s8_sm90.cuh"' in src
    assert "igemm_kernel" not in src and "wmma" not in src  # the WMMA GEMM is gone, for both dtypes
    assert src.count("launch_gemm_s8<kQ") == 5  # K3a's two products, K3b's fc (two activations) and proj
    header = (build.CSRC / "gemm_s8_sm90.cuh").read_text()
    assert "m64n256k32.s32.s8.s8" in header and "m64n64k32.s32.s8.s8" in header
    assert "setmaxnreg.dec.sync.aligned.u32 40" in header and "setmaxnreg.inc.sync.aligned.u32 232" in header
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("block_quant")
    (csrc / "gemm_s8_sm90.cuh").write_text(header + "\n// edit\n")
    assert build.library_path("block_quant") != before


def test_block_quant_entry_declarations_match_their_c_signatures():
    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("Fn", (), {})())

    lib = Lib()
    build._declare("block_quant", lib)
    src = (build.CSRC / "block_quant.cu").read_text()
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for entry in ("evr_fused_attn_block_q", "evr_fused_mlp_block_q", "evr_gemm_s8", "evr_transpose_s8"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        kinds = ["p" if "*" in q else "f" if q.strip().startswith("float") else "i" for q in sig.group(1).split(",")]
        assert [kind[t] for t in lib.fns[entry].argtypes] == kinds, entry
        assert lib.fns[entry].restype is ctypes.c_int
