"""The bf16 attention forward on the Hopper kernel, K6a and K1's core.

``evr_tpu_torch/ops/csrc/attn_sm90.cuh`` (TMA + wgmma, warp-specialised)
runs the bf16 attention forward of K1, K3a and K9 (through ``flash.cuh``)
and of K6a and K6b (through ``flash_attn.cu``) only on the card, where
``chip_smoke.py`` holds it to the plain versions and counts ``HGMMA`` in its
own SASS function; here the CPU checks what that rests on:

- K1's attention core alone, ``ops.block_fused.attn_forward``, takes
  ``attn_forward_plain`` on a CPU tensor, and that matches JAX's Pallas K6
  (``evr_tpu.ops.attention.flash_attention``, interpret mode on the CPU) on
  q, k and v split from the same seeded qkv: fp32 at the JAX kernel tests'
  2e-4, bf16 within one bf16 step (rtol 2^-7) on at most 1 % of the
  elements, as ``test_torch_attention.py`` holds K6;
- the kernel's shape rule and shared-memory plan, mirrored by
  ``attn_takes``, ``attn_boxes``, ``attn_smem_bytes`` and ``attn_k_slots``:
  every bf16 attention of each registry tower but the tiny test one is
  taken, two blocks fit on an SM, a row of d 80 is a 128-byte-swizzled box
  of 64 columns and a 32-byte-swizzled one of 16, head dim 16 (the tiny
  test tower's, one 32-byte-swizzled box) goes on to its library and head
  dim 24 raises before any library loads;
- the routes: bf16 reaches the new kernel and fp32 keeps the CUDA-core
  kernels (by the dtype alone), the new header is in the build key of every
  library that includes it, and the new entry's ctypes declaration matches
  its C signature.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops import attention as jattn
from evr_tpu_torch.models import MODEL_REGISTRY
from evr_tpu_torch.ops import attention as tattn
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
SMEM_PER_BLOCK = 232448  # the most one block of an H100 may take (227 KB)
BF16_STEP = 2.0 ** -7  # one bf16 step, relative
BF16_MAX_DIFFERING = 0.01

# (head dim, T, causal): T 257 leaves a one-row tail tile, T 77 is the text
# towers' causal length, T 50 one part-filled tile
CORE_CASES = {
    "d64-T257": (64, 257, False),
    "d80-T257": (80, 257, False),
    "d64-T77-causal": (64, 77, True),
    "d80-T50": (80, 50, False),
}
H = 2


def _heads(x: np.ndarray, n_heads: int) -> np.ndarray:
    """[B, T, W] -> [B, H, T, d]"""
    B, T, W = x.shape
    return x.reshape(B, T, n_heads, W // n_heads).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_attn_forward_on_the_cpu_matches_jax_k6(case):
    d, T, causal = CORE_CASES[case]
    W = H * d
    qkv = np.random.default_rng(d + T).standard_normal((2, T, 3 * W)).astype(np.float32)
    q, k, v = (_heads(a, H) for a in np.split(qkv, 3, axis=-1))
    before = tbf.attn_forward.launches
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tbf.attn_forward(torch.from_numpy(qkv).to(dt), H, causal)
        assert got.dtype == dt and got.shape == (2, T, W)
        got = _heads(got.float().numpy(), H)
        ref = np.asarray(jattn.flash_attention(*(jnp.asarray(a, dtype=jdt) for a in (q, k, v)),
                                               causal=causal)).astype(np.float32)
        if dt == torch.float32:
            np.testing.assert_allclose(got, ref, **FP32_TOL)
        else:
            np.testing.assert_allclose(got, ref, rtol=BF16_STEP, atol=BF16_STEP * np.abs(ref).max())
            assert (got != ref).mean() <= BF16_MAX_DIFFERING
    assert tbf.attn_forward.launches == before  # CPU tensors: the plain version, no launch


def _attentions(cfg):
    """(sequences, T, heads, head dim) of every attention a tower runs: one
    sequence, the serving batch (256 frames, 16 queries) and the training
    batch 32, vision and text."""
    v, t = cfg.vision, cfg.text
    tokens = (v.image_size // v.patch_size) ** 2 + 1
    return [(n, tokens, v.heads, v.width // v.heads) for n in (1, 256, 32)] + [
        (n, 77, t.heads, t.width // t.heads) for n in (1, 16, 32)
    ]


@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY if n != "ViT-Tiny-Test"])
def test_the_kernel_takes_every_bf16_attention_of_the_tower(name):
    for seqs, T, heads, d in _attentions(MODEL_REGISTRY[name]):
        assert tbf.attn_takes(seqs, T, heads, d), (name, seqs, T, heads, d)
        slots = tbf.attn_k_slots(T, d)
        smem = tbf.attn_smem_bytes(d, slots)
        # two blocks share an SM, each under the 227 KB one block may take
        assert smem <= tbf.ATTN_SMEM_PER_BLOCK < SMEM_PER_BLOCK and 2 * (smem + 1024) <= tbf.SMEM_PER_SM
        assert 2 <= slots or -(-T // tbf.ATTN_TILE) == slots == 1


def test_plan_splits_d80_rows_and_keeps_short_key_rows_resident():
    # a 128-byte-swizzled TMA box is at most 128 bytes (64 bf16) wide
    assert tbf.attn_boxes(64) == [(0, 64, 128)]
    assert tbf.attn_boxes(80) == [(0, 64, 128), (64, 16, 32)]
    assert sum(w for _, w, _ in tbf.attn_boxes(80)) == 80
    # ViT-H-14's 257 keys (five blocks) stay resident at d 80, as ViT-L/14's
    # at d 64; ViT-L/14@336px's 577 (ten blocks) stream through seven slots
    assert tbf.attn_k_slots(257, 80) == 5 and tbf.attn_k_slots(257, 64) == 5
    assert tbf.attn_k_slots(577, 64) == 7 < -(-577 // 64)
    assert tbf.attn_k_slots(50, 80) == 1
    # the resident limits: T 320 at d 80, T 448 at d 64
    assert tbf.attn_k_slots(320, 80) == 5 and tbf.attn_k_slots(321, 80) == 5
    assert tbf.attn_k_slots(448, 64) == 7 and tbf.attn_k_slots(449, 64) == 7
    assert tbf.attn_smem_bytes(80, 5) == 1024 + 11 * 64 * 80 * 2 + 8 * 19
    assert not tbf.attn_takes(1, 100, 4, 24) and not tbf.attn_takes(0, 100, 4, 64)
    assert tbf.attn_takes(1, 1, 1, 64) and not tbf.attn_takes(2 ** 16, 2 ** 12, 2 ** 10, 80)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_head_dim_16_raises_before_any_library_loads(monkeypatch):
    def no_load(name):
        raise RuntimeError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)
    # head dim 16 (the tiny test tower's 4 heads of 16) now passes the
    # mirrors and goes on to its library, K1's core and K6 alike
    tiny = MODEL_REGISTRY["ViT-Tiny-Test"].vision
    assert tbf.attn_takes(2, 17, tiny.heads, 16) and 16 in tattn.HEAD_DIMS
    assert tbf.attn_boxes(16) == [(0, 16, 32)]
    qkv = torch.zeros(2, 17, 3 * tiny.width, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    with pytest.raises(RuntimeError, match="library block_attn loaded"):
        tbf.attn_forward(qkv, tiny.heads)
    q = torch.zeros(2, tiny.heads, 17, tiny.width // tiny.heads, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    with pytest.raises(RuntimeError, match="library flash_attn loaded"):
        tattn.flash_attention_full(q, q, q)
    # head dim 24 raises before any library loads
    qkv = torch.zeros(2, 17, 3 * 96, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    with pytest.raises(ValueError, match="does not take"):
        tbf.attn_forward(qkv, 4)
    q = torch.zeros(2, 4, 17, 24, dtype=torch.bfloat16).as_subclass(_ClaimsCuda)
    with pytest.raises(ValueError, match="head dim 24"):
        tattn.flash_attention_full(q, q, q)
    # head dim 64 in bf16 and fp32 goes on to its library
    for dt in (torch.bfloat16, torch.float32):
        qkv = torch.zeros(2, 17, 3 * 128, dtype=dt).as_subclass(_ClaimsCuda)
        with pytest.raises(RuntimeError, match="library block_attn loaded"):
            tbf.attn_forward(qkv, 2)


class _Lib:
    """Records what ``build._declare`` sets on each entry point."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def _function_body(source: str, signature: str) -> str:
    start = source.index(signature)
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[i:j + 1]
    raise AssertionError(signature)


def test_routes_build_key_and_entry_point(tmp_path, monkeypatch):
    """bf16 reaches the wgmma kernel and fp32 the CUDA-core kernels, by the
    element type alone (no fallback); attn_sm90.cuh and the shared sm90.cuh
    are in the build key of every library that includes them; the ctypes
    declaration of ``evr_flash_forward`` matches its C signature."""
    csrc = build.CSRC
    flash = (csrc / "flash.cuh").read_text()
    fwd = _function_body(flash, "int launch_flash_fwd(")
    bf16_branch, fp32_branch = fwd.split("} else {")
    assert "launch_attn_sm90_packed" in bf16_branch and "flash_fwd_kernel" not in bf16_branch
    assert "launch_flash_fwd_d<T, 64>" in fp32_branch and "launch_attn_sm90" not in fp32_branch
    assert 'std::is_same<T, float>::value, "the bf16 forward runs on attn_sm90.cuh"' in flash
    k6 = _function_body((csrc / "flash_attn.cu").read_text(), 'extern "C" int evr_flash_attention(')
    assert re.search(r"dtype == 1\)\s*return evr::launch_attn_sm90_heads", k6)
    assert "launch<float, 64>" in k6 and "launch<float, 80>" in k6 and "bf16, 64" not in k6
    assert not re.search(r"\btry\b|catch", fwd + k6)  # no fallback
    # the build key
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in csrc.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", copy)
    names = ("block_attn", "block_quant", "block_merged", "flash_attn", "block_attn_bwd")
    for name in names:
        text = (copy / f"{name}.cu").read_text()
        assert '#include "flash.cuh"' in text or '#include "attn_sm90.cuh"' in text, name
    assert '#include "sm90.cuh"' in (copy / "attn_sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in (copy / "gemm_sm90.cuh").read_text()
    for header in ("attn_sm90.cuh", "sm90.cuh"):
        before = {name: build.library_path(name) for name in names}
        (copy / header).write_text((copy / header).read_text() + "\n// edit\n")
        assert all(build.library_path(name) != before[name] for name in names), header
    # the entry point
    lib = _Lib()
    build._declare("block_attn", lib)
    fns = lib.fns
    sig = re.search(r'extern "C" int evr_flash_forward\(([^)]*)\)', (csrc / "block_attn.cu").read_text())
    kinds = ["p" if "*" in q else "f" if q.strip().startswith("float") else "i" for q in sig.group(1).split(",")]
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert [kind[t] for t in fns["evr_flash_forward"].argtypes] == kinds
