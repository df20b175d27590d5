"""The bf16 attention backward of K5a on its Hopper kernels.

``evr_tpu_torch/ops/csrc/attn_bwd_sm90.cuh`` (two warp-specialised TMA +
wgmma kernels: statistics, o and dq per query tile; dk and dv per key tile)
runs K5a's bf16 attention backward, and that of ``ops.block_fused.
attn_backward``, only on the card, where ``chip_smoke.py`` holds it to
``attn_backward_plain``, checks that a call repeats bit for bit and counts
``HGMMA`` in each of its kernel functions. Here the CPU checks what that
rests on:

- the kernels' shape rule (the forward's, ``attn_takes``) and
  shared-memory plan, mirrored by ``attn_bwd_slots``,
  ``attn_bwd_smem_bytes`` and ``attn_bwd_kv_smem_bytes``: every shape K5a is routed at (the registry's
  vision towers of width <= 1280 at T >= 512, which train on the fused route
  under ``"auto_grad"``) and every shape ``chip_smoke.py`` holds the kernels
  to is taken, one block fits on an SM, short key rows stay resident and
  long ones stream;
- a bf16 shape the kernels refuse raises in the wrappers before any library
  loads (no fallback to the CUDA-core kernels), while fp32 goes on to them;
- the routes: bf16 reaches the new kernels and fp32 keeps flash.cuh's, by
  the element type alone; no atomics; the new header is in the build key of
  ``block_attn_bwd``; the ctypes declarations match the C entry points;
- the plain version the card holds the kernels to matches JAX's K5a
  (interpret mode) where a sequence ends one row into a tile.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from evr_tpu.models.layers import init_block
from evr_tpu.ops import block_fused as jbf
from evr_tpu_torch.models import MODEL_REGISTRY
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.layers import FUSED_MAX_WIDTH
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops import build

SMEM_PER_BLOCK = 232448  # the most one block of an H100 may take (227 KB)


def _routed_shapes() -> dict:
    """{tag: [(sequences, T, heads, head dim), ...]} of every attention
    backward K5a runs: each vision tower the fused route trains (width <=
    1280, T >= 512) at one sequence, the training batch 32 and 256, and each
    shape ``chip_smoke.py`` holds the kernels to."""
    out = {}
    for name, cfg in MODEL_REGISTRY.items():
        v = cfg.vision
        T = (v.image_size // v.patch_size) ** 2 + 1
        if v.width <= FUSED_MAX_WIDTH and T >= 512:
            out[name] = [(n, T, v.heads, v.width // v.heads) for n in (1, 32, 256)]
    for tag, s in chip_smoke.ATTN_BWD_SHAPES.items():
        out[f"chip_smoke-{tag}"] = [(s["B"], s["T"], s["H"], s["W"] // s["H"])]
    return out


ROUTED = _routed_shapes()


@pytest.mark.parametrize("tag", list(ROUTED))
def test_the_kernels_take_every_shape_k5a_is_routed_at(tag):
    for seqs, T, heads, d in ROUTED[tag]:
        assert tbf.attn_takes(seqs, T, heads, d), (tag, seqs, T, heads, d)
        slots, resident = tbf.attn_bwd_slots(T, d)
        blocks = -(-T // tbf.ATTN_TILE)
        assert resident == (slots == blocks) and (resident or 2 <= slots < blocks)
        # one block on an SM, under the 227 KB a block may take
        assert tbf.attn_bwd_smem_bytes(d, slots) <= tbf.ATTN_BWD_SMEM_PER_BLOCK == SMEM_PER_BLOCK
        assert tbf.attn_bwd_kv_smem_bytes(d) <= SMEM_PER_BLOCK


def test_plan_keeps_short_key_rows_resident_and_streams_long_ones():
    assert "ViT-L/14@336px" in ROUTED  # the registry tower K5a trains at
    # ViT-L/14@336px's 577 keys (ten blocks) stay resident at d 64; at d 80
    # they stream through nine slots; a row of 1,000 (16 blocks) streams
    assert tbf.attn_bwd_slots(577, 64) == (10, True)
    assert tbf.attn_bwd_slots(577, 80) == (9, False)
    assert tbf.attn_bwd_slots(257, 80) == (5, True)
    assert tbf.attn_bwd_slots(1000, 64) == (12, False)
    # the resident limits: T 768 at d 64, T 576 at d 80
    assert tbf.attn_bwd_slots(768, 64) == (12, True) and tbf.attn_bwd_slots(769, 64) == (12, False)
    assert tbf.attn_bwd_slots(576, 80) == (9, True) and tbf.attn_bwd_slots(1, 64) == (1, True)
    assert tbf.attn_bwd_smem_bytes(80, 9) == 1024 + 22 * 64 * 80 * 2 + 8 * 19
    assert tbf.attn_bwd_kv_smem_bytes(80) == 1024 + 12 * 64 * 80 * 2 + 4 * 768 + 8 * 13


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrappers' CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_a_refused_bf16_shape_raises_before_any_library_loads(monkeypatch):
    def no_load(name):
        raise RuntimeError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", no_load)
    B, T, W, H = 2, 70, 256, 8  # head dim 32: the GEMMs take W 256, the attention kernels do not

    def cuda(*shape, dtype):
        return torch.zeros(*shape, dtype=dtype).as_subclass(_ClaimsCuda)

    with pytest.raises(ValueError, match="does not take"):
        tbf.attn_backward(cuda(B, T, 3 * W, dtype=torch.bfloat16), cuda(B, T, W, dtype=torch.bfloat16), H)
    params = [torch.zeros(W), torch.zeros(W), torch.zeros(W, 3 * W), torch.zeros(3 * W),
              torch.zeros(W, W), torch.zeros(W)]
    for dt, err in ((torch.bfloat16, ValueError), (torch.float32, RuntimeError)):
        x = cuda(B, T, W, dtype=dt)
        with pytest.raises(err, match="does not take" if err is ValueError else "library block_attn_bwd loaded"):
            tbf.fused_attn_block_bwd(x, cuda(B, T, W, dtype=dt),
                                     *[p.to(dt).as_subclass(_ClaimsCuda) for p in params], n_heads=H)
    # head dim 64 in bf16 goes on to its library
    with pytest.raises(RuntimeError, match="library block_attn_bwd loaded"):
        tbf.attn_backward(cuda(B, T, 3 * 128, dtype=torch.bfloat16), cuda(B, T, 128, dtype=torch.bfloat16), 2)


def _function_body(source: str, signature: str) -> str:
    start = source.index(signature)
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[i:j + 1]
    raise AssertionError(signature)


def test_routes_kernels_and_build_key(tmp_path, monkeypatch):
    """bf16 reaches the wgmma kernels and fp32 flash.cuh's CUDA-core kernels,
    by the element type alone; the two kernels hold no atomics and are the
    functions chip_smoke.py counts HGMMA in; attn_bwd_sm90.cuh is in
    block_attn_bwd's build key."""
    csrc = build.CSRC
    flash = (csrc / "flash.cuh").read_text()
    bwd = _function_body(flash, "int flash_backward(")
    bf16_branch, fp32_branch = bwd.split("} else {")
    assert "launch_attn_bwd_sm90" in bf16_branch and "flash_backward_d" not in bf16_branch
    assert "flash_backward_d<T, 64>" in fp32_branch and "attn_bwd" not in fp32_branch
    assert flash.count('std::is_same<T, float>::value, "the bf16 backward runs on attn_bwd_sm90.cuh"') == 3
    assert not re.search(r"\btry\b|catch", bwd)  # no fallback
    header = (csrc / "attn_bwd_sm90.cuh").read_text()
    assert "atomic" not in header.lower().replace("no atomics", "")
    kernels = re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", header)
    assert sorted(kernels) == sorted(chip_smoke.ATTN_BWD_KERNELS)
    assert '#include "attn_bwd_sm90.cuh"' in flash
    assert '#include "flash.cuh"' in (csrc / "block_attn_bwd.cu").read_text()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in csrc.iterdir():
        (copy / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", copy)
    before = build.library_path("block_attn_bwd")
    (copy / "attn_bwd_sm90.cuh").write_text(header + "\n// edit\n")
    assert build.library_path("block_attn_bwd") != before


class _Lib:
    """Records what ``build._declare`` sets on each entry point."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("entry", ["evr_flash_backward", "evr_fused_attn_block_bwd"])
def test_ctypes_declarations_match_the_c_entry_points(entry):
    lib = _Lib()
    build._declare("block_attn_bwd", lib)
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', (build.CSRC / "block_attn_bwd.cu").read_text())
    kinds = ["p" if "*" in q else "f" if q.strip().startswith("float") else "i" for q in sig.group(1).split(",")]
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    assert [kind[t] for t in lib.fns[entry].argtypes] == kinds
    assert lib.fns[entry].restype is ctypes.c_int


def test_plain_attn_backward_matches_jax_k5a_at_a_one_row_tail_tile():
    """T = 65: one row into a second 64-row tile, causal, as K5a's kernels
    tile it; the plain block backward (which holds ``attn_backward_plain``)
    against JAX's Pallas K5a in interpret mode, fp32 at test_torch_block_bwd's
    tolerances (dx 2e-4, gradients 5e-3)."""
    W, H, B, T = 128, 2, 2, 65
    jp = jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(3), W, 12))
    tp = params_from_numpy(jp)
    rng = np.random.default_rng(5)
    x, g = (rng.standard_normal((B, T, W)).astype(np.float32) for _ in range(2))
    ref = jbf.fused_attn_block_bwd(jnp.asarray(x), jnp.asarray(g), *tbf.block_half_params(jp)[0],
                                   n_heads=H, causal=True, interpret=True)
    got = tbf.fused_attn_block_bwd(torch.from_numpy(x), torch.from_numpy(g), *tbf.block_half_params(tp)[0],
                                   n_heads=H, causal=True)
    for i, (u, r) in enumerate(zip(got, ref)):
        err = np.abs(u.numpy() - np.asarray(r)).max()
        assert err <= (2e-4 if i == 0 else 5e-3), (i, err)
