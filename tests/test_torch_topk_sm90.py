"""K4 redesigned for Hopper (``evr_tpu_torch/ops/csrc/topk_fused.cu``): what
the CPU can check of it.

The kernel runs only on the card, where ``chip_smoke.py`` holds it to
``fused_topk_plain`` (rows equal, scores bit-equal). Here:

- ``topk_plan``, the Python mirror of the kernel's plan (blocks of whole
  1,024-row tiles, about one an SM; queries a pass; list capacity; ring
  stages; shared memory), over N in {1, 1,023, 1,024, 1,025, 1,048,576}
  and k in {1, 30, 300, 1,024}, and the candidate shape [Q, n_blocks, kc]
  the wrapper allocates from it;
- the kernel's exact int8 → fp32 conversion (the same bit arithmetic in
  torch) over all 256 values;
- the kernel's first stage emulated per block (each block's scored rows by
  key, then its rows outside [start, end) lowest first, then (-inf, -1)),
  merged, against ``fused_topk_plain`` and against JAX's ``fused_topk`` in
  interpret mode, for k > end − start, a block of tied rows straddling the
  1,024-row boundary, and N under one tile (JAX needs N a multiple of its
  ``tile_n``: its index is padded and the pad masked through ``end``);
- the ctypes signatures against the C entry points, and the checks the
  wrapper makes before a launch.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops.retrieval_pallas import fused_topk as jfused_topk
from evr_tpu_torch.ops import build, retrieval

SCORE_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "int8": 1e-3}
TILE = retrieval.TILE_ROWS


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 1 << 20])
def test_plan_blocks_tiles_and_candidates(n):
    """Whole tiles a block, ceil(n_tiles / 132) of them (one for k above a
    tile), so every block but the last holds at least kc rows; one block
    for N under 132 tiles' worth at k > 1,024 per tile."""
    n_tiles = -(-n // TILE)
    for k in (1, 30, 300, 1024):
        if k > n:
            assert retrieval.topk_plan(n, 512, 1, k) is None
            continue
        for nq, qc in ((1, 1), (3, 4), (5, 8), (32, 8)):
            plan = retrieval.topk_plan(n, 512, nq, k)
            tpb = -(-n_tiles // 132)
            assert plan.tiles_per_block == tpb and plan.n_blocks == -(-n_tiles // tpb)
            # 8 queries' lists of kc 1,024 leave the ring short of 8 stages: 4 a pass
            assert plan.queries_per_pass == (4 if qc == 8 and k == 1024 else qc) and plan.kc == min(k, TILE)
            assert plan.n_blocks <= 132 and (plan.n_blocks - 1) * tpb * TILE < n
            if plan.n_blocks > 1:  # every block but the last holds kc rows or more
                assert tpb * TILE >= plan.kc
    if n == 1 << 20:
        assert retrieval.topk_plan(n, 512, 1, 30)[:2] == (128, 8)
    if n >= 1025:  # k above a tile: one tile a block
        plan = retrieval.topk_plan(n, 512, 1, 1025)
        assert plan.tiles_per_block == 1 and plan.n_blocks == n_tiles and plan.kc == TILE


def test_plan_shared_memory():
    """Ring stages of 32 rows x 512 bytes take what the lists, buffers and
    queries leave of a block's 227 KB, up to 12 and never fewer than the 8
    consumer warps (a pass takes fewer queries instead); a list's capacity
    is a power of two with room for kc keys and a round of 256 candidates,
    cut from 2,048 only while the ring is short of 12 stages."""
    assert retrieval.topk_plan(1 << 20, 512, 1, 30)[2:] == (1, 30, 2048, 12, 216288)
    assert retrieval.topk_plan(1 << 20, 512, 32, 300)[2:] == (8, 300, 1024, 9, 230576)
    for d in (16, 512, 2048):
        for nq in (1, 4, 32):
            for k in (1, 30, 300, 1024, 1025):
                plan = retrieval.topk_plan(1 << 20, d, nq, k)
                assert retrieval.CONSUMER_WARPS <= plan.stages <= retrieval.MAX_STAGES
                assert plan.smem_bytes <= retrieval.SMEM_LIMIT
                assert plan.cap & (plan.cap - 1) == 0 and plan.cap >= plan.kc + retrieval.ROUND_ROWS
                assert plan.smem_bytes == (1024 + plan.stages * (retrieval.STAGE_BYTES + 16)
                                           + plan.queries_per_pass * (plan.cap * 8 + d * 4) + 32)
                if plan.cap < retrieval.MAX_CAP:  # cut only for ring stages
                    bigger = plan._replace(cap=2 * plan.cap)
                    assert retrieval._smem_bytes(plan.queries_per_pass, d, bigger.cap, retrieval.MAX_STAGES) > \
                        retrieval.SMEM_LIMIT
    # the widest case: 8 queries of 2,048 with kc 1,024 would leave 2 stages,
    # so a pass takes 4 queries, with 8 stages
    assert retrieval.topk_plan(1 << 20, 2048, 32, 1024)[2:6] == (4, 1024, 2048, 8)
    assert retrieval._smem_bytes(8, 2048, 2048, 8) > retrieval.SMEM_LIMIT
    for bad in ((0, 512, 1, 1), (100, 24, 1, 1), (100, 2064, 1, 1), (100, 512, 0, 1), (100, 512, 1, 101)):
        assert retrieval.topk_plan(*bad) is None


def _int8_as_f32_bits(b: torch.Tensor) -> torch.Tensor:
    """The kernel's int8 → fp32 conversion in torch: the byte biased by 128
    (b XOR 0x80) as the low byte of the fp32 bits 0x4B0000xx (2²³ + b +
    128), minus 2²³ + 128."""
    u = (b.to(torch.int32) & 0xFF) ^ 0x80
    return (u | 0x4B000000).view(torch.float32) - 8388736.0


def test_int8_conversion_is_exact_for_every_byte():
    b = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = _int8_as_f32_bits(b)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), b.float().view(torch.int32))


def _scores(index, q, scales):
    """The plain version's scores, in its order of summation."""
    qp = retrieval.prepared_queries(q, index.dtype)
    rows = index.float()
    s = torch.zeros((qp.shape[0], index.shape[0]))
    for j in range(index.shape[1]):
        s = s + qp[:, j:j + 1] * rows[:, j][None, :]
    return s * scales[None, :] if scales is not None else s


def _blockwise(index, q, start, end, k, scales, tiles_per_block):
    """The kernel's first stage, emulated: each block of ``tiles_per_block``
    tiles keeps its scored rows' best min(kc, rows) by (score descending,
    row ascending), then its rows outside [start, end) at -inf lowest first,
    then (-inf, -1) up to kc; the blocks' lists merged as the wrapper does."""
    n = index.shape[0]
    s = _scores(index, q, scales) + 0.0
    kc, span = min(k, TILE), tiles_per_block * TILE
    cand_s, cand_r = [], []
    for b0 in range(0, n, span):
        b1 = min(b0 + span, n)
        lo, hi = min(max(start, b0), b1), max(min(end, b1), min(max(start, b0), b1))
        vals, pos = torch.sort(s[:, lo:hi], dim=1, descending=True, stable=True)
        rows = pos + lo
        masked = torch.tensor(list(range(b0, lo)) + list(range(hi, b1)), dtype=torch.int64)
        pad = kc - min(kc, hi - lo)
        fill_r = torch.full((pad,), -1, dtype=torch.int64)
        fill_r[:min(pad, len(masked))] = masked[:pad]
        cand_s.append(torch.cat([vals[:, :kc], torch.full((s.shape[0], pad), -torch.inf)], 1))
        cand_r.append(torch.cat([rows[:, :kc], fill_r.expand(s.shape[0], pad)], 1))
    return retrieval._merge(torch.stack(cand_s, 1), torch.stack(cand_r, 1), k)


def _data(n, d, dtype, seed, tied=None):
    rng = np.random.default_rng(seed)
    idx = rng.normal(size=(n, d)).astype(np.float32)
    if tied is not None:
        idx[tied[0]:tied[1]] = idx[tied[0]]
    idx /= np.linalg.norm(idx, axis=1, keepdims=True)
    q = rng.normal(size=(3, d)).astype(np.float32)
    if tied is not None:
        q[1] = idx[tied[0]] * 2.0
    if dtype == "int8":
        scales = (np.abs(idx).max(axis=1) / 127.0).astype(np.float32)
        return np.clip(np.round(idx / scales[:, None]), -127, 127).astype(np.int8), q, scales
    return idx, q, None


def _against_jax_and_blocks(idx, q, scales, dtype, start, end, k):
    """fused_topk on CPU tensors (the plain version) against the per-block
    emulation at one and two tiles a block (rows and scores equal) and
    against JAX's Pallas kernel in interpret mode on the index padded to a
    whole tile (rows equal, scores within SCORE_TOL). Past end − start
    both sides score -inf, but JAX's rounds of first-argmax take the tile's
    first row again each time (a taken row becomes -inf, and so equal to the
    rest), while the port gives distinct rows, lowest first: there only the
    scores are compared (``FrameIndex`` clamps k to the range, so no search
    asks for that tail)."""
    n = idx.shape[0]
    tidx = torch.from_numpy(idx)
    if dtype == "bfloat16":
        tidx = tidx.bfloat16()
    tsc = None if scales is None else torch.from_numpy(scales)
    got_s, got_r = retrieval.fused_topk(tidx, torch.from_numpy(q), start, end, k, tsc)
    for tpb in (1, 2):
        emu_s, emu_r = _blockwise(tidx, torch.from_numpy(q), start, end, k, tsc, tpb)
        assert torch.equal(emu_r, got_r) and torch.equal(emu_s, got_s), tpb
    pad = -(-n // TILE) * TILE - n
    jidx = np.pad(idx, ((0, pad), (0, 0)))
    jsc = None if scales is None else jnp.asarray(np.pad(scales, (0, pad), constant_values=1.0))
    jx = jnp.asarray(jidx).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(jidx)
    ref_s, ref_r = jfused_topk(jx, jnp.asarray(q), jnp.int32(start), jnp.int32(end), k,
                               row_scales=jsc, tile_n=TILE, interpret=True)
    m = min(k, end - start)
    np.testing.assert_array_equal(got_r[:, :m].numpy(), np.asarray(ref_r)[:, :m])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=SCORE_TOL[dtype], rtol=0)
    return got_s, got_r


def test_k_above_the_row_range_fills_with_the_lowest_masked_rows():
    """k = 25 over a range of 10 rows inside the second tile, int8 and fp32
    rows: the ten, then 15 rows at -inf, lowest rows first (rows 0..14, in
    the first tile)."""
    for dtype in ("int8", "float32"):
        idx, q, scales = _data(2100, 64, dtype, 1)
        got_s, got_r = _against_jax_and_blocks(idx, q, scales, dtype, 1500, 1510, 25)
        assert (got_r[:, :10] >= 1500).all() and (got_r[:, :10] < 1510).all()
        assert torch.equal(got_r[:, 10:], torch.arange(15).expand(3, 15))
        assert torch.isinf(got_s[:, 10:]).all() and torch.isfinite(got_s[:, :10]).all()


def test_tied_rows_across_the_tile_boundary_come_lowest_first():
    """Rows 1,000..1,059 identical and a query on them, bf16 rows, k 50:
    rows 1,000..1,049 in order, across the two tiles (and blocks)."""
    idx, q, _ = _data(2048, 64, "bfloat16", 2, tied=(1000, 1060))
    _, got_r = _against_jax_and_blocks(idx, q, None, "bfloat16", 0, 2048, 50)
    assert torch.equal(got_r[1], torch.arange(1000, 1050))


def test_an_index_under_one_tile():
    """N = 700 (one ragged tile, one block), int8 rows, the range cut on
    both sides, k up to the range and past it."""
    idx, q, scales = _data(700, 64, "int8", 3)
    for k in (1, 30, 200):
        got_s, got_r = _against_jax_and_blocks(idx, q, scales, "int8", 17, 617, k)
        assert got_r.shape == (3, k) and (got_r >= 0).all()


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: the wrapper's CUDA-side checks
    without a card."""

    @property
    def is_cuda(self):
        return True


def test_ctypes_signatures_match_the_c_entry_points():
    src = (build.CSRC / "topk_fused.cu").read_text()

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("Fn", (), {})())

    lib = Lib()
    build._declare("topk_fused", lib)
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i"}
    for entry in ("evr_fused_topk", "evr_fused_topk_scan", "evr_topk_plan"):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        kinds = ["p" if "*" in a else "i" for a in sig.group(1).split(",")]
        assert [kind[t] for t in lib.fns[entry].argtypes] == kinds, entry
        assert lib.fns[entry].restype is ctypes.c_int
    # the C plan holds the constants the mirror holds
    for name, value in (("kTile", retrieval.TILE_ROWS), ("kGroup", retrieval.GROUP_ROWS),
                        ("kSlice", retrieval.SLICE_BYTES), ("kWarps", retrieval.CONSUMER_WARPS),
                        ("kMaxStages", retrieval.MAX_STAGES), ("kMaxCap", retrieval.MAX_CAP),
                        ("kTargetBlocks", retrieval.TARGET_BLOCKS), ("kSmemLimit", retrieval.SMEM_LIMIT)):
        assert re.search(rf"constexpr [\w ]+ {name} = {value};", src), name


def test_checks_before_launch_and_the_candidates_allocated(monkeypatch):
    """On a (claimed) CUDA index: a bad k, range, width or alignment raises
    before any library loads; a good call allocates [Q, n_blocks, kc]
    candidates from the plan, passes k (not kc) to the entry point, and
    counts one launch; the scan-only entry counts none."""
    calls = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    class Lib:
        evr_fused_topk = Entry("evr_fused_topk")
        evr_fused_topk_scan = Entry("evr_fused_topk_scan")

    def load(name):
        assert name == "topk_fused"
        return Lib

    monkeypatch.setattr(build, "load", load)
    n, d = 2500, 64
    index = torch.zeros(n, d, dtype=torch.int8).as_subclass(_ClaimsCuda)
    q = torch.ones(3, d).as_subclass(_ClaimsCuda)
    scales = torch.ones(n).as_subclass(_ClaimsCuda)
    for args, match in (((0, n, 0), "k=0"), ((10, n + 1, 5), "row range"), ((0, n, n + 1), "k=2501")):
        with pytest.raises(ValueError, match=match):
            retrieval.topk_candidates(index, q, *args, scales)
    with pytest.raises(ValueError, match="16-byte"):
        off = torch.zeros(n * d + 8, dtype=torch.int8)[8:].view(n, d).as_subclass(_ClaimsCuda)
        retrieval.topk_candidates(off, q, 0, n, 5, scales)
    with pytest.raises(ValueError, match="width 24"):
        retrieval.topk_candidates(torch.zeros(n, 24, dtype=torch.int8).as_subclass(_ClaimsCuda),
                                  q[:, :24], 0, n, 5, scales)
    assert not calls
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0})())
    before = retrieval.fused_topk.launches
    cs, cr = retrieval.topk_candidates(index, q, 3, 2400, 300, scales)
    plan = retrieval.topk_plan(n, d, 3, 300)
    assert cs.shape == cr.shape == (3, plan.n_blocks, 300) and cs.dtype == torch.float32 and cr.dtype == torch.int32
    name, args = calls[-1]
    assert name == "evr_fused_topk" and args[0] == 2 and args[4:10] == (n, d, 3, 3, 2400, 300)
    assert retrieval.fused_topk.launches == before + 1
    retrieval.topk_candidates(index, q, 3, 2400, 300, scales, scan_only=True)
    assert calls[-1][0] == "evr_fused_topk_scan" and retrieval.fused_topk.launches == before + 1
