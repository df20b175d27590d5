"""Fused streaming score + top-k retrieval: hand-written CUDA kernel K4.

Counterpart of ``evr_tpu/ops/retrieval_pallas.py`` (``fused_topk``). The
kernel (``csrc/topk_fused.cu``) runs a persistent grid of about one block
per SM; each block streams its run of ``TILE_ROWS``-row tiles by TMA,
scores the rows against every query and keeps its top kc = min(k,
``TILE_ROWS``) candidates on chip; only those candidates reach device
memory, and an exact merge over them (the stable-sort
``ops.topk._ordered_topk``, as the JAX package merges with ``lax.top_k``
outside its kernel) gives the global top-k. Every global top-k row is in its
own block's top kc, so the two stages are exact. ``topk_plan`` mirrors the
kernel's plan (blocks, tiles a block, queries a pass, list capacity, ring
stages, shared memory); the candidates are [Q, n_blocks, kc].

Scores: the queries are normalised in fp32 and, for an int8 or bf16 index,
rounded to bf16; each score is an fp32 sum over the embedding dimension in
order, one product and one rounded sum per element (for bf16 and int8 rows
the product is exact in fp32), then multiplied by the row's dequantisation
scale. Rows outside ``[start, end)`` score −inf. Ties go to the lower row,
in the tiles and in the merge, as ``lax.top_k`` and ``cosine_topk`` do.

A CUDA index launches the kernel (or raises); a CPU index takes
``fused_topk_plain``, which computes the same scores in the same order and
an exact two-stage top-k (per tile, where the kernel's first stage is per
block: the same result, since both stages are exact). Every launch adds one
to ``fused_topk.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .block_fused import refuse_grad
from .topk import _ordered_topk

TILE_ROWS = 1024  # rows of a plan tile: a block walks whole tiles
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# csrc/topk_fused.cu's plan constants
GROUP_ROWS = 32  # rows of a ring stage: one a lane of a consumer warp
SLICE_BYTES = 512  # bytes of each row a stage holds
STAGE_BYTES = GROUP_ROWS * SLICE_BYTES
CONSUMER_WARPS = 8
ROUND_ROWS = CONSUMER_WARPS * GROUP_ROWS  # rows scored between two selection steps
MAX_STAGES = 12
MAX_CAP = 2048  # keys of a query's list and buffer, at most
TARGET_BLOCKS = 132  # one block on each SM of an H100
SMEM_LIMIT = 232448  # the most one block may take (227 KB)


class TopkPlan(NamedTuple):
    n_blocks: int
    tiles_per_block: int
    queries_per_pass: int
    kc: int  # keys each block keeps for each query
    cap: int  # keys of a query's list and buffer in shared memory
    stages: int  # ring stages of GROUP_ROWS x SLICE_BYTES
    smem_bytes: int


def _smem_bytes(qc: int, d: int, cap: int, stages: int) -> int:
    """The 1,024-byte alignment slack, the ring stages and their two
    mbarriers, the lists and buffers (8-byte keys), the buffer counts (8
    ints) and the queries ([d][qc] floats)."""
    return 1024 + stages * (STAGE_BYTES + 16) + qc * cap * 8 + 32 + qc * d * 4


def _stages(qc: int, d: int, cap: int) -> int:
    """Ring stages what the rest leaves of a block's shared memory holds, up
    to ``MAX_STAGES``."""
    return max(0, min(MAX_STAGES, (SMEM_LIMIT - _smem_bytes(qc, d, cap, 0)) // (STAGE_BYTES + 16)))


def topk_plan(n: int, d: int, n_queries: int, k: int) -> TopkPlan | None:
    """The kernel's plan for n rows of d elements, ``n_queries`` queries and
    top k (``csrc/topk_fused.cu``'s ``make_plan``, which ``evr_topk_plan``
    exports), or None for a shape it does not take. Blocks walk
    ceil(n_tiles / 132) tiles each (one tile for k > ``TILE_ROWS``, so that
    a block's list of kc = ``TILE_ROWS`` keys holds all its rows); queries go
    1, 4 or 8 a pass; each query's list and buffer hold ``cap`` keys, cut
    from 2,048 by halves while the buffer keeps room for a round and the
    ring is short of ``MAX_STAGES`` stages, which take what shared memory is
    left. The ring needs a stage for each of the ``CONSUMER_WARPS`` warps,
    which score in step; where 8 (4) queries' lists and queries leave fewer,
    a pass takes 4 (1)."""
    if n < 1 or d < 16 or d % 16 or d > 2048 or n_queries < 1 or not 1 <= k <= n:
        return None
    kc = min(k, TILE_ROWS)
    n_tiles = -(-n // TILE_ROWS)
    tpb = 1 if k > TILE_ROWS else -(-n_tiles // TARGET_BLOCKS)
    qc = 1 if n_queries == 1 else 4 if n_queries <= 4 else 8
    while True:
        cap = MAX_CAP
        while cap // 2 >= kc + ROUND_ROWS and _stages(qc, d, cap) < MAX_STAGES:
            cap //= 2
        stages = _stages(qc, d, cap)
        if stages >= CONSUMER_WARPS or qc == 1:
            break
        qc = 4 if qc == 8 else 1
    if stages < CONSUMER_WARPS:
        return None
    return TopkPlan(-(-n_tiles // tpb), tpb, qc, kc, cap, stages, _smem_bytes(qc, d, cap, stages))


def prepared_queries(queries: torch.Tensor, index_dtype: torch.dtype) -> torch.Tensor:
    """[Q, D] queries as the kernel reads them: unit rows in fp32, rounded to
    bf16 for an int8 or bf16 index, held as fp32 values."""
    q = queries.float()
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if index_dtype != torch.float32:
        q = q.to(torch.bfloat16).float()
    return q.contiguous()


def _merge(cand_scores: torch.Tensor, cand_rows: torch.Tensor, k: int):
    """Exact merge of per-block (or per-tile) candidates [Q, n, kc], blocks
    in row order and each lower rows first on ties: a stable sort keeps
    that."""
    Q = cand_scores.shape[0]
    best, pos = _ordered_topk(cand_scores.reshape(Q, -1), k)
    return best, torch.gather(cand_rows.reshape(Q, -1), 1, pos).long()


def _check_args(index, k, start, end, row_scales):
    if index.dim() != 2 or index.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"fused_topk: index of shape {tuple(index.shape)} and dtype {index.dtype}"
        )
    n = index.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"fused_topk: k={k} outside 1..{n}")
    if not 0 <= start <= end <= n:
        raise ValueError(f"fused_topk: row range [{start}, {end}) outside 0..{n}")
    if row_scales is not None and tuple(row_scales.shape) != (n,):
        raise ValueError(f"fused_topk: row_scales of shape {tuple(row_scales.shape)}")


def _check_kernel_inputs(index, queries, row_scales) -> None:
    """What the kernel reads through raw pointers: the index's layout and
    width, the queries' shape and device, the scales' dtype, device and
    layout."""
    n, d = index.shape
    if not index.is_contiguous():
        raise ValueError("fused_topk: index must be contiguous")
    if d % 16 or d > 2048:
        raise ValueError(f"fused_topk: embedding width {d} (the kernel takes multiples of 16 up to 2048)")
    if index.data_ptr() % 16:
        raise ValueError("fused_topk: index must start on a 16-byte boundary (TMA)")
    if queries.dim() != 2 or queries.shape[1] != d or queries.device != index.device:
        raise ValueError(
            f"fused_topk: queries of shape {tuple(queries.shape)} on {queries.device}, "
            f"index [{n}, {d}] on {index.device}"
        )
    if row_scales is not None and (
        row_scales.device != index.device
        or row_scales.dtype != torch.float32
        or not row_scales.is_contiguous()
    ):
        raise ValueError("fused_topk: row_scales must be contiguous fp32 on the index's device")


def fused_topk_plain(
    index: torch.Tensor,  # [N, D] fp32/bf16/int8, L2-normalised rows
    queries: torch.Tensor,  # [Q, D], unnormalised
    start: int,
    end: int,
    k: int,
    row_scales: torch.Tensor | None = None,  # [N] fp32 (int8 dequant)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's function in plain PyTorch: the kernel's scores in its order of
    summation, each tile's top min(k, rows) by stable order (k rounds of
    first-argmax), then the merge. The kernel's first stage is per block of
    ``topk_plan``'s tiles, not per tile; both first stages keep every row of
    the global top-k, so the results are the same."""
    _check_args(index, k, start, end, row_scales)
    q = prepared_queries(queries, index.dtype)
    n, d = index.shape
    rows_t = index.float().T.contiguous()  # [D, N]
    s = torch.zeros((q.shape[0], n), dtype=torch.float32, device=index.device)
    for j in range(d):  # one product, one rounded sum per element, in order
        s = s + q[:, j : j + 1] * rows_t[j][None, :]
    if row_scales is not None:
        s = s * row_scales.float()[None, :]
    row = torch.arange(n, device=index.device)
    s = torch.where((row >= start) & (row < end), s, -torch.inf)

    n_tiles = -(-n // TILE_ROWS)
    kc = min(k, TILE_ROWS)
    pad = n_tiles * TILE_ROWS - n  # absent rows of the last tile sort last
    s = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
    vals, pos = torch.sort(
        s.reshape(q.shape[0], n_tiles, TILE_ROWS), dim=-1, descending=True, stable=True
    )
    tile0 = torch.arange(n_tiles, device=index.device)[None, :, None] * TILE_ROWS
    return _merge(vals[..., :kc], pos[..., :kc] + tile0, k)


def fused_topk(
    index: torch.Tensor,  # [N, D] fp32/bf16/int8, L2-normalised rows
    queries: torch.Tensor,  # [Q, D], unnormalised
    start: int,  # first valid row
    end: int,  # one past the last valid row
    k: int,
    row_scales: torch.Tensor | None = None,  # [N] fp32 dequant scales (int8)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32, rows [Q, k] int64) of the top-k rows in
    ``[start, end)``, kernel K4 on a CUDA index. Any row count is taken: the
    kernel masks the ragged last tile itself, and reads no row outside
    ``[start, end)``."""
    refuse_grad("fused_topk", index, queries, row_scales)
    if not index.is_cuda:
        return fused_topk_plain(index, queries, start, end, k, row_scales)
    q = prepared_queries(queries, index.dtype)
    return _merge(*topk_candidates(index, q, start, end, k, row_scales), k)


def topk_candidates(
    index: torch.Tensor, q: torch.Tensor, start: int, end: int, k: int,
    row_scales: torch.Tensor | None = None, scan_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch alone on prepared queries ``q``
    (``prepared_queries``): the blocks' candidates (scores [Q, n_blocks, kc]
    float32, rows int32), which ``_merge`` turns into the top k. With
    ``scan_only`` the same walk without the selection
    (``evr_fused_topk_scan``: each block's best key a query in slot 0), for
    timing the scan apart from it; that launch is not counted, and no path
    makes it."""
    _check_args(index, k, start, end, row_scales)
    _check_kernel_inputs(index, q, row_scales)
    n, d = index.shape
    nq = q.shape[0]
    plan = topk_plan(n, d, nq, k)
    shape = (nq, plan.n_blocks, plan.kc)
    cand_scores = torch.empty(shape, dtype=torch.float32, device=index.device)
    cand_rows = torch.empty(shape, dtype=torch.int32, device=index.device)
    lib = build.load("topk_fused")
    entry = lib.evr_fused_topk_scan if scan_only else lib.evr_fused_topk
    rc = entry(
        _DTYPE_CODES[index.dtype], index.data_ptr(), q.data_ptr(),
        None if row_scales is None else row_scales.data_ptr(),
        n, d, nq, start, end, k, cand_scores.data_ptr(), cand_rows.data_ptr(),
        torch.cuda.current_stream(index.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_topk: CUDA launch failed with error code {rc}")
    if not scan_only:
        fused_topk.launches += 1
    return cand_scores, cand_rows


fused_topk.launches = 0
