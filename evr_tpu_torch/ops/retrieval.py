"""Fused streaming score + top-k retrieval: hand-written CUDA kernel K4.

Counterpart of ``evr_tpu/ops/retrieval_pallas.py`` (``fused_topk``). The
kernel (``csrc/topk_fused.cu``) streams the index in tiles of ``TILE_ROWS``
rows, scores each tile against every query and keeps the tile's top
min(k, rows in the tile) candidates on chip; only those candidates reach
device memory, and an exact merge over them (the stable-sort
``ops.topk._ordered_topk``, as the JAX package merges with ``lax.top_k``
outside its kernel) gives the global top-k. Every global top-k row is in its
own tile's top-k, so the two stages are exact.

Scores: the queries are normalised in fp32 and, for an int8 or bf16 index,
rounded to bf16; each score is an fp32 sum over the embedding dimension in
order, one product and one rounded sum per element (for bf16 and int8 rows
the product is exact in fp32), then multiplied by the row's dequantisation
scale. Rows outside ``[start, end)`` score −inf. Ties go to the lower row,
in the tiles and in the merge, as ``lax.top_k`` and ``cosine_topk`` do.

A CUDA index launches the kernel (or raises); a CPU index takes
``fused_topk_plain``, which computes the same scores in the same order and
the same two stages. Every launch adds one to ``fused_topk.launches``.
"""

from __future__ import annotations

import torch

from . import build
from .block_fused import refuse_grad
from .topk import _ordered_topk

TILE_ROWS = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def prepared_queries(queries: torch.Tensor, index_dtype: torch.dtype) -> torch.Tensor:
    """[Q, D] queries as the kernel reads them: unit rows in fp32, rounded to
    bf16 for an int8 or bf16 index, held as fp32 values."""
    q = queries.float()
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if index_dtype != torch.float32:
        q = q.to(torch.bfloat16).float()
    return q.contiguous()


def _merge(cand_scores: torch.Tensor, cand_rows: torch.Tensor, k: int):
    """Exact merge of per-tile candidates [Q, n_tiles, kc], tiles in row
    order and each lower rows first on ties: a stable sort keeps that."""
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
    first-argmax), then the merge."""
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
    kernel masks the ragged last tile itself."""
    refuse_grad("fused_topk", index, queries, row_scales)
    if not index.is_cuda:
        return fused_topk_plain(index, queries, start, end, k, row_scales)
    _check_args(index, k, start, end, row_scales)
    _check_kernel_inputs(index, queries, row_scales)
    n, d = index.shape
    q = prepared_queries(queries, index.dtype)
    nq = q.shape[0]
    n_tiles = -(-n // TILE_ROWS)
    kc = min(k, TILE_ROWS)
    cand_scores = torch.empty((nq, n_tiles, kc), dtype=torch.float32, device=index.device)
    cand_rows = torch.empty((nq, n_tiles, kc), dtype=torch.int32, device=index.device)
    lib = build.load("topk_fused")
    rc = lib.evr_fused_topk(
        _DTYPE_CODES[index.dtype], index.data_ptr(), q.data_ptr(),
        None if row_scales is None else row_scales.data_ptr(),
        n, d, nq, start, end, kc, cand_scores.data_ptr(), cand_rows.data_ptr(),
        torch.cuda.current_stream(index.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_topk: CUDA launch failed with error code {rc}")
    fused_topk.launches += 1
    return _merge(cand_scores, cand_rows, k)


fused_topk.launches = 0
