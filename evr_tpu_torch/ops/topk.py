"""Cosine top-k retrieval as one GEMM plus an ordered top-k.

Counterpart of ``evr_tpu/ops/topk.py``, plain PyTorch as the reference path
is plain XLA. Rows outside ``[start, end)`` are masked to −inf: padding rows
never win, and a per-video search is the video's row interval.

Equal scores return the lower row first, as ``lax.top_k`` does: the top k
come from a stable descending sort, since ``torch.topk`` promises no order
among ties.

A bf16 or int8 index is scored ``CHUNK_ROWS`` rows at a time, so the fp32
copy of the rows that the products read stays bounded whatever the index
size; each chunk's top k are merged, lower rows first on ties.
"""

from __future__ import annotations

import torch

CHUNK_ROWS = 65536


def _ordered_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_topk(
    index: torch.Tensor,  # [N_padded, D], L2-normalised rows (float or int8)
    queries: torch.Tensor,  # [Q, D], unnormalised
    start: int,  # first valid row
    end: int,  # one past the last valid row
    k: int,
    row_scales: torch.Tensor | None = None,  # [N_padded] dequant scales (int8)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32, indices [Q, k] int64) of the top-k rows in
    ``[start, end)``. An int8 index is scored in bf16 operands with fp32
    accumulation and its per-row scale applied after the GEMM; a bf16 index
    in bf16 operands; fp32 in fp32."""
    q = queries.float()
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if index.dtype == torch.float32:
        return _ordered_topk(_masked(q @ index.T, 0, start, end), k)
    # bf16 operands, fp32 products and sums: the bf16 (and int8) values are
    # exact in fp32, so multiply them there
    q = q.to(torch.bfloat16).float()
    scores, rows = [], []
    for lo in range(0, index.shape[0], CHUNK_ROWS):
        chunk = index[lo:lo + CHUNK_ROWS]
        sims = q @ chunk.float().T
        if row_scales is not None:
            sims = sims * row_scales[None, lo:lo + chunk.shape[0]]
        s, i = _ordered_topk(_masked(sims, lo, start, end), min(k, chunk.shape[0]))
        scores.append(s)
        rows.append(i + lo)
    # chunks in row order, each lower rows first: a stable sort keeps that
    best, pos = _ordered_topk(torch.cat(scores, dim=1), k)
    return best, torch.gather(torch.cat(rows, dim=1), 1, pos)


def _masked(sims: torch.Tensor, lo: int, start: int, end: int) -> torch.Tensor:
    """Scores of rows ``lo ..`` with rows outside ``[start, end)`` at −inf."""
    rows = torch.arange(lo, lo + sims.shape[1], device=sims.device)[None, :]
    return torch.where((rows >= start) & (rows < end), sims, -torch.inf)


def merge_topk(
    scores: torch.Tensor,  # [S, Q, k] per-shard scores
    indices: torch.Tensor,  # [S, Q, k] per-shard global indices
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists into the global top-k. Exact: the global
    top-k is a subset of the union of the per-shard top-ks."""
    S, Q, kk = scores.shape
    flat_scores = scores.permute(1, 0, 2).reshape(Q, S * kk)
    flat_idx = indices.permute(1, 0, 2).reshape(Q, S * kk)
    best, pos = _ordered_topk(flat_scores, k)
    return best, torch.gather(flat_idx, 1, pos)
