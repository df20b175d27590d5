"""Exact cosine top-k over a row-sharded frame index (PyTorch).

Counterpart of ``evr_tpu/parallel/sharded_search.py``. The (N, D) index is
split by rows over a mesh axis, one shard a slot; each slot scores its shard
and keeps its top k, and only those k-sized lists are gathered and merged
(``ops.topk.merge_topk``), so what crosses slots is O(Q·k·slots) whatever N.

Each slot clips the global ``[start, end)`` into its own rows. Its top k
comes from one of:

- ``impl="xla"``: ``ops.topk.cosine_topk`` on the shard, the one-device
  exact search (fp32 one GEMM; bf16 operands; int8 rows in bf16 operands
  with the per-row scales applied after the GEMM);
- ``impl="pallas"``: the fused kernel K4 (``ops.retrieval.fused_topk``) on
  each slot, where ``ops.retrieval.topk_plan`` takes the shard's shape; the
  route is decided by shape before any launch (as the JAX package falls back
  to XLA when a shard's rows do not tile), and a kernel that fails raises.

A shard whose clipped range holds fewer than k rows fills its list with −inf
scores; such entries never win the merge while the whole range holds k rows
(``FrameIndex`` clamps k to it). Among equal scores the lower global row
comes first. Across processes the lists are gathered in rank order
(``parallel.multihost``).
"""

from __future__ import annotations

import torch

from evr_tpu_torch.ops.retrieval import fused_topk, topk_plan
from evr_tpu_torch.ops.topk import cosine_topk, merge_topk

from . import multihost
from .mesh import Mesh


def place_rows(mesh: Mesh, x: torch.Tensor | None, axis: str = "data") -> list | None:
    """``x`` [N, ...] split into equal row shards over ``axis``: this
    process's shards, each on its group leader's device (``Mesh.leaders``),
    in order along the axis. N must divide by the axis's slot count."""
    if x is None:
        return None
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
    per = x.shape[0] // n
    devices = mesh.slot_devices
    return [x[j * per:(j + 1) * per].to(devices[s]).contiguous()
            for s in mesh.leaders(axis) for j in [mesh.axis_index(s, axis)]]


def shard_route(impl: str, rows_per_shard: int, d: int, n_queries: int, k: int) -> str:
    """"pallas" where K4's plan takes a shard (``topk_plan``), else "xla"."""
    if impl == "pallas" and topk_plan(rows_per_shard, d, n_queries, k) is not None:
        return "pallas"
    return "xla"


def sharded_cosine_topk(
    mesh: Mesh,
    index,  # this process's shards [R, D] (slot order), or the full [N_padded, D]
    queries: torch.Tensor,  # [Q, D]
    start: int,  # first valid global row
    end: int,  # one past the last valid global row
    k: int,
    axis: str = "data",
    row_scales=None,  # [N_padded] or per-shard [R] dequantisation scales (int8)
    impl: str = "xla",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32, global rows [Q, k] int64) of the exact top k
    over rows ``[start, end)`` of the sharded index, on the first local
    slot's device. A full tensor (or full ``row_scales``) is split with
    ``place_rows`` first."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    n_shards = mesh.axis_size(axis)
    if isinstance(index, torch.Tensor):
        index = place_rows(mesh, index, axis)
    if isinstance(row_scales, torch.Tensor):
        row_scales = place_rows(mesh, row_scales, axis)
    slots = mesh.leaders(axis)
    if len(index) != len(slots):
        raise ValueError(f"{len(index)} shards for {len(slots)} local slots")
    rows = index[0].shape[0]
    if not 1 <= k <= rows:
        raise ValueError(f"k={k} outside 1..{rows} (the rows of one shard)")
    route = shard_route(impl, rows, index[0].shape[1], queries.shape[0], k)
    topk = fused_topk if route == "pallas" else cosine_topk
    out_dev = index[0].device
    scores, idx = [], []
    for i, s in enumerate(slots):
        shard = index[i]
        row0 = mesh.axis_index(s, axis) * rows
        lo = min(max(start - row0, 0), rows)
        hi = min(max(end - row0, 0), rows)
        q = queries.to(shard.device)
        sc, r = topk(shard, q, lo, hi, k, None if row_scales is None else row_scales[i])
        scores.append(sc.to(out_dev))
        idx.append((r + row0).to(out_dev))
    all_scores = torch.cat(multihost.all_gather(torch.stack(scores)), dim=0)
    all_idx = torch.cat(multihost.all_gather(torch.stack(idx)), dim=0)
    if all_scores.shape[0] != n_shards:
        raise ValueError(f"{all_scores.shape[0]} lists gathered for {n_shards} shards")
    return merge_topk(all_scores, all_idx, k)


class ShardedIndex:
    """A frame index split by rows over ``axis`` of ``mesh``: this process's
    shards (slot order) and, for int8 rows, their scales. ``topk`` routes a
    search as the JAX ``FrameIndex`` does under a mesh: the sharded search
    where there is more than one shard and k fits a shard, else the
    one-device search over the rows gathered onto the first slot's device."""

    def __init__(self, mesh: Mesh, axis: str, shards: list, row_scales: list | None = None):
        self.mesh = mesh
        self.axis = axis
        self.shards = shards
        self.row_scales = row_scales
        self.n_shards = mesh.axis_size(axis)
        self.rows_per_shard = shards[0].shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows_per_shard * self.n_shards, self.shards[0].shape[1])

    def gathered(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The whole index (and scales) on the first slot's device."""
        dev = self.shards[0].device
        if len(self.shards) == 1 and multihost.process_count() == 1:
            return self.shards[0], None if self.row_scales is None else self.row_scales[0]

        def whole(parts):
            return torch.cat(multihost.all_gather(torch.cat([p.to(dev) for p in parts])))

        return whole(self.shards), None if self.row_scales is None else whole(self.row_scales)

    def topk(self, queries: torch.Tensor, start: int, end: int, k: int, impl: str = "xla"):
        if self.n_shards > 1 and k <= self.rows_per_shard:
            return sharded_cosine_topk(self.mesh, self.shards, queries, start, end, k, self.axis,
                                       row_scales=self.row_scales, impl=impl)
        index, scales = self.gathered()
        topk = fused_topk if impl == "pallas" else cosine_topk
        return topk(index, queries.to(index.device), start, end, k, scales)
