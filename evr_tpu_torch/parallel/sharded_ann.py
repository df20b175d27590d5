"""Mesh-sharded IVF and IVF-PQ: the ANN tiers split by rows over a mesh axis
(PyTorch).

Counterpart of ``evr_tpu/parallel/sharded_ann.py``. The corpus splits into
contiguous row ranges (``_balanced_ranges``: sizes differing by at most one,
never empty), one a group of ``axis`` (``Mesh.leaders``), and each shard
builds its own index over its rows, on its slot's device:

- ``ShardedIVFIndex``: an ``IVFIndex`` a shard (``build``, seed + i), its own
  k-means and inverted lists. Every row lives in exactly one list or pool of
  one shard, so ``nprobe = n_clusters`` gives the exact global top-k.
- ``ShardedIVFPQIndex``: an ``IVFPQIndex`` a shard built on the device
  (``build_device``, seed + i: its own coarse k-means, residual PQ and OPQ),
  packed codes, the query rotated per shard. ``fetch`` (one shard's depth,
  clamped to its rows) is kept apart from ``merge_k`` (the merged depth), so
  a re-rank deeper than one shard draws from every shard; the exact re-rank
  reads the fp32 originals kept at build or ``attach_host_store``'s int8
  rows. ``adc_impl="pallas"`` scores the probed lists with kernel K7
  (``IVFPQIndex._probe_adc_search_packed``), once a shard and probe chunk;
  ``"auto"`` means ``"xla"``, as in the JAX package.

A search probes each shard on its slot (one controller, slot order), maps
its rows to global ids by the shard's row offset, and merges the shards'
k-sized lists (``ops.topk.merge_topk``: the lower global row first among
equal scores); across processes the lists are gathered in rank order.
Where the JAX package demotes a failing Pallas search to ``"xla"``
(``sharded_ann.py:505-520``), the port raises: a K7 failure is an error.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.index.ivf import IVFIndex
from evr_tpu_torch.index.ivfpq import ADC_IMPLS, IVFPQIndex
from evr_tpu_torch.ops.topk import merge_topk

from . import multihost
from .mesh import Mesh


def _balanced_ranges(n: int, s: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) row ranges, sizes differing by at most 1 and
    never empty (requires n >= s); global ids come from each range's
    offset."""
    if n < s:
        raise ValueError(f"N={n} rows cannot shard over {s} devices")
    base, extra = divmod(n, s)
    out, start = [], 0
    for i in range(s):
        end = start + base + (1 if i < extra else 0)
        out.append((start, end))
        start = end
    return out


def _pad(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """A shard's [B, k'] list widened to k with (−inf, −1) where it reached
    fewer candidates."""
    short = k - scores.shape[1]
    if short <= 0:
        return scores, rows
    b = scores.shape[0]
    return (torch.cat([scores, scores.new_full((b, short), -torch.inf)], dim=1),
            torch.cat([rows, rows.new_full((b, short), -1)], dim=1))


class _Sharded:
    """What the two tiers share: the mesh, the shards this process builds
    (one a leader slot of ``axis``, in order along it) and their offsets."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.axis_size(axis)
        self.shards: list = []
        self.offsets: list[int] = []
        self._n_rows = 0
        self._rows_per_shard = 0

    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def n_clusters(self) -> int:
        return self.shards[0].n_clusters if self.shards else 0

    def _plan(self, n: int, n_clusters: int):
        """(this process's (slot, shard number, (start, end))), the smallest
        shard's rows; refuses more clusters than the smallest shard holds."""
        ranges = _balanced_ranges(n, self.n_shards)
        smallest = min(e - b for b, e in ranges)
        if n_clusters > smallest:
            raise ValueError(
                f"n_clusters={n_clusters} exceeds the smallest shard's row count "
                f"(N={n} over {self.n_shards} shards)")
        self._n_rows = n
        self._rows_per_shard = max(e - b for b, e in ranges)
        mine = [(s, j, ranges[j]) for s in self.mesh.leaders(self.axis)
                for j in [self.mesh.axis_index(s, self.axis)]]
        self.offsets = [r[0] for _, _, r in mine]
        return mine, smallest

    def _merge(self, parts: list[tuple[torch.Tensor, torch.Tensor]], k: int) -> tuple[np.ndarray, np.ndarray]:
        """The shards' [B, fetch] lists (global rows) merged into the top k,
        on the host; (−inf, −1) where fewer are reachable."""
        scores = torch.stack([s.cpu() for s, _ in parts])
        rows = torch.stack([r.cpu() for _, r in parts])
        scores = torch.cat(multihost.all_gather(scores), dim=0)
        rows = torch.cat(multihost.all_gather(rows), dim=0)
        best, idx = merge_topk(scores, rows, k)
        best, idx = best.numpy(), idx.numpy()
        return best, np.where(np.isfinite(best), idx, -1)

    def _queries(self, queries) -> np.ndarray:
        return np.atleast_2d(np.asarray(queries, np.float32))


class ShardedIVFIndex(_Sharded):
    """Row-sharded IVF over ``axis`` of ``mesh``: ``IVFIndex``'s search
    surface, ``search(q, top_k, nprobe)``, built shard by shard."""

    @torch.no_grad()
    def build(self, emb: np.ndarray, n_clusters: int, capacity_factor: float = 1.5, iters: int = 10,
              seed: int = 0, dtype: str = "float32", spill_choices: int = 4) -> "ShardedIVFIndex":
        emb = np.asarray(emb, np.float32)
        mine, _ = self._plan(emb.shape[0], n_clusters)
        self.shards = [
            IVFIndex().build(emb[b:e], n_clusters, capacity_factor=capacity_factor, iters=iters, seed=seed + j,
                             dtype=dtype, spill_choices=spill_choices, device=self.mesh.slot_devices[s])
            for s, j, (b, e) in mine
        ]
        return self

    @classmethod
    def from_shards(cls, mesh: Mesh, shards: list[IVFIndex], n_rows: int, axis: str = "data") -> "ShardedIVFIndex":
        """An index over shards built elsewhere (for example ``IVFIndex.load``
        of another package's files): shard i holds rows
        ``_balanced_ranges(n_rows, S)[i]``, this process's in order."""
        out = cls(mesh, axis)
        mine, _ = out._plan(n_rows, shards[0].n_clusters)
        out.shards = [shards[j] for _, j, _ in mine]
        return out

    def search(self, queries: np.ndarray, top_k: int, nprobe: int) -> tuple[np.ndarray, np.ndarray]:
        """(scores [B, k], global row ids [B, k]); unreachable slots are
        (−inf, −1)."""
        if not self.shards:
            raise ValueError("ShardedIVFIndex.search before build()")
        nprobe = max(1, min(nprobe, self.n_clusters))
        cap = max(s._capacity for s in self.shards) * nprobe + max(max(s._overflow_size for s in self.shards), 1)
        top_k = max(1, min(top_k, cap, self._n_rows))
        q_np = self._queries(queries)
        parts = []
        with torch.no_grad():
            for sub, off in zip(self.shards, self.offsets):
                q = torch.from_numpy(q_np).to(sub.device)
                sc, rows = sub._probe_search(q, sub.emb, sub.centroids, sub.list_rows, sub.overflow, top_k, nprobe)
                sc, rows = _pad(sc, rows.long(), top_k)
                parts.append((sc, torch.where(rows >= 0, rows + off, -1)))
        return self._merge(parts, top_k)


class ShardedIVFPQIndex(_Sharded):
    """Row-sharded IVF-PQ over ``axis`` of ``mesh``: ``IVFPQIndex``'s search
    surface, ``search(q, top_k, nprobe, rerank=, adc_impl=)``, built shard by
    shard on the device (packed codes)."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        super().__init__(mesh, axis)
        self._originals = None
        self._originals_int8 = None
        self._originals_int8_scales = None

    @torch.no_grad()
    def build(self, emb: np.ndarray, n_clusters: int, n_subspaces: int = 64, n_centroids: int = 256,
              capacity_factor: float = 1.5, coarse_iters: int = 6, pq_iters: int = 6, opq_iters: int = 0,
              seed: int = 0, keep_originals: bool = True, spill_choices: int = 4) -> "ShardedIVFPQIndex":
        emb = np.asarray(emb, np.float32)
        n, d = emb.shape
        mine, smallest = self._plan(n, n_clusters)
        sub = next(ss for ss in (n_subspaces, 64, 32, 16, 8, 4, 2, 1) if d % ss == 0)
        self.shards = [
            IVFPQIndex().build_device(
                torch.from_numpy(emb[b:e]).to(self.mesh.slot_devices[s]), n_clusters, n_subspaces=sub,
                n_centroids=min(n_centroids, smallest), capacity_factor=capacity_factor,
                coarse_iters=coarse_iters, pq_iters=pq_iters, seed=seed + j, spill_choices=spill_choices,
                opq_iters=opq_iters)
            for s, j, (b, e) in mine
        ]
        self._originals = emb if keep_originals else None
        return self

    @classmethod
    def from_shards(cls, mesh: Mesh, shards: list[IVFPQIndex], n_rows: int, originals=None,
                    axis: str = "data") -> "ShardedIVFPQIndex":
        """An index over packed shards built elsewhere (``IVFPQIndex.load``):
        shard i holds rows ``_balanced_ranges(n_rows, S)[i]``; ``originals``
        [n_rows, D] fp32 is the re-rank source."""
        out = cls(mesh, axis)
        mine, _ = out._plan(n_rows, shards[0].n_clusters)
        out.shards = [shards[j] for _, j, _ in mine]
        out._originals = None if originals is None else np.asarray(originals, np.float32)
        return out

    def attach_host_store(self, rows_int8, scales) -> None:
        """int8 rows and per-row scales in host memory replace the fp32
        originals as the exact re-rank source."""
        rows_int8 = np.asarray(rows_int8, np.int8)
        scales = np.asarray(scales, np.float32)
        if rows_int8.shape[0] != self._n_rows:
            raise ValueError(f"host store rows {rows_int8.shape[0]} != corpus {self._n_rows}")
        self._originals_int8 = rows_int8
        self._originals_int8_scales = scales

    def search(self, queries: np.ndarray, top_k: int, nprobe: int, rerank: int | None = None,
               adc_impl: str = "auto") -> tuple[np.ndarray, np.ndarray]:
        """(scores [B, k], global row ids [B, k]); unreachable slots are
        (−inf, −1). Without ``rerank`` the scores are each shard's ADC
        approximation; with it, the merged candidates' cosines re-scored on
        the host from the re-rank source, so ``nprobe = n_clusters`` and a
        re-rank at least the candidate depth give the exact global top-k."""
        if not self.shards:
            raise ValueError("ShardedIVFPQIndex.search before build()")
        if rerank is not None and self._originals is None and self._originals_int8 is None:
            raise ValueError("rerank requires keep_originals=True at build or an attach_host_store() "
                             "int8 row store")
        if adc_impl not in ADC_IMPLS:
            raise ValueError(f"unknown adc_impl {adc_impl!r}")
        if adc_impl == "auto":
            adc_impl = "xla"
        nprobe = max(1, min(nprobe, self.n_clusters))
        qn = self._queries(queries)
        pool = max(max(int(s.overflow.shape[0]) for s in self.shards), 1)
        width = max(s._capacity for s in self.shards) * nprobe + pool
        requested = top_k if rerank is None else max(top_k, rerank)
        fetch = max(1, min(requested, width, self._rows_per_shard))
        merge_k = max(1, min(requested, self.n_shards * fetch, self._n_rows))
        parts = []
        with torch.no_grad():
            for sub, off in zip(self.shards, self.offsets):
                q = torch.from_numpy(qn).to(sub.device)
                q_adc = q if sub.rotation is None else q @ sub.rotation
                sc, rows = sub._probe_adc_search_packed(
                    q, q_adc, sub.centroids, sub.codebooks, sub.codes_lists, sub.id_lists, sub._pool_recon(),
                    sub.overflow, fetch, nprobe, sub._capacity, adc_impl)
                sc, rows = _pad(sc, rows.long(), fetch)
                parts.append((sc, torch.where(rows >= 0, rows + off, -1)))
        scores, rows = self._merge(parts, merge_k)
        if rerank is None:
            k = min(top_k, scores.shape[1])
            return scores[:, :k], rows[:, :k]
        safe = np.where(rows >= 0, rows, 0)
        if self._originals is not None:
            cand = self._originals[safe]                                   # [B, R, D]
        else:
            cand = self._originals_int8[safe].astype(np.float32)
            cand *= self._originals_int8_scales[safe][:, :, None]
        exact = np.einsum("bd,brd->br", qn, cand).astype(np.float32)
        exact = np.where(rows >= 0, exact, -np.inf)
        k = min(top_k, exact.shape[1])
        order = np.argsort(-exact, axis=1)[:, :k]
        out_rows = np.take_along_axis(rows, order, axis=1)
        out_scores = np.take_along_axis(exact, order, axis=1)
        return out_scores, np.where(np.isfinite(out_scores), out_rows, -1)
