"""IVF approximate-NN index: the inverted-file tier (PyTorch).

Counterpart of ``evr_tpu/index/ivf.py``. Inverted lists are a dense
[n_clusters, capacity] row-id matrix (−1 padding); rows that find every
ranked list full go to an overflow pool that every query scores exactly, so
every row lives in exactly one place and ``nprobe = n_clusters`` is brute
force. A search scores the centroids, takes the top ``nprobe`` lists, scores
their rows (and the pool) and merges a top-k.

Where the port differs from the JAX package, and why:

- **k-means init.** JAX draws the initial centroids with
  ``jax.random.choice``; the port draws them from a ``torch.Generator``
  (``kmeans_init``), so the same seed gives other clusters. Lloyd's
  iterations from given centroids (``kmeans_from_init``) are the same
  computation in both packages.
- **Deterministic sums.** ``segment_sum`` becomes a one-hot GEMM over row
  chunks (fixed order), not ``index_add_``, whose fp32 atomics on the card
  add in no fixed order: a seeded build gives the same index twice.
- **Ties.** Every top-k (probed lists, spill choices, the merged result) takes
  the lower index first among equal scores, as ``lax.top_k`` does: a stable
  descending sort (``ops.topk._ordered_topk``), or rounds of first-argmax for
  the spill choices.
- **Products.** Candidate scores multiply in fp32 from bf16 or int8 operands
  (exact in fp32) and sum in fp32, as JAX's ``preferred_element_type=
  float32`` does; the packed layout's ``rows.astype(bf16) @ q`` gives fp32
  sums too in the JAX package as XLA runs it on the CPU (its scores are not
  rounded to bf16), and the port keeps them so.
- **Padding ids.** ``-1`` ids are replaced by row 0 before any gather and
  masked to −inf after (torch indexing with −1 would wrap silently).

``save``/``load`` use the JAX package's ``.npz`` layout, so either package
loads the other's index (bf16 arrays, which numpy stores as 2-byte voids, are
read back as bf16).
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.ops.topk import _ordered_topk
from evr_tpu_torch.utils.device import resolve_device

# bytes a chunked transient (scores, one-hots, gathered rows) may take
CHUNK_BYTES = 256 << 20


# -- list placement (numpy, the JAX package's implementation) ---------------


def fill_inverted_lists(
    assign: np.ndarray,
    lists: np.ndarray,
    overflow: list,
    start_row: int = 0,
) -> None:
    """Place rows into their assigned list's next free slot, spilling
    beyond-capacity rows to the overflow pool (corpus-order fill, -1 padding
    as a suffix). Mutates ``lists`` and ``overflow`` in place."""
    assign = np.asarray(assign, np.int64).reshape(-1, 1)
    fill_inverted_lists_multi(assign, lists, overflow, start_row=start_row)


def fill_inverted_lists_multi(
    assign_topm: np.ndarray,
    lists: np.ndarray,
    overflow: list,
    start_row: int = 0,
) -> np.ndarray:
    """Multi-choice list placement: round m places each still-unplaced row
    into its m-th-nearest centroid's list if a slot is free; only rows whose
    every ranked choice is full reach the overflow pool. Within a round,
    rows take slots in corpus order. Mutates ``lists``/``overflow``; returns
    the placement [N] int64 (the list each row landed in, −1 for overflow)."""
    assign_topm = np.asarray(assign_topm, np.int64)
    n, _m = assign_topm.shape
    capacity = lists.shape[1]
    fill = (lists >= 0).sum(axis=1).astype(np.int64)
    placement = np.full(n, -1, np.int64)
    unplaced = np.arange(n, dtype=np.int64)
    for m in range(_m):
        if unplaced.size == 0:
            break
        choice = assign_topm[unplaced, m]
        order = np.argsort(choice, kind="stable")
        sc = choice[order]
        new_grp = np.empty(sc.size, bool)
        new_grp[0] = True
        new_grp[1:] = sc[1:] != sc[:-1]
        starts = np.flatnonzero(new_grp)
        rank = np.arange(sc.size) - starts[np.cumsum(new_grp) - 1]
        slot = fill[sc] + rank
        ok = slot < capacity
        rows_global = unplaced[order]
        lists[sc[ok], slot[ok]] = (start_row + rows_global[ok]).astype(lists.dtype)
        placement[rows_global[ok]] = sc[ok]
        np.add.at(fill, sc[ok], 1)
        unplaced = np.sort(rows_global[~ok])
    overflow.extend((start_row + unplaced).tolist())
    return placement


# -- shared helpers of the ANN tiers ----------------------------------------


def chunk_rows(row_bytes: int) -> int:
    """Rows per chunk so that a transient of ``row_bytes`` a row stays within
    CHUNK_BYTES."""
    return max(1, CHUNK_BYTES // max(1, row_bytes))


def topm(scores: torch.Tensor, m: int) -> torch.Tensor:
    """[rows, m] indices of each row's m largest scores, best first and the
    lower index first among equal scores (``lax.top_k``'s order), by m rounds
    of first-argmax. ``scores`` is overwritten."""
    out = []
    for _ in range(m):
        i = scores.argmax(dim=1)
        out.append(i)
        scores.scatter_(1, i[:, None], -torch.inf)
    return torch.stack(out, dim=1)


def rank_clusters(x: torch.Tensor, cents: torch.Tensor, m: int) -> np.ndarray:
    """[N, m] int64 (host) nearest centroids of each row of ``x`` by inner
    product, in row chunks."""
    step = chunk_rows(4 * cents.shape[0])
    parts = []
    for lo in range(0, x.shape[0], step):
        sco = x[lo : lo + step].float() @ cents.T
        parts.append(topm(sco, m).cpu())
    return torch.cat(parts).numpy()


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: scale = max|x| / 127 (at least 1e-12), codes
    round(x / scale) half to even, as the JAX tiers quantize."""
    x = x.float()
    scale = (x.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    return torch.round(x / scale[:, None]).to(torch.int8), scale


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the JAX package saves it; bf16 as numpy's 2-byte void,
    which is what ``np.savez`` writes for JAX's bf16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bf16 saved through numpy
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# -- spherical k-means --------------------------------------------------------


def kmeans_init(n: int, n_clusters: int, seed: int) -> torch.Tensor:
    """Row indices [n_clusters] int64 of the initial centroids: distinct rows
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:n_clusters]


def _argmax_assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    step = chunk_rows(4 * cents.shape[0])
    return torch.cat([
        (x[lo : lo + step] @ cents.T).argmax(dim=1) for lo in range(0, x.shape[0], step)
    ])


def cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """(sums [k, D], counts [k]) of the rows of each cluster, as one-hot
    GEMMs over row chunks in a fixed order: deterministic on the card, where
    ``index_add_`` adds in no fixed order."""
    step = chunk_rows(4 * k)
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], step):
        oh = torch.nn.functional.one_hot(assign[lo : lo + step], k).float()
        sums += oh.T @ x[lo : lo + step]
    counts = torch.bincount(assign, minlength=k).float()
    return sums, counts


def kmeans_from_init(x: torch.Tensor, init: torch.Tensor, iters: int = 10):
    """Spherical Lloyd's iterations from the centroids ``init`` [k, D]:
    assignment by argmax inner product, the update re-normalised, an empty
    cluster keeps its centroid. ``x`` [N, D] fp32, L2-normalised. Returns
    (centroids [k, D], assignments [N] int32)."""
    x = x.float()
    cents = init.float().clone()
    k = cents.shape[0]
    for _ in range(iters):
        sums, counts = cluster_sums(x, _argmax_assign(x, cents), k)
        fresh = sums / sums.norm(dim=1, keepdim=True).clamp_min(1e-12)
        cents = torch.where(counts[:, None] > 0, fresh, cents)
    return cents, _argmax_assign(x, cents).int()


def kmeans(x: torch.Tensor, n_clusters: int, iters: int = 10, seed: int = 0):
    """Spherical k-means on ``x``'s device: init from ``kmeans_init`` then
    ``kmeans_from_init``."""
    idx = kmeans_init(x.shape[0], n_clusters, seed).to(x.device)
    return kmeans_from_init(x, x[idx].float(), iters)


# -- the index ----------------------------------------------------------------


def probe_lists(q: torch.Tensor, cents: torch.Tensor, nprobe: int):
    """(centroid scores [B, k], top-nprobe scores and list ids [B, nprobe])."""
    cscores = q @ cents.T
    cvals, cids = _ordered_topk(cscores, nprobe)
    return cscores, cvals, cids


def merge_candidates(scores: torch.Tensor, ids: torch.Tensor, top_k: int):
    """Top-k of [B, M] candidate scores, lower position first on ties, and
    the candidates' ids."""
    best, pos = _ordered_topk(scores, top_k)
    return best, torch.gather(ids, 1, pos)


class IVFIndex:
    """Inverted-file cosine top-k over a fixed embedding matrix.

    Holds the [N, D] rows (lists store row ids), [k, D] centroids, the
    [k, C] list matrix and the overflow row pool; or, in the packed layout
    (``build_device`` default), each list's rows contiguously at flat rows
    [i·C, (i+1)·C) with their ids.
    """

    def __init__(self):
        self.emb = None           # [N, D] (fp32 / bf16 / int8)
        self.row_scales = None    # [N] fp32, int8 storage only
        self.centroids = None     # [k, D] fp32
        self.list_rows = None     # [k, C] int32, -1 padded
        self.overflow = None      # [O] int32
        # packed layout: list i's rows at flat rows [i*C, (i+1)*C)
        self.emb_lists = None     # [k*C, D]
        self.scale_lists = None   # [k*C] fp32, int8 storage only
        self.id_lists = None      # [k*C] int32 corpus row ids, -1 padded
        self.overflow_emb = None  # [O, D]
        self.overflow_scales = None  # [O] fp32, int8 storage only
        self._n_rows = 0

    @property
    def packed(self) -> bool:
        return self.emb_lists is not None

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def n_rows(self) -> int:
        if self.packed:
            return self._n_rows
        return 0 if self.emb is None else int(self.emb.shape[0])

    @property
    def n_clusters(self) -> int:
        return 0 if self.centroids is None else int(self.centroids.shape[0])

    @property
    def _capacity(self) -> int:
        if self.packed:
            return int(self.emb_lists.shape[0]) // self.n_clusters
        return int(self.list_rows.shape[1])

    @property
    def _overflow_size(self) -> int:
        return 0 if self.overflow is None else int(self.overflow.shape[0])

    @torch.no_grad()
    def build(
        self,
        emb: np.ndarray,
        n_clusters: int,
        capacity_factor: float = 1.5,
        iters: int = 10,
        seed: int = 0,
        dtype: str = "float32",
        spill_choices: int = 4,
        device=None,
    ) -> "IVFIndex":
        """Build from host rows (L2-normalised). ``dtype``: storage of the
        resident rows, 'float32' or 'bfloat16' (k-means always fp32).
        ``spill_choices``: rows whose list is full try their next-nearest
        centroids before the overflow pool; 1 is single-choice fill.
        ``device``: None means the card."""
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported IVF storage dtype {dtype!r}")
        emb = np.asarray(emb, np.float32)
        n, _ = emb.shape
        if n_clusters < 1 or n_clusters > n:
            raise ValueError(f"n_clusters={n_clusters} must be in [1, {n}]")
        x = torch.from_numpy(emb).to(resolve_device(device))
        cents, _ = kmeans(x, n_clusters, iters=iters, seed=seed)
        ranked = rank_clusters(x, cents, max(1, min(spill_choices, n_clusters)))
        capacity = max(1, int(np.ceil(n / n_clusters * capacity_factor)))
        lists = np.full((n_clusters, capacity), -1, np.int32)
        overflow: list = []
        fill_inverted_lists_multi(ranked, lists, overflow)

        self.emb = x.to(torch.bfloat16) if dtype == "bfloat16" else x
        self.centroids = cents
        self.list_rows = torch.from_numpy(lists).to(x.device)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=x.device)
        return self

    @torch.no_grad()
    def build_device(
        self,
        x_dev: torch.Tensor,
        n_clusters: int,
        capacity_factor: float = 1.5,
        iters: int = 10,
        seed: int = 0,
        train_rows: int = 524_288,
        slab_rows: int = 1_000_000,
        dtype: str = "bfloat16",
        row_scales=None,
        packed: bool = True,
        spill_choices: int = 4,
    ) -> "IVFIndex":
        """Build from a corpus already on the device (any float dtype, or
        int8 with its ``row_scales``), never copied to the host: k-means
        trains fp32 on a strided sample of ``train_rows``, assignment streams
        slabs, and only the [N, m] choice ranking crosses to the host for
        the list fill. ``dtype``: resident storage, 'float32', 'bfloat16' or
        'int8' (per-row symmetric scales). ``packed`` (default) stores each
        list's rows contiguously (``_pack_device``); capacity is then rounded
        up to a multiple of 8, as the JAX package lays it out."""
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unsupported IVF storage dtype {dtype!r}")
        n, _ = x_dev.shape
        if n_clusters < 1 or n_clusters > n:
            raise ValueError(f"n_clusters={n_clusters} must be in [1, {n}]")
        pre_quantized = x_dev.dtype == torch.int8
        if pre_quantized and (row_scales is None or dtype != "int8"):
            raise ValueError("int8 x_dev requires row_scales and dtype='int8'")
        stride = max(1, n // min(train_rows, n))
        sample = x_dev[::stride][: min(train_rows, n)].float()
        cents, _ = kmeans(sample, n_clusters, iters=iters, seed=seed)
        del sample
        m = max(1, min(spill_choices, n_clusters))
        # the [rows, k] fp32 scores of a slab stay below ~1 GB
        a_rows = slab_rows if m == 1 else min(slab_rows, max(8192, (1 << 30) // (4 * n_clusters)))
        ranked = np.concatenate([
            rank_clusters(x_dev[i : i + a_rows], cents, m) for i in range(0, n, a_rows)
        ])
        capacity = max(1, int(np.ceil(n / n_clusters * capacity_factor)))
        if packed:
            capacity = (capacity + 7) // 8 * 8
        lists = np.full((n_clusters, capacity), -1, np.int32)
        overflow: list = []
        fill_inverted_lists_multi(ranked, lists, overflow)
        self.centroids = cents
        scales = (
            torch.as_tensor(row_scales, dtype=torch.float32, device=x_dev.device)
            if pre_quantized else None
        )
        if packed:
            self._pack_device(x_dev, scales, lists, np.asarray(overflow, np.int32), dtype)
            return self

        if pre_quantized:
            self.emb, self.row_scales = x_dev, scales
        elif dtype == "int8":
            qs, scs = zip(*(quantize_rows_int8(x_dev[i : i + slab_rows]) for i in range(0, n, slab_rows)))
            self.emb, self.row_scales = torch.cat(qs), torch.cat(scs)
        else:
            target = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            self.emb, self.row_scales = x_dev.to(target), None
        self.list_rows = torch.from_numpy(lists).to(x_dev.device)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=x_dev.device)
        return self

    def _pack_device(self, x_dev, src_scales, lists, overflow, dtype) -> None:
        """The packed layout on the device: list i's rows land contiguously
        at flat rows [i·C, (i+1)·C), written a few lists at a time so the
        gathered transient stays bounded; quantized per row for 'int8'. Pad
        slots hold row 0's values and are masked by ``id_lists < 0``."""
        k, capacity = lists.shape
        n, d = x_dev.shape
        dev = x_dev.device
        int8 = dtype == "int8"
        store = torch.int8 if int8 else (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        ids_flat = torch.from_numpy(lists.reshape(-1)).to(dev)
        self.id_lists = ids_flat
        self._n_rows = n
        out = torch.zeros((k * capacity, d), dtype=store, device=dev)
        scl = torch.zeros((k * capacity,), dtype=torch.float32, device=dev) if int8 else None
        step = max(1, (64 << 20) // max(1, capacity * d)) * capacity  # slots per write
        for lo in range(0, k * capacity, step):
            idc = ids_flat[lo : lo + step].long()
            safe = torch.where(idc >= 0, idc, 0)
            if src_scales is not None:
                out[lo : lo + step] = x_dev[safe]
                scl[lo : lo + step] = src_scales[safe]
            elif int8:
                out[lo : lo + step], scl[lo : lo + step] = quantize_rows_int8(x_dev[safe])
            else:
                out[lo : lo + step] = x_dev[safe].to(store)
        self.emb_lists, self.scale_lists = out, scl
        self.overflow = torch.from_numpy(overflow).to(dev)
        ovf = self.overflow.long()
        if src_scales is not None:
            self.overflow_emb, self.overflow_scales = x_dev[ovf], src_scales[ovf]
        elif int8:
            self.overflow_emb, self.overflow_scales = quantize_rows_int8(x_dev[ovf])
        else:
            self.overflow_emb, self.overflow_scales = x_dev[ovf].to(store), None

    @torch.no_grad()
    def append(self, emb_new: np.ndarray) -> np.ndarray:
        """Add rows without re-running k-means: each goes to its nearest
        centroid's list if a slot is free, else to the overflow pool.
        Returns the new rows' ids. Every row still lives exactly once."""
        if self.emb is None and not self.packed:
            raise ValueError("IVFIndex.append before build()")
        d = self.emb_lists.shape[1] if self.packed else self.emb.shape[1]
        emb_new = np.asarray(emb_new, np.float32)
        if emb_new.ndim != 2 or emb_new.shape[1] != d:
            raise ValueError(f"append rows must be (M, {d}), got {emb_new.shape}")
        if self.packed:
            return self._append_packed(emb_new)
        start = self.n_rows
        x = torch.from_numpy(emb_new).to(self.device)
        assign = (x @ self.centroids.T).argmax(dim=1).cpu().numpy()
        lists = self.list_rows.cpu().numpy().copy()
        overflow = self.overflow.cpu().tolist()
        fill_inverted_lists(assign, lists, overflow, start_row=start)
        if self.row_scales is not None:
            xq, scale = quantize_rows_int8(x)
            self.emb = torch.cat([self.emb, xq])
            self.row_scales = torch.cat([self.row_scales, scale])
        else:
            self.emb = torch.cat([self.emb, x.to(self.emb.dtype)])
        self.list_rows = torch.from_numpy(lists).to(self.device)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=self.device)
        return np.arange(start, start + len(emb_new))

    def _append_packed(self, emb_new: np.ndarray) -> np.ndarray:
        """Packed-layout append: free-slot placements are written into the
        list blocks, the rest join the overflow pool."""
        start = self.n_rows
        capacity = self._capacity
        int8 = self.scale_lists is not None
        x = torch.from_numpy(emb_new).to(self.device)
        assign = (x @ self.centroids.T).argmax(dim=1).cpu().numpy()
        fill = (self.id_lists.cpu().numpy().reshape(-1, capacity) >= 0).sum(axis=1)
        slots, placed, spilled = [], [], []
        for i, c in enumerate(assign):
            if fill[c] < capacity:
                slots.append(int(c) * capacity + int(fill[c]))
                placed.append(i)
                fill[c] += 1
            else:
                spilled.append(i)
        if int8:
            xq, scale = quantize_rows_int8(x)
        else:
            xq, scale = x.to(self.emb_lists.dtype), None
        dev = self.device
        if placed:
            flat = torch.tensor(slots, device=dev)
            ri = torch.tensor(placed, device=dev)
            self.emb_lists[flat] = xq[ri]
            self.id_lists[flat] = (start + ri).int()
            if int8:
                self.scale_lists[flat] = scale[ri]
        if spilled:
            oi = torch.tensor(spilled, device=dev)
            self.overflow_emb = torch.cat([self.overflow_emb, xq[oi]])
            if int8:
                self.overflow_scales = torch.cat([self.overflow_scales, scale[oi]])
            self.overflow = torch.cat([self.overflow, (start + oi).int()])
        self._n_rows = start + len(emb_new)
        return np.arange(start, start + len(emb_new))

    @staticmethod
    def _probe_search(q, emb, cents, list_rows, overflow, top_k: int, nprobe: int):
        """Unpacked probe, fp32 or bf16 rows: gather the probed lists' rows,
        score them in fp32 (bf16 operands are exact there), score the pool
        as one shared GEMM, merge."""
        b = q.shape[0]
        _, _, cids = probe_lists(q, cents, nprobe)
        cand = list_rows[cids].reshape(b, -1).long()            # [B, nprobe*C]
        valid = cand >= 0
        qc = q.to(emb.dtype).float()
        gathered = emb[torch.where(valid, cand, 0)].float()     # [B, M, D]
        scores = torch.bmm(gathered, qc[:, :, None])[..., 0]
        scores = torch.where(valid, scores, -torch.inf)
        if overflow.shape[0]:
            ovf = overflow.long()
            scores = torch.cat([scores, qc @ emb[ovf].float().T], dim=1)
            cand = torch.cat([cand, ovf[None].expand(b, -1)], dim=1)
        return merge_candidates(scores, cand, top_k)

    @staticmethod
    def _probe_search_int8(q, emb_q, row_scales, cents, list_rows, overflow, top_k: int, nprobe: int):
        """int8 rows: bf16 query, products and sums in fp32, the row's scale
        applied after the sum; the pool as one shared GEMM."""
        b = q.shape[0]
        _, _, cids = probe_lists(q, cents, nprobe)
        cand = list_rows[cids].reshape(b, -1).long()
        valid = cand >= 0
        safe = torch.where(valid, cand, 0)
        qh = q.to(torch.bfloat16).float()
        scores = torch.bmm(emb_q[safe].float(), qh[:, :, None])[..., 0] * row_scales[safe]
        scores = torch.where(valid, scores, -torch.inf)
        if overflow.shape[0]:
            ovf = overflow.long()
            scores = torch.cat([scores, (qh @ emb_q[ovf].float().T) * row_scales[ovf]], dim=1)
            cand = torch.cat([cand, ovf[None].expand(b, -1)], dim=1)
        return merge_candidates(scores, cand, top_k)

    @staticmethod
    def _probe_search_packed(
        q, emb_lists, scale_lists, id_lists, cents, overflow_emb, overflow_scales, overflow_ids,
        top_k: int, nprobe: int, capacity: int,
    ):
        """Packed probe: each probed list is one contiguous [C, D] block.
        Probes are taken a few at a time, so the gathered blocks stay within
        CHUNK_BYTES for any nprobe. Scores sum in fp32 (bf16 queries against
        int8 rows, then the row scale); the pool is one shared GEMM."""
        b = q.shape[0]
        int8 = scale_lists is not None
        comp = torch.bfloat16 if int8 else emb_lists.dtype
        qh = q.to(comp).float()
        k, d = cents.shape[0], emb_lists.shape[1]
        _, _, cids = probe_lists(q, cents, nprobe)
        blocks = emb_lists.view(k, capacity, d)
        ids_all = id_lists.view(k, capacity)
        step = chunk_rows(4 * b * capacity * d)
        sco, ids = [], []
        for lo in range(0, nprobe, step):
            c = cids[:, lo : lo + step]                                   # [B, n]
            rows = blocks[c].float()                                      # [B, n, C, D]
            s = torch.einsum("bncd,bd->bnc", rows, qh)
            if int8:
                s = s * scale_lists.view(k, capacity)[c]
            i = ids_all[c]
            sco.append(torch.where(i >= 0, s, -torch.inf))
            ids.append(i)
        scores = torch.cat(sco, dim=1).reshape(b, -1)
        ids = torch.cat(ids, dim=1).reshape(b, -1).long()
        if overflow_emb.shape[0]:
            ovf = qh @ overflow_emb.float().T
            if int8:
                ovf = ovf * overflow_scales
            scores = torch.cat([scores, ovf], dim=1)
            ids = torch.cat([ids, overflow_ids.long()[None].expand(b, -1)], dim=1)
        return merge_candidates(scores, ids, top_k)

    def search(self, queries: np.ndarray, top_k: int, nprobe: int) -> tuple[np.ndarray, np.ndarray]:
        """(scores [B, k], row ids [B, k]); rows scoring −inf (fewer than
        top_k reachable candidates) carry row id −1."""
        if self.emb is None and not self.packed:
            raise ValueError("IVFIndex.search before build()")
        nprobe = max(1, min(nprobe, self.n_clusters))
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        cap = self._capacity * nprobe + self._overflow_size
        top_k = max(1, min(top_k, cap, self.n_rows))
        with torch.no_grad():
            if self.packed:
                scores, rows = self._probe_search_packed(
                    q, self.emb_lists, self.scale_lists, self.id_lists, self.centroids,
                    self.overflow_emb, self.overflow_scales, self.overflow,
                    top_k, nprobe, self._capacity,
                )
            elif self.row_scales is not None:
                scores, rows = self._probe_search_int8(
                    q, self.emb, self.row_scales, self.centroids, self.list_rows, self.overflow,
                    top_k, nprobe,
                )
            else:
                scores, rows = self._probe_search(
                    q, self.emb, self.centroids, self.list_rows, self.overflow, top_k, nprobe,
                )
        scores = scores.cpu().numpy()
        return scores, np.where(np.isfinite(scores), rows.cpu().numpy(), -1)

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        if self.packed:
            payload = dict(
                emb_lists=to_numpy(self.emb_lists),
                id_lists=to_numpy(self.id_lists),
                centroids=to_numpy(self.centroids),
                overflow=to_numpy(self.overflow),
                overflow_emb=to_numpy(self.overflow_emb),
                n_rows=np.int64(self._n_rows),
            )
            if self.scale_lists is not None:
                payload["scale_lists"] = to_numpy(self.scale_lists)
                payload["overflow_scales"] = to_numpy(self.overflow_scales)
        else:
            payload = dict(
                emb=to_numpy(self.emb),
                centroids=to_numpy(self.centroids),
                list_rows=to_numpy(self.list_rows),
                overflow=to_numpy(self.overflow),
            )
            if self.row_scales is not None:
                payload["row_scales"] = to_numpy(self.row_scales)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path, device=None) -> "IVFIndex":
        dev = resolve_device(device)
        z = np.load(path)
        idx = cls()
        idx.centroids = from_numpy(z["centroids"], dev)
        idx.overflow = from_numpy(z["overflow"].astype(np.int32), dev)
        if "emb_lists" in z:
            idx.emb_lists = from_numpy(z["emb_lists"], dev)
            idx.id_lists = from_numpy(z["id_lists"], dev)
            idx.overflow_emb = from_numpy(z["overflow_emb"], dev)
            idx._n_rows = int(z["n_rows"])
            if "scale_lists" in z:
                idx.scale_lists = from_numpy(z["scale_lists"], dev)
                idx.overflow_scales = from_numpy(z["overflow_scales"], dev)
            return idx
        idx.emb = from_numpy(z["emb"], dev)
        idx.list_rows = from_numpy(z["list_rows"], dev)
        if "row_scales" in z:
            idx.row_scales = from_numpy(z["row_scales"], dev)
        return idx
