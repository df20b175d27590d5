"""IVF-PQ: list probing × code compression (PyTorch).

Counterpart of ``evr_tpu/index/ivfpq.py`` (Jégou et al., TPAMI 2011). A
spherical k-means coarse quantizer with static inverted lists and an
always-searched overflow pool (``index/ivf.py``'s semantics: every row lives
in exactly one place), and a residual PQ: each row is encoded as the uint8
codes of ``x − c`` against its STORED list's centroid (optionally OPQ-
rotated). A query's score decomposes as ``q·c_list + q·r̃``: the first term is
the probed centroid's score, the second an ADC table lookup.

Layouts: ``build`` (host corpus, keeps fp32 originals for re-rank) gives the
unpacked layout, searched by ``_probe_adc_search`` (a gather per subspace,
no kernel). ``build_device`` (a corpus on the device) gives the packed layout
by default — list i's codes contiguous at flat rows [i·C, (i+1)·C) — and
``build_device_streamed`` the same codes stored paired ([k·C/2, 2S], the same
bytes). ``_probe_adc_search_packed`` scores probed lists either with
``adc_impl="xla"`` (the probed lists gathered, then a gather of the table
entries and a sum: a library expression) or ``adc_impl="pallas"``, which
hands kernel K7 (``ops.adc.adc_probe_scores``) the lists as they lie,
``[n_lists, C, S]``, and each chunk's probed list ids: no gathered copy.
``"auto"`` means "xla", as in the JAX package. K7 is not a fallback and has
none: on a CUDA index ``"pallas"`` launches the kernel or raises (the JAX
package demotes a failing instance to "xla"; the port does not). The
overflow pool is scored as one GEMM against its PQ reconstructions
(``_pool_recon``).

Probes go a chunk at a time, so the transient stays within
``ivf.CHUNK_BYTES`` (256 MB) whatever ``nprobe``: with K7 a chunk's fp32
scores, its rows' int32 ids, their validity mask and the fp32 sum with the
centroid scores and its masked copy (17 bytes a row), with the gather-sum
its gathered codes' int64 indices; the JAX package slices one probe at a time into the kernel. k-means inits come from ``torch.Generator``s, so a
port-built index differs from a JAX-built one; both load each other's
``.npz`` and search it alike.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.ops.adc import adc_probe_scores
from evr_tpu_torch.utils.device import resolve_device

from .ivf import (
    chunk_rows,
    fill_inverted_lists,
    fill_inverted_lists_multi,
    from_numpy,
    kmeans,
    merge_candidates,
    probe_lists,
    rank_clusters,
    to_numpy,
)
from .pq import adc_tables, kmeans_l2_init, pq_train

ADC_IMPLS = ("auto", "xla", "pallas")


def _train_residual_quantizers(resid, n_subspaces, n_centroids, pq_iters, opq_iters, seed):
    """(codebooks [S, K, ds], rotation [D, D] or None) from a residual
    training sample [m, D] on the device. ``opq_iters > 0`` alternates
    training the books on rotated residuals and the Procrustes update of R
    from the host SVD of residᵀ·recon. The subspaces' initial rows are drawn
    once (from ``seed + 1``) and reused by every training, as the JAX package
    reuses its keys."""
    m, d = resid.shape
    init_idx = kmeans_l2_init(m, n_centroids, n_subspaces, seed + 1)
    rot = None
    if opq_iters > 0:
        rot = torch.eye(d, dtype=torch.float32, device=resid.device)
        inner = max(2, pq_iters // 2)
        for _ in range(opq_iters):
            books_i, assign_i = pq_train(resid @ rot, n_subspaces, n_centroids, inner, init_idx)
            recon = torch.gather(
                books_i, 1, assign_i.long()[:, :, None].expand(-1, -1, books_i.shape[2])
            ).transpose(0, 1).reshape(m, d)
            u, _, vt = np.linalg.svd((resid.T @ recon).cpu().numpy(), full_matrices=False)
            rot = torch.from_numpy((u @ vt).astype(np.float32)).to(resid.device)
        resid = resid @ rot
    books, _ = pq_train(resid, n_subspaces, n_centroids, pq_iters, init_idx)
    return books, rot


def encode_residuals(rows, cent_ids, cents, books, rot=None) -> torch.Tensor:
    """[m, S] uint8 codes of ``rows − cents[cent_ids]`` (rotated by ``rot``):
    per subspace argmin(|c|² − 2 r·c), in row chunks."""
    s, k, ds = books.shape
    c_sq = books.square().sum(dim=2)[:, None, :]                       # [S, 1, K]
    step = chunk_rows(4 * s * k)
    out = []
    for lo in range(0, rows.shape[0], step):
        r = rows[lo : lo + step].float() - cents[cent_ids[lo : lo + step].long()]
        if rot is not None:
            r = r @ rot
        rs = r.reshape(-1, s, ds).transpose(0, 1)                      # [S, m, ds]
        dots = torch.bmm(rs, books.transpose(1, 2))                    # [S, m, K]
        out.append((c_sq - 2.0 * dots).argmin(dim=2).T.to(torch.uint8))
    return torch.cat(out) if out else torch.zeros((0, s), dtype=torch.uint8, device=rows.device)


def adc_gather_sum(blocks: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The "xla" residual scores: blocks [B, n, C, S] uint8 against tables
    [B, S, K] → [B, n, C] fp32, each table entry gathered and the S terms
    summed by ``torch.sum`` (a library expression, in its own order)."""
    b, n, c, s = blocks.shape
    t = tables[:, None, None].expand(b, n, c, s, tables.shape[2])
    return torch.gather(t, 4, blocks.long()[..., None])[..., 0].sum(dim=3)


def quantize_host_store(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(int8 rows, fp32 scales) of normalised host rows, symmetric per row
    (scale max|x|/127, round half to even): the host re-rank store that
    ``IVFPQIndex.attach_host_store`` takes."""
    scales = np.maximum(np.abs(rows).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    quant = np.clip(np.round(rows / scales[:, None]), -127, 127).astype(np.int8)
    return quant, scales


def probe_step(adc_impl: str, b: int, capacity: int, n_subspaces: int) -> int:
    """Probed lists a chunk of the packed search takes for ``b`` queries over
    lists of ``capacity`` rows: the chunk's transient within
    ``ivf.CHUNK_BYTES``, 17 bytes a row under K7 (``"pallas"``), 8 a
    subspace under the gather-sum. K7 launches once a chunk."""
    return chunk_rows((17 if adc_impl == "pallas" else 8 * n_subspaces) * b * capacity)


class IVFPQIndex:
    """Probed, compressed cosine top-k: ``build`` once, then
    ``search(queries, top_k, nprobe, rerank=, adc_impl=)``."""

    def __init__(self):
        self.centroids = None   # [k, D] fp32
        self.list_rows = None   # [k, C] int32, -1 padded
        self.overflow = None    # [O] int32
        self.codebooks = None   # [S, K, d] fp32 (residual quantizer)
        self.codes = None       # [N, S] uint8
        self._coarse_assign = None  # [N] int32 (overflow scoring)
        self._originals = None  # [N, D] host fp32 (only if kept)
        self._codes_t = None    # [S, N] uint8 scan operand (lazy)
        # packed layout: list i's codes at flat rows [i*C, (i+1)*C), or
        # paired [k*C/2, 2S] (the same bytes; build_device_streamed)
        self.codes_lists = None
        self._paired = False
        self.id_lists = None        # [k*C] int32 corpus row ids, -1 padded
        self.overflow_codes = None  # [O, S] uint8
        self._overflow_assign = None  # [O] int32 coarse centroid per row
        self._overflow_recon = None  # [O, D] cache (the pool GEMM operand)
        self._pool_dtype = None      # None = fp32; streamed builds set bf16
        self._n_rows = 0
        # host int8 exact-rerank store (attach_host_store)
        self._originals_int8 = None
        self._originals_int8_scales = None
        self.rotation = None    # [D, D] fp32 OPQ rotation or None

    @property
    def packed(self) -> bool:
        return self.codes_lists is not None

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def n_rows(self) -> int:
        if self.packed:
            return self._n_rows
        return 0 if self.codes is None else int(self.codes.shape[0])

    @property
    def n_clusters(self) -> int:
        return 0 if self.centroids is None else int(self.centroids.shape[0])

    @property
    def _capacity(self) -> int:
        if self.packed:
            rows = int(self.codes_lists.shape[0]) * (2 if self._paired else 1)
            return rows // self.n_clusters
        return int(self.list_rows.shape[1])

    @property
    def code_bytes(self) -> int:
        if self.packed:
            s = int(self.codes_lists.shape[1])
            return self._n_rows * (s // 2 if self._paired else s)
        return 0 if self.codes is None else int(self.codes.numel())

    @torch.no_grad()
    def build(
        self,
        emb: np.ndarray,
        n_clusters: int,
        n_subspaces: int = 64,
        n_centroids: int = 256,
        capacity_factor: float = 1.5,
        coarse_iters: int = 10,
        pq_iters: int = 10,
        seed: int = 0,
        keep_originals: bool = True,
        spill_choices: int = 4,
        device=None,
    ) -> "IVFPQIndex":
        """Host-corpus build (the unpacked layout). Rows fill their lists in
        corpus order, full-list rows try their next-nearest centroids, the
        rest reach the overflow pool; each row's residual is taken against
        its stored list's centroid (overflow rows: their nearest). Up to
        131,072 rows the codebooks train on all residuals and the codes are
        their final assignments; above, on a strided sample of ≤ 65,536,
        and every row is encoded in chunks."""
        emb = np.asarray(emb, np.float32)
        n, d = emb.shape
        if n_clusters < 1 or n_clusters > n:
            raise ValueError(f"n_clusters={n_clusters} must be in [1, {n}]")
        if d % n_subspaces:
            raise ValueError(f"embed dim {d} not divisible by n_subspaces={n_subspaces}")
        if not 1 <= n_centroids <= 256:
            raise ValueError("n_centroids must be in [1, 256] (uint8 codes)")
        if n_centroids > n:
            raise ValueError(f"n_centroids={n_centroids} > n_rows={n}")
        self._overflow_recon = None
        dev = resolve_device(device)
        x = torch.from_numpy(emb).to(dev)
        cents, assign = kmeans(x, n_clusters, iters=coarse_iters, seed=seed)
        assign_np = assign.cpu().numpy()
        m = max(1, min(spill_choices, n_clusters))
        ranked = rank_clusters(x, cents, m)
        capacity = max(1, int(np.ceil(n / n_clusters * capacity_factor)))
        lists = np.full((n_clusters, capacity), -1, np.int32)
        overflow: list = []
        placement = fill_inverted_lists_multi(ranked, lists, overflow)
        enc_cent = torch.from_numpy(
            np.where(placement >= 0, placement, assign_np).astype(np.int32)
        ).to(dev)
        resid = x - cents[enc_cent.long()]
        if n <= 131_072:
            books, codes = pq_train(resid, n_subspaces, n_centroids, pq_iters,
                                    kmeans_l2_init(n, n_centroids, n_subspaces, seed + 1))
            codes = codes.T.to(torch.uint8)                              # [N, S]
        else:
            stride = -(-n // 65_536)
            sample = resid[::stride]
            books, _ = pq_train(sample, n_subspaces, n_centroids, pq_iters,
                                kmeans_l2_init(sample.shape[0], n_centroids, n_subspaces, seed + 1))
            codes = encode_residuals(x, enc_cent, cents, books)
        self.centroids = cents
        self.list_rows = torch.from_numpy(lists).to(dev)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=dev)
        self.codebooks = books
        self.codes = codes.contiguous()
        self._coarse_assign = enc_cent
        self._originals = emb if keep_originals else None
        self._codes_t = None
        return self

    @torch.no_grad()
    def build_device(
        self,
        x_dev: torch.Tensor,
        n_clusters: int,
        n_subspaces: int = 64,
        n_centroids: int = 256,
        capacity_factor: float = 1.5,
        coarse_iters: int = 10,
        pq_iters: int = 10,
        seed: int = 0,
        train_rows: int = 524_288,
        pq_train_rows: int = 65_536,
        slab_rows: int = 1_000_000,
        row_scales=None,
        packed: bool = True,
        spill_choices: int = 4,
        opq_iters: int = 0,
    ) -> "IVFPQIndex":
        """Build from a corpus on the device: the coarse k-means trains on a
        strided sample of ``train_rows``, the residual codebooks (and OPQ)
        on a sub-sample of ``pq_train_rows`` of its residuals; assignment
        streams slabs, and only the [N, m] choice ranking crosses to the
        host for the list fill. Originals are not kept. ``packed`` (default)
        writes each list's codes contiguously (capacity rounded up to a
        multiple of 8, the JAX layout); ``packed=False`` keeps the row-order
        codes with single-choice placement. ``row_scales``: an int8 corpus's
        per-row scales (rows are dequantized before encoding)."""
        self._overflow_recon = None
        n, d = x_dev.shape
        if d % n_subspaces:
            raise ValueError(f"embed dim {d} not divisible by n_subspaces={n_subspaces}")
        if (x_dev.dtype == torch.int8) != (row_scales is not None):
            raise ValueError("int8 x_dev and row_scales go together")
        dev = x_dev.device
        scales = (
            torch.as_tensor(row_scales, dtype=torch.float32, device=dev)
            if row_scales is not None else torch.ones((n,), dtype=torch.float32, device=dev)
        )
        stride = max(1, n // min(train_rows, n))
        take = min(train_rows, n)
        sample = x_dev[::stride][:take].float() * scales[::stride][:take, None]
        cents, s_assign = kmeans(sample, n_clusters, iters=coarse_iters, seed=seed)
        pq_take = min(pq_train_rows, sample.shape[0])
        pq_stride = max(1, sample.shape[0] // pq_take)
        resid = (sample - cents[s_assign.long()])[::pq_stride][:pq_take]
        del sample
        books, rot = _train_residual_quantizers(
            resid, n_subspaces, n_centroids, pq_iters, opq_iters, seed)
        del resid
        self.rotation = rot

        mc = max(1, min(spill_choices, n_clusters)) if packed else 1
        a_rows = slab_rows if mc == 1 else min(slab_rows, max(8192, (1 << 30) // (4 * n_clusters)))
        ranked = np.concatenate([
            rank_clusters(x_dev[i : i + a_rows].float() * scales[i : i + a_rows, None], cents, mc)
            for i in range(0, n, a_rows)
        ])
        capacity = max(1, int(np.ceil(n / n_clusters * capacity_factor)))
        if packed:
            capacity = (capacity + 7) // 8 * 8
        lists = np.full((n_clusters, capacity), -1, np.int32)
        overflow: list = []
        placement = fill_inverted_lists_multi(ranked, lists, overflow)
        enc_cent = np.where(placement >= 0, placement, ranked[:, 0]).astype(np.int32)

        self.centroids = cents
        self.codebooks = books
        self._originals = None
        self._codes_t = None

        def encode(rows_idx, cent_ids):
            rows = x_dev[rows_idx].float() * scales[rows_idx][:, None]
            return encode_residuals(rows, cent_ids, cents, books, rot)

        if packed:
            k = n_clusters
            ids_flat = torch.from_numpy(lists.reshape(-1)).to(dev)
            buf = torch.zeros((k * capacity, n_subspaces), dtype=torch.uint8, device=dev)
            slot_cent = torch.arange(k, device=dev).repeat_interleave(capacity)
            step = max(1, (64 << 20) // max(1, capacity * d)) * capacity  # slots per chunk
            for lo in range(0, k * capacity, step):
                idc = ids_flat[lo : lo + step].long()
                buf[lo : lo + step] = encode(torch.where(idc >= 0, idc, 0), slot_cent[lo : lo + step])
            self.codes_lists = buf
            self.id_lists = ids_flat
            self._n_rows = n
            self.overflow = torch.tensor(overflow, dtype=torch.int32, device=dev)
            ovf = self.overflow.long()
            oa = torch.from_numpy(enc_cent[np.asarray(overflow, np.int64)]).to(dev)
            self.overflow_codes = encode(ovf, oa)
            self._overflow_assign = oa
            self.codes = None
            self.list_rows = None
            self._coarse_assign = None
            return self

        enc_j = torch.from_numpy(enc_cent).to(dev)
        self.list_rows = torch.from_numpy(lists).to(dev)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=dev)
        self.codes = torch.cat([
            encode(torch.arange(i, min(n, i + slab_rows), device=dev), enc_j[i : i + slab_rows])
            for i in range(0, n, slab_rows)
        ])
        self._coarse_assign = enc_j
        return self

    @torch.no_grad()
    def build_device_streamed(
        self,
        slab_fn,
        n_rows: int,
        d: int,
        n_clusters: int,
        n_subspaces: int = 64,
        n_centroids: int = 256,
        capacity_factor: float = 1.1,
        coarse_iters: int = 6,
        pq_iters: int = 6,
        opq_iters: int = 0,
        seed: int = 0,
        train_rows: int = 524_288,
        pq_train_rows: int = 65_536,
        slab_rows: int = 500_000,
        spill_choices: int = 4,
        assign_sub_rows: int = 25_000,
        progress=None,
    ) -> "IVFPQIndex":
        """Build where the corpus never exists on the device whole:
        ``slab_fn(start, m)`` returns fp32 device rows [m, d] for positions
        [start, start+m), the same each time (it is called up to three times
        per slab). Three streamed passes: (1) a per-slab strided sample
        trains the coarse and residual quantizers; (2) each slab's ranked
        choices (sub-chunks of ``assign_sub_rows``) go to the host list fill;
        (3) each slab is encoded against its rows' stored centroids and the
        codes are packed on the host and uploaded once, paired [k·C/2, 2S].
        The pool's reconstructions are kept in bf16."""
        if d % n_subspaces:
            raise ValueError(f"embed dim {d} not divisible by n_subspaces={n_subspaces}")
        if n_rows < n_clusters:
            raise ValueError(f"n_rows={n_rows} < n_clusters={n_clusters}")
        self._overflow_recon = None
        log = progress or (lambda msg: None)
        n_slabs = (n_rows + slab_rows - 1) // slab_rows

        per_slab = max(1, (min(train_rows, n_rows) + n_slabs - 1) // n_slabs)
        parts = []
        for i in range(n_slabs):
            start = i * slab_rows
            m_i = min(slab_rows, n_rows - start)
            stride = max(1, m_i // per_slab)
            parts.append(slab_fn(start, m_i)[::stride][:per_slab].float())
        sample = torch.cat(parts)
        del parts
        log(f"sample {sample.shape[0]:,} rows; coarse k-means k={n_clusters}")
        cents, s_assign = kmeans(sample, n_clusters, iters=coarse_iters, seed=seed)
        pq_take = min(pq_train_rows, sample.shape[0])
        pq_stride = max(1, sample.shape[0] // pq_take)
        resid = (sample - cents[s_assign.long()])[::pq_stride][:pq_take]
        del sample, s_assign
        books, rot = _train_residual_quantizers(
            resid, n_subspaces, n_centroids, pq_iters, opq_iters, seed)
        del resid
        self.rotation = rot

        mc = max(1, min(spill_choices, n_clusters))
        ranked = np.empty((n_rows, mc), np.int64)
        for i in range(n_slabs):
            start = i * slab_rows
            m_i = min(slab_rows, n_rows - start)
            slab = slab_fn(start, m_i).float()
            ranked[start : start + m_i] = np.concatenate([
                rank_clusters(slab[lo : lo + assign_sub_rows], cents, mc)
                for lo in range(0, m_i, assign_sub_rows)
            ])
            if i % 25 == 0:
                log(f"assign slab {i + 1}/{n_slabs}")
        capacity = max(1, int(np.ceil(n_rows / n_clusters * capacity_factor)))
        capacity = (capacity + 7) // 8 * 8
        lists = np.full((n_clusters, capacity), -1, np.int32)
        overflow: list = []
        placement = fill_inverted_lists_multi(ranked, lists, overflow)
        enc_cent = np.where(placement >= 0, placement, ranked[:, 0]).astype(np.int32)
        del placement, ranked
        ovf = np.asarray(overflow, np.int64)
        o = len(ovf)
        log(f"lists filled: capacity={capacity}, overflow pool {o:,} rows ({o / n_rows:.2%})")

        # each row's destination: its packed slot, or k*C + its pool index
        flat_ids = lists.reshape(-1)
        valid = flat_ids >= 0
        dest = np.full(n_rows, -1, np.int64)
        dest[flat_ids[valid]] = np.flatnonzero(valid)
        kc = n_clusters * capacity
        dest[ovf] = kc + np.arange(o)
        assert (dest >= 0).all(), "every row must have exactly one slot"

        packed_np = np.zeros((kc, n_subspaces), np.uint8)
        pool_np = np.zeros((max(o, 1), n_subspaces), np.uint8)
        for i in range(n_slabs):
            start = i * slab_rows
            m_i = min(slab_rows, n_rows - start)
            ec = torch.from_numpy(enc_cent[start : start + m_i]).to(cents.device)
            codes_np = encode_residuals(slab_fn(start, m_i), ec, cents, books, rot).cpu().numpy()
            dst = dest[start : start + m_i]
            in_main = dst < kc
            packed_np[dst[in_main]] = codes_np[in_main]
            pool_np[dst[~in_main] - kc] = codes_np[~in_main]
            if i % 25 == 0:
                log(f"encode slab {i + 1}/{n_slabs}")

        dev = cents.device
        self.centroids = cents
        self.codebooks = books
        self._pool_dtype = torch.bfloat16
        self.codes_lists = torch.from_numpy(packed_np.reshape(kc // 2, 2 * n_subspaces)).to(dev)
        self._paired = True
        self.id_lists = torch.from_numpy(flat_ids).to(dev)
        self.overflow = torch.from_numpy(ovf.astype(np.int32)).to(dev)
        self.overflow_codes = torch.from_numpy(pool_np[:o]).to(dev)
        self._overflow_assign = torch.from_numpy(enc_cent[ovf]).to(dev)
        self._n_rows = n_rows
        self.codes = None
        self.list_rows = None
        self._coarse_assign = None
        self._originals = None
        self._codes_t = None
        return self

    def attach_host_store(self, rows_int8, scales) -> None:
        """A host-memory int8 row store (+ per-row scales) for the exact
        re-rank where the rows cannot live on the device: ``search(...,
        rerank=R)`` gathers R candidate rows per query from it."""
        rows_int8 = np.asarray(rows_int8)
        scales = np.asarray(scales, np.float32)
        if rows_int8.dtype != np.int8:
            raise ValueError("host store rows must be int8")
        if rows_int8.shape[0] != scales.shape[0]:
            raise ValueError("rows/scales length mismatch")
        self._originals_int8 = rows_int8
        self._originals_int8_scales = scales

    def _encode_new(self, x: torch.Tensor):
        """(nearest centroid [M] int64, codes [M, S] uint8) of new rows with
        the frozen quantizers."""
        assign = (x @ self.centroids.T).argmax(dim=1)
        return assign, encode_residuals(x, assign, self.centroids, self.codebooks, self.rotation)

    @torch.no_grad()
    def append(self, emb_new: np.ndarray) -> np.ndarray:
        """Add rows without retraining: each goes to its nearest centroid's
        list (encoded against it) if a slot is free, else to the overflow
        pool. Returns the new row ids; every row still lives exactly once."""
        if self.codes is None and not self.packed:
            raise ValueError("IVFPQIndex.append before build()")
        emb_new = np.asarray(emb_new, np.float32)
        d = int(self.centroids.shape[1])
        if emb_new.ndim != 2 or emb_new.shape[1] != d:
            raise ValueError(f"append rows must be (M, {d}), got {emb_new.shape}")
        if self.packed:
            return self._append_packed(emb_new)
        start = self.n_rows
        m = len(emb_new)
        x = torch.from_numpy(emb_new).to(self.device)
        assign, codes_new = self._encode_new(x)
        lists = self.list_rows.cpu().numpy().copy()
        overflow = self.overflow.cpu().tolist()
        fill_inverted_lists(assign.cpu().numpy(), lists, overflow, start_row=start)
        self.codes = torch.cat([self.codes, codes_new])
        self.list_rows = torch.from_numpy(lists).to(self.device)
        self.overflow = torch.tensor(overflow, dtype=torch.int32, device=self.device)
        self._coarse_assign = torch.cat([self._coarse_assign, assign.int()])
        if self._originals is not None:
            self._originals = np.concatenate([self._originals, emb_new], axis=0)
        self._codes_t = None
        return np.arange(start, start + m)

    def _append_packed(self, emb_new: np.ndarray) -> np.ndarray:
        """Packed-layout append: codes against each row's nearest centroid
        written into free list slots, the rest (codes and centroid) to the
        overflow pool."""
        if self._paired:
            raise NotImplementedError(
                "append on a paired-layout streamed index is unsupported; that tier "
                "rebuilds (FrameIndex applies its 1.5x rebuild bound)"
            )
        start = self.n_rows
        capacity = self._capacity
        dev = self.device
        x = torch.from_numpy(emb_new).to(dev)
        assign, codes_new = self._encode_new(x)
        assign_np = assign.cpu().numpy()
        fill = (self.id_lists.cpu().numpy().reshape(-1, capacity) >= 0).sum(axis=1)
        slots, placed, spilled = [], [], []
        for i, c in enumerate(assign_np):
            if fill[c] < capacity:
                slots.append(int(c) * capacity + int(fill[c]))
                placed.append(i)
                fill[c] += 1
            else:
                spilled.append(i)
        if placed:
            flat = torch.tensor(slots, device=dev)
            ri = torch.tensor(placed, device=dev)
            self.codes_lists[flat] = codes_new[ri]
            self.id_lists[flat] = (start + ri).int()
        if spilled:
            oi = torch.tensor(spilled, device=dev)
            self.overflow_codes = torch.cat([self.overflow_codes, codes_new[oi]])
            self._overflow_assign = torch.cat([self._overflow_assign, assign[oi].int()])
            self.overflow = torch.cat([self.overflow, (start + oi).int()])
        self._n_rows += len(emb_new)
        return np.arange(start, start + len(emb_new))

    def _pool_recon(self) -> torch.Tensor:
        """PQ reconstructions ``c(x) + r̃(x)`` [O, D] of the overflow rows
        (cached; recomputed when the pool grows): the pool's ADC score
        q·c + Σ_s q_s·book_s[code_s] equals q·(c + r̃) up to the order of
        sums, so every query scores the pool with one GEMM."""
        o = int(self.overflow.shape[0])
        if self._overflow_recon is not None and int(self._overflow_recon.shape[0]) == o:
            return self._overflow_recon
        dtype = self._pool_dtype or torch.float32
        books = self.codebooks.cpu().numpy()
        s, _, ds = books.shape
        if o == 0:
            self._overflow_recon = torch.zeros((0, s * ds), dtype=dtype, device=self.device)
            return self._overflow_recon
        codes = self.overflow_codes.cpu().numpy().astype(np.int64)
        resid = books[np.arange(s)[None, :], codes, :].reshape(o, s * ds)
        if self.rotation is not None:
            resid = resid @ self.rotation.cpu().numpy().T  # codes live in the rotated basis
        recon = (
            self.centroids.cpu().numpy()[self._overflow_assign.cpu().numpy()] + resid
        ).astype(np.float32)
        self._overflow_recon = torch.from_numpy(recon).to(self.device).to(dtype)
        return self._overflow_recon

    @staticmethod
    def _probe_adc_search(q, q_adc, cents, list_rows, overflow, coarse_assign, books, codes_t,
                          top_k: int, nprobe: int):
        """Unpacked layout: candidates are the probed lists' row ids (and
        the pool's); score = the row's own centroid score + its ADC residual,
        summed over subspaces in order, one [B, M] gather per subspace."""
        b = q.shape[0]
        tables = adc_tables(q_adc, books)                             # [B, S, K]
        cscores, _, cids = probe_lists(q, cents, nprobe)
        cand = list_rows[cids].reshape(b, -1).long()                  # [B, n*C]
        coarse = torch.gather(cscores, 1, cids).repeat_interleave(list_rows.shape[1], dim=1)
        if overflow.shape[0]:
            ovf = overflow.long()
            cand = torch.cat([cand, ovf[None].expand(b, -1)], dim=1)
            coarse = torch.cat([coarse, cscores[:, coarse_assign[ovf].long()]], dim=1)
        valid = cand >= 0
        safe = torch.where(valid, cand, 0)
        resid = torch.zeros(cand.shape, dtype=torch.float32, device=q.device)
        for s in range(books.shape[0]):
            resid = resid + torch.gather(tables[:, s], 1, codes_t[s][safe].long())
        scores = torch.where(valid, coarse + resid, -torch.inf)
        return merge_candidates(scores, cand, top_k)

    @staticmethod
    def _probe_adc_search_packed(q, q_adc, cents, books, codes_lists, id_lists, overflow_recon,
                                 overflow_ids, top_k: int, nprobe: int, capacity: int,
                                 adc_impl: str = "xla"):
        """Packed layout: each probed list is one contiguous [C, S] code
        block, its residual scores from K7 (``"pallas"``) or the gather-sum
        (``"xla"``), plus the probed centroid's score; padding slots −inf;
        the pool as one GEMM against its reconstructions. Probes go a chunk
        at a time, the chunk's transient within ``ivf.CHUNK_BYTES``: K7
        reads the lists where they lie (``codes_lists`` viewed as [k, C, S])
        at the chunk's list ids, one launch a chunk, and a chunk holds 17
        bytes a row (K7's fp32 scores, the rows' int32 ids, their validity
        mask, the fp32 sum with the centroid scores and its masked copy); the
        gather-sum gathers the chunk's codes and indexes them with int64."""
        b = q.shape[0]
        s = books.shape[0]
        k = cents.shape[0]
        tables = adc_tables(q_adc, books)                             # [B, S, K]
        _, cvals, cids = probe_lists(q, cents, nprobe)
        blocks_all = codes_lists.view(k, capacity, s)                 # paired: the same bytes
        ids_all = id_lists.view(k, capacity)
        step = probe_step(adc_impl, b, capacity, s)
        sco, ids = [], []
        for lo in range(0, nprobe, step):
            c = cids[:, lo : lo + step]                                # [B, n]
            n = c.shape[1]
            if adc_impl == "pallas":
                resid = adc_probe_scores(blocks_all, c, tables)        # [B, n, C]
            else:
                resid = adc_gather_sum(blocks_all[c], tables)
            i = ids_all[c]
            sco.append(torch.where(i >= 0, resid + cvals[:, lo : lo + n, None], -torch.inf))
            ids.append(i)
        scores = torch.cat(sco, dim=1).reshape(b, -1)
        ids = torch.cat(ids, dim=1).reshape(b, -1).long()
        if overflow_ids.shape[0]:
            ovf = q.to(overflow_recon.dtype).float() @ overflow_recon.float().T   # [B, O]
            ovf = torch.where(overflow_ids[None] >= 0, ovf, -torch.inf)
            scores = torch.cat([scores, ovf], dim=1)
            ids = torch.cat([ids, overflow_ids.long()[None].expand(b, -1)], dim=1)
        return merge_candidates(scores, ids, top_k)

    def search(self, queries: np.ndarray, top_k: int, nprobe: int, rerank: int | None = None,
               adc_impl: str = "auto"):
        """(scores [B, k], row ids [B, k]); unreachable slots are (−inf, −1).
        Without ``rerank`` the scores are the ADC approximation q·c + q̃·r̃;
        with it, exact cosines of the best ``rerank`` candidates re-scored on
        the host (fp32 originals or the int8 host store). ``adc_impl``:
        "xla" (the gather-sum), "pallas" (kernel K7 on the card, its plain
        version on the CPU) or "auto" (= "xla"); the unpacked layout uses
        neither."""
        if self.codes is None and not self.packed:
            raise ValueError("IVFPQIndex.search before build()")
        if rerank is not None and self._originals is None and self._originals_int8 is None:
            raise ValueError(
                "rerank requires keep_originals=True at build or an attach_host_store() "
                "int8 row store"
            )
        if adc_impl not in ADC_IMPLS:
            raise ValueError(f"unknown adc_impl {adc_impl!r}")
        if adc_impl == "auto":
            adc_impl = "xla"
        nprobe = max(1, min(nprobe, self.n_clusters))
        qn = np.atleast_2d(np.asarray(queries, np.float32))
        cap = self._capacity * nprobe + int(self.overflow.shape[0])
        fetch = max(1, min(top_k if rerank is None else max(top_k, rerank), cap, self.n_rows))
        with torch.no_grad():
            q = torch.from_numpy(qn).to(self.device)
            q_adc = q if self.rotation is None else q @ self.rotation
            if self.packed:
                scores, rows = self._probe_adc_search_packed(
                    q, q_adc, self.centroids, self.codebooks, self.codes_lists, self.id_lists,
                    self._pool_recon(), self.overflow, fetch, nprobe, self._capacity, adc_impl,
                )
            else:
                if self._codes_t is None:
                    self._codes_t = self.codes.T.contiguous()
                scores, rows = self._probe_adc_search(
                    q, q_adc, self.centroids, self.list_rows, self.overflow,
                    self._coarse_assign, self.codebooks, self._codes_t, fetch, nprobe,
                )
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        rows = np.where(np.isfinite(scores), rows, -1)
        if rerank is None:
            k = min(top_k, fetch)
            return scores[:, :k], rows[:, :k]
        safe_rows = np.where(rows >= 0, rows, 0)
        if self._originals is not None:
            cand = self._originals[safe_rows]                          # [B, R, D]
        else:
            cand = self._originals_int8[safe_rows].astype(np.float32)
            cand *= self._originals_int8_scales[safe_rows][:, :, None]
        exact = np.einsum("bd,brd->br", qn, cand).astype(np.float32)
        exact = np.where(rows >= 0, exact, -np.inf)
        k = min(top_k, exact.shape[1])
        order = np.argsort(-exact, axis=1)[:, :k]
        out_rows = np.take_along_axis(rows, order, axis=1)
        out_scores = np.take_along_axis(exact, order, axis=1)
        return out_scores, np.where(np.isfinite(out_scores), out_rows, -1)

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        if self.packed:
            arrs = dict(
                centroids=to_numpy(self.centroids),
                codebooks=to_numpy(self.codebooks),
                codes_lists=to_numpy(self.codes_lists),
                id_lists=to_numpy(self.id_lists),
                overflow=to_numpy(self.overflow),
                overflow_codes=to_numpy(self.overflow_codes),
                overflow_assign=to_numpy(self._overflow_assign),
                n_rows=np.int64(self._n_rows),
            )
            if self.rotation is not None:
                arrs["rotation"] = to_numpy(self.rotation)
            if self._paired:
                arrs["paired"] = np.bool_(True)
            if self._pool_dtype == torch.bfloat16:
                arrs["pool_bf16"] = np.bool_(True)
        else:
            arrs = dict(
                centroids=to_numpy(self.centroids),
                list_rows=to_numpy(self.list_rows),
                overflow=to_numpy(self.overflow),
                codebooks=to_numpy(self.codebooks),
                codes=to_numpy(self.codes),
                coarse_assign=to_numpy(self._coarse_assign),
            )
            if self._originals is not None:
                arrs["originals"] = self._originals
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path, device=None) -> "IVFPQIndex":
        dev = resolve_device(device)
        z = np.load(path)
        idx = cls()
        idx.centroids = from_numpy(z["centroids"], dev)
        idx.codebooks = from_numpy(z["codebooks"], dev)
        idx.overflow = from_numpy(z["overflow"].astype(np.int32), dev)
        if "rotation" in z.files:
            idx.rotation = from_numpy(z["rotation"], dev)
        if "codes_lists" in z.files:
            idx.codes_lists = from_numpy(z["codes_lists"], dev)
            idx._paired = bool(z["paired"]) if "paired" in z.files else False
            if "pool_bf16" in z.files and bool(z["pool_bf16"]):
                idx._pool_dtype = torch.bfloat16
            idx.id_lists = from_numpy(z["id_lists"], dev)
            idx.overflow_codes = from_numpy(z["overflow_codes"], dev)
            idx._overflow_assign = from_numpy(z["overflow_assign"].astype(np.int32), dev)
            idx._n_rows = int(z["n_rows"])
            return idx
        idx.list_rows = from_numpy(z["list_rows"], dev)
        idx.codes = from_numpy(z["codes"], dev)
        idx._coarse_assign = from_numpy(z["coarse_assign"], dev)
        idx._originals = z["originals"] if "originals" in z.files else None
        return idx
