"""Product-quantized (PQ) cosine retrieval: the memory tier (PyTorch).

Counterpart of ``evr_tpu/index/pq.py``. Each row is stored as S uint8
centroid codes (one per subspace of D/S dimensions); a query is scored
against the codes without reconstructing rows, by asymmetric distance
computation (ADC): the per-query [S, K] inner-product table, summed over
subspaces in order (a [B, N] accumulator, never [B, N, S]). An optional
exact host re-rank re-scores the top-R candidates against originals kept in
host memory. OPQ (Ge et al., CVPR 2013) learns an orthogonal rotation by
alternating PQ training and a Procrustes update (a [D, D] host SVD).

k-means here is Euclidean (``kmeans_l2``); its initial centroids come from a
``torch.Generator`` (the JAX package draws them with ``jax.random``), and
``kmeans_l2_from_init`` runs the same Lloyd's iterations as the JAX package
from given centroids, batched over a leading subspace axis. Cluster sums are
one-hot GEMMs in a fixed order, so a seeded build repeats on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.ops.topk import _ordered_topk
from evr_tpu_torch.utils.device import resolve_device

from .ivf import chunk_rows, from_numpy, to_numpy


def kmeans_l2_init(n: int, n_centroids: int, count: int, seed: int) -> torch.Tensor:
    """[count, n_centroids] int64 initial-centroid row indices, one draw of
    distinct rows per subspace, in order, from one generator seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(n, generator=gen)[:n_centroids] for _ in range(count)])


def l2_assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """argmin_k ||x − c_k||² = argmin_k (|c_k|² − 2 x·c_k), batched over a
    leading axis: x [S, N, d], cents [S, K, d] → [S, N] int64, in row
    chunks."""
    c_sq = cents.square().sum(dim=2)[:, None, :]                    # [S, 1, K]
    step = chunk_rows(4 * cents.shape[0] * cents.shape[1])
    return torch.cat([
        (c_sq - 2.0 * torch.bmm(x[:, lo : lo + step], cents.transpose(1, 2))).argmin(dim=2)
        for lo in range(0, x.shape[1], step)
    ], dim=1)


def kmeans_l2_from_init(x: torch.Tensor, init: torch.Tensor, iters: int = 10):
    """Euclidean Lloyd's iterations from centroids ``init``: x [N, d] with
    init [K, d], or batched x [S, N, d] with init [S, K, d]. The update is
    the mean of each cluster (one-hot GEMMs over row chunks); an empty
    cluster keeps its centroid. Returns (centroids, assignments int32)."""
    single = x.dim() == 2
    if single:
        x, init = x[None], init[None]
    x = x.float()
    cents = init.float().clone()
    s, k = cents.shape[:2]
    step = chunk_rows(4 * s * k)
    for _ in range(iters):
        a = l2_assign(x, cents)
        sums = torch.zeros_like(cents)
        counts = torch.zeros((s, k), dtype=torch.float32, device=x.device)
        for lo in range(0, x.shape[1], step):
            oh = torch.nn.functional.one_hot(a[:, lo : lo + step], k).float()  # [S, m, K]
            sums += torch.bmm(oh.transpose(1, 2), x[:, lo : lo + step])
            counts += oh.sum(dim=1)
        fresh = sums / counts.clamp_min(1.0)[..., None]
        cents = torch.where(counts[..., None] > 0, fresh, cents)
    a = l2_assign(x, cents).int()
    return (cents[0], a[0]) if single else (cents, a)


def kmeans_l2(x: torch.Tensor, n_centroids: int, iters: int = 10, seed: int = 0):
    """Euclidean k-means of x [N, d] (or batched [S, N, d]) on its device."""
    batched = x if x.dim() == 3 else x[None]
    idx = kmeans_l2_init(batched.shape[1], n_centroids, batched.shape[0], seed).to(x.device)
    init = torch.gather(batched, 1, idx[:, :, None].expand(-1, -1, batched.shape[2]))
    cents, a = kmeans_l2_from_init(batched, init, iters)
    return (cents, a) if x.dim() == 3 else (cents[0], a[0])


def adc_tables(q: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """[B, S, K] fp32 inner products of each query's subvectors with the
    codebooks [S, K, d]."""
    s, _, ds = books.shape
    return torch.einsum("bsd,skd->bsk", q.float().reshape(q.shape[0], s, ds), books)


def pq_train(x: torch.Tensor, n_subspaces: int, n_centroids: int, iters: int, init_idx):
    """(codebooks [S, K, d], codes [S, N] int32) of rows x [N, D] split into
    subspaces, from the initial rows ``init_idx`` [S, K]."""
    n, d = x.shape
    xs = x.reshape(n, n_subspaces, d // n_subspaces).transpose(0, 1).contiguous()
    init = torch.gather(xs, 1, init_idx.to(x.device)[:, :, None].expand(-1, -1, xs.shape[2]))
    return kmeans_l2_from_init(xs, init, iters)


class PQIndex:
    """ADC cosine top-k over uint8 PQ codes. Resident: codebooks [S, K, d]
    fp32 and codes [N, S] uint8 (and an OPQ rotation [D, D])."""

    def __init__(self):
        self.codebooks = None   # [S, K, d] fp32
        self.codes = None       # [N, S] uint8
        self.rotation = None    # [D, D] fp32 (OPQ only)
        self._originals = None  # [N, D] host np.float32 (only if kept)
        self._codes_t = None    # [S, N] uint8, the scan operand (lazy)

    @property
    def n_rows(self) -> int:
        return 0 if self.codes is None else int(self.codes.shape[0])

    @property
    def code_bytes(self) -> int:
        """Device bytes of the code matrix."""
        return 0 if self.codes is None else int(self.codes.numel())

    @torch.no_grad()
    def build(
        self,
        emb: np.ndarray,
        n_subspaces: int = 64,
        n_centroids: int = 256,
        iters: int = 10,
        seed: int = 0,
        keep_originals: bool = True,
        opq_iters: int = 0,
        device=None,
    ) -> "PQIndex":
        """``opq_iters > 0`` enables OPQ: alternate (a) training PQ on the
        rotated rows with half the iterations and (b) the Procrustes update
        of R from the host SVD of embᵀ·recon; R = I is plain PQ."""
        emb = np.asarray(emb, np.float32)
        n, d = emb.shape
        if d % n_subspaces:
            raise ValueError(f"embed dim {d} not divisible by n_subspaces={n_subspaces}")
        if not 1 <= n_centroids <= 256:
            raise ValueError("n_centroids must be in [1, 256] (uint8 codes)")
        if n_centroids > n:
            raise ValueError(f"n_centroids={n_centroids} > n_rows={n}")
        dev = resolve_device(device)
        init_idx = kmeans_l2_init(n, n_centroids, n_subspaces, seed)

        def train(x_np, kmeans_iters):
            return pq_train(torch.from_numpy(x_np).to(dev), n_subspaces, n_centroids,
                            kmeans_iters, init_idx)

        rot = None
        x = emb
        if opq_iters > 0:
            rot = np.eye(d, dtype=np.float32)
            inner = max(2, iters // 2)
            for _ in range(opq_iters):
                cents, assign = train(emb @ rot, inner)
                recon = _decode_np(cents.cpu().numpy(), assign.T.cpu().numpy())
                # argmin over orthogonal R of ||emb R − recon||: U Vᵀ of SVD(embᵀ recon)
                u, _, vt = np.linalg.svd(emb.T @ recon)
                rot = (u @ vt).astype(np.float32)
            x = emb @ rot
        cents, assign = train(x, iters)
        self.codebooks = cents
        self.codes = assign.T.to(torch.uint8).contiguous()
        self.rotation = torch.from_numpy(rot).to(dev) if rot is not None else None
        self._originals = emb if keep_originals else None
        self._codes_t = None
        return self

    @staticmethod
    def _adc_search(q, books, codes_t, top_k: int):
        """ADC scores summed over subspaces in order, then the top-k."""
        tables = adc_tables(q, books)                                   # [B, S, K]
        acc = torch.zeros((q.shape[0], codes_t.shape[1]), dtype=torch.float32, device=q.device)
        for s in range(books.shape[0]):
            acc = acc + tables[:, s, codes_t[s].long()]
        return _ordered_topk(acc, top_k)

    def search(self, queries: np.ndarray, top_k: int, rerank: int | None = None):
        """(scores [B, k], row ids [B, k]): ADC scores, or with ``rerank``
        exact cosines of the best ``rerank`` ADC candidates re-scored against
        the retained originals (``keep_originals=True``)."""
        if self.codes is None:
            raise ValueError("PQIndex.search before build()")
        q = np.atleast_2d(np.asarray(queries, np.float32))
        top_k = max(1, min(top_k, self.n_rows))
        if rerank is not None and self._originals is None:
            raise ValueError("rerank requires keep_originals=True at build")
        fetch = top_k if rerank is None else max(top_k, min(rerank, self.n_rows))
        if self._codes_t is None:
            self._codes_t = self.codes.T.contiguous()
        with torch.no_grad():
            q_dev = torch.from_numpy(q).to(self.codes.device)
            if self.rotation is not None:
                q_dev = q_dev @ self.rotation  # codes live in the rotated basis
            scores, rows = self._adc_search(q_dev, self.codebooks, self._codes_t, fetch)
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        if rerank is None:
            return scores[:, :top_k], rows[:, :top_k]
        cand = self._originals[rows]                                    # [B, R, D]
        exact = np.einsum("bd,brd->br", q, cand).astype(np.float32)
        order = np.argsort(-exact, axis=1)[:, :top_k]
        return np.take_along_axis(exact, order, axis=1), np.take_along_axis(rows, order, axis=1)

    def reconstruct(self, rows: np.ndarray) -> np.ndarray:
        """Decoded rows (OPQ codes decode in the rotated basis and are
        rotated back)."""
        out = _decode_np(self.codebooks.cpu().numpy(), self.codes.cpu().numpy()[np.asarray(rows)])
        if self.rotation is not None:
            out = out @ self.rotation.cpu().numpy().T
        return out

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        arrs = {"codebooks": to_numpy(self.codebooks), "codes": to_numpy(self.codes)}
        if self.rotation is not None:
            arrs["rotation"] = to_numpy(self.rotation)
        if self._originals is not None:
            arrs["originals"] = self._originals
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path, device=None) -> "PQIndex":
        dev = resolve_device(device)
        z = np.load(path)
        idx = cls()
        idx.codebooks = from_numpy(z["codebooks"], dev)
        idx.codes = from_numpy(z["codes"], dev)
        idx.rotation = from_numpy(z["rotation"], dev) if "rotation" in z.files else None
        idx._originals = z["originals"] if "originals" in z.files else None
        return idx


def _decode_np(books: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """[S, K, d] codebooks + [..., S] codes → [..., S*d] reconstruction."""
    parts = books[np.arange(books.shape[0]), codes]
    return parts.reshape(*codes.shape[:-1], -1)
