"""UMAP in PyTorch: the algorithm itself, on the card.

Counterpart of ``evr_tpu/viz/umap_jax.py`` (McInnes et al. 2018,
arXiv:1802.03426), stage for stage:

* kNN graph: one [N, D] @ [D, N] product and the k smallest distances by a
  stable sort (lower index first on ties, as ``lax.top_k``; ``torch.topk``
  promises no order among ties);
* fuzzy simplicial set: per-row smooth-kNN calibration (rho the nearest
  distance, sigma bisected 64 times in fp32 so Σ exp(-(d-rho)/sigma) =
  log2(k)), then the probabilistic t-conorm ``W + Wᵀ − W∘Wᵀ``;
* spectral initialisation from the symmetric-normalised graph Laplacian
  (host float64, as in the JAX package);
* above ``dense_threshold`` points: the chunked kNN, the COO edge set and a
  PCA initialisation, with no [N, N] array;
* layout: negative-sampling SGD epochs, every edge's gradient each epoch
  scaled by its membership weight.

The epoch's scatters sum in a fixed order: the edges are sorted by head (and
by tail) once, and ``torch.segment_reduce`` sums each point's edges one after
another, so one seed gives the same layout twice on the card (an
``index_add_`` sums by atomics there). The negatives come from a
``torch.Generator`` seeded with ``random_state``; ``jax.random`` draws
others, so with negatives the layout matches the JAX package's in quality,
not in coordinates. With ``negative_sample_rate=0`` both are deterministic,
and each epoch from the same layout lands within 1e-4 of JAX's in plain
fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.utils.device import resolve_device


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1) -> tuple[float, float]:
    """Fit the output kernel 1/(1 + a·d^{2b}) to the target membership curve
    (1 for d ≤ min_dist, exp(-(d-min_dist)/spread) beyond), as umap-learn's
    ``find_ab_params`` does."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def _smallest_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices, distances) of each row's k smallest, lower index first on ties."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return idx[:, :k], vals[:, :k].clamp_min(0.0)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def knn_graph(x: torch.Tensor, k: int, metric: str = "cosine"):
    """Exact kNN by one GEMM: (indices [N, k], distances [N, k]), self
    excluded, ascending distance; cosine distance = 1 − cosine similarity."""
    x = x.float()
    if metric == "cosine":
        xn = _unit_rows(x)
        d = 1.0 - xn @ xn.T
    else:  # euclidean
        sq = (x * x).sum(dim=1)
        d = torch.sqrt((sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0))
    n = d.shape[0]
    d = d + torch.eye(n, device=d.device) * 1e9  # exclude self
    return _smallest_k(d, k)


def smooth_knn_weights(dists: torch.Tensor, n_iter: int = 64) -> torch.Tensor:
    """Per-row smooth-kNN calibration: rho_i the nearest distance, sigma_i
    bisected so Σ_j exp(-max(0, d_ij − rho_i)/sigma_i) = log2(k). Membership
    weights [N, k] in (0, 1]."""
    n, k = dists.shape
    target = torch.log2(torch.tensor(float(k), device=dists.device))
    adj = (dists - dists[:, 0:1]).clamp_min(0.0)
    sigma = torch.ones(n, device=dists.device)
    lo = torch.zeros(n, device=dists.device)
    hi = torch.full((n,), float("inf"), device=dists.device)
    for _ in range(n_iter):
        too_high = torch.exp(-adj / sigma[:, None]).sum(dim=1) > target  # shrink sigma
        hi = torch.where(too_high, sigma, hi)
        lo = torch.where(too_high, lo, sigma)
        sigma = torch.where(torch.isinf(hi), sigma * 2.0, (lo + hi) / 2.0)
    return torch.exp(-adj / sigma.clamp_min(1e-10)[:, None])


def fuzzy_simplicial_set(x: np.ndarray, n_neighbors: int, metric: str = "cosine",
                         device=None) -> np.ndarray:
    """The dense symmetrised membership matrix W [N, N] (probabilistic
    t-conorm of the directed weights)."""
    dev = resolve_device(device)
    n = len(x)
    k = max(1, min(n_neighbors, n - 1))
    idx, dists = knn_graph(torch.as_tensor(np.asarray(x, np.float32), device=dev), k, metric=metric)
    w = smooth_knn_weights(dists)
    dense = torch.zeros((n, n), device=dev)
    # a row's k neighbours are distinct, so no (row, col) pair repeats
    dense[torch.arange(n, device=dev).repeat_interleave(k), idx.reshape(-1)] = w.reshape(-1)
    return (dense + dense.T - dense * dense.T).cpu().numpy()


def spectral_init(w: np.ndarray, n_components: int = 2, random_state: int = 42):
    """Symmetric-normalised Laplacian eigenvectors 1..n_components (the
    smallest non-trivial), scaled to the ±10 box umap-learn starts in; tiny
    seeded jitter breaks eigenvector ties."""
    n = len(w)
    deg = np.maximum(w.sum(axis=1), 1e-12)
    d_inv_sqrt = 1.0 / np.sqrt(deg)
    lap = np.eye(n) - (d_inv_sqrt[:, None] * w * d_inv_sqrt[None, :])
    _, vecs = np.linalg.eigh(lap.astype(np.float64))
    comps = min(n_components, max(1, n - 1))
    y = vecs[:, 1 : 1 + comps].astype(np.float32)
    if y.shape[1] < n_components:
        y = np.pad(y, ((0, 0), (0, n_components - y.shape[1])))
    scale = np.abs(y).max() or 1.0
    y = y / scale * 10.0
    rng = np.random.default_rng(random_state)
    return y + rng.normal(scale=1e-4, size=y.shape).astype(np.float32)


def _knn_chunked(x: torch.Tensor, k: int, chunk: int, metric: str):
    """Exact kNN without the [N, N] distance matrix: per chunk of query rows
    one [chunk, N] GEMM and its k smallest."""
    x = x.float()
    n = x.shape[0]
    xn = _unit_rows(x) if metric == "cosine" else x
    sq = (xn * xn).sum(dim=1)
    cols = torch.arange(n, device=x.device)
    idx, dists = [], []
    for start in range(0, n, chunk):
        q = xn[start:start + chunk]
        if metric == "cosine":
            d = 1.0 - q @ xn.T
        else:
            qsq = (q * q).sum(dim=1)
            d = torch.sqrt((qsq[:, None] + sq[None, :] - 2.0 * (q @ xn.T)).clamp_min(0.0))
        rows = start + torch.arange(q.shape[0], device=x.device)
        d = d + (rows[:, None] == cols[None, :]) * 1e9  # self
        i, v = _smallest_k(d, k)
        idx.append(i)
        dists.append(v)
    return torch.cat(idx), torch.cat(dists)


def fuzzy_simplicial_set_edges(x: np.ndarray, n_neighbors: int, metric: str = "cosine",
                               chunk: int = 2048, device=None):
    """Sparse COO construction of ``fuzzy_simplicial_set``'s graph, without
    an [N, N] array: (heads [E], tails [E], weights [E]) covering both
    directions of every edge, the edge set ``np.nonzero(W)`` gives."""
    dev = resolve_device(device)
    n = len(x)
    k = max(1, min(n_neighbors, n - 1))
    idx, dists = _knn_chunked(torch.as_tensor(np.asarray(x, np.float32), device=dev), k,
                              min(chunk, n), metric)
    w = smooth_knn_weights(dists).cpu().numpy().reshape(-1)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.cpu().numpy().astype(np.int64).reshape(-1)
    # duplicate directed edges collapse to one (a row's neighbours are distinct)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key_s, rows_s, cols_s, w_s = key[order], rows[order], cols[order], w[order]
    first = np.ones(len(key_s), bool)
    first[1:] = key_s[1:] != key_s[:-1]
    key_u, a_u, b_u, w_u = key_s[first], rows_s[first], cols_s[first], w_s[first]
    # the weight of (b, a) in the directed set, 0 when absent
    rev_key = b_u * n + a_u
    pos = np.minimum(np.searchsorted(key_u, rev_key), len(key_u) - 1)
    has_rev = key_u[pos] == rev_key
    w_rev = np.where(has_rev, w_u[pos], 0.0)
    sym = w_u + w_rev - w_u * w_rev
    # both directions: every directed edge emits (a, b); one whose reverse is
    # not a kNN edge also emits (b, a) with the same weight
    miss = ~has_rev
    heads = np.concatenate([a_u, b_u[miss]])
    tails = np.concatenate([b_u, a_u[miss]])
    weights = np.concatenate([sym, sym[miss]]).astype(np.float32)
    return heads.astype(np.int32), tails.astype(np.int32), weights


def pca_init(x: np.ndarray, n_components: int = 2, random_state: int = 42,
             device=None) -> np.ndarray:
    """PCA start for the sparse tier (the spectral start needs an [N, N]
    eigendecomposition): the [D, D] covariance by one GEMM, a host eigh."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    xc = torch.as_tensor(x - x.mean(axis=0, keepdims=True), device=dev)
    cov = (xc.T @ xc).cpu().numpy()
    _, vecs = np.linalg.eigh(cov.astype(np.float64))
    comps = vecs[:, -n_components:][:, ::-1].astype(np.float32)
    y = (xc @ torch.as_tensor(np.ascontiguousarray(comps), device=dev)).cpu().numpy()
    scale = np.abs(y).max() or 1.0
    y = y / scale * 10.0
    rng = np.random.default_rng(random_state)
    return (y + rng.normal(scale=1e-4, size=y.shape)).astype(np.float32)


class _SegmentSum:
    """Sum rows of an [E, ...] array into n points by an index, in a fixed
    order: the edges sorted by index once, each point's run summed in turn."""

    def __init__(self, index: torch.Tensor, n: int):
        self.order = torch.sort(index, stable=True).indices
        self.lengths = torch.bincount(index, minlength=n)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(values[self.order], "sum", lengths=self.lengths, axis=0,
                                    unsafe=True, initial=0.0)


def optimize_layout(
    y0,
    heads,
    tails,
    weights,
    generator: torch.Generator | None,
    a: float,
    b: float,
    n_epochs: int = 200,
    negative_sample_rate: int = 5,
    initial_alpha: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Negative-sampling SGD layout. Per epoch: the attractive gradient of
    every edge scaled by its membership weight (the expected gradient of
    umap-learn's sample-every-1/w-epochs scheme; the per-edge ±4 clip and the
    annealed rate carry over), moving both ends, plus ``negative_sample_rate``
    uniform negatives per edge pushing its head away. ``generator`` draws
    the negatives (on the layout's device); it may be None at rate 0."""
    dev = resolve_device(device)
    y = torch.tensor(np.asarray(y0, np.float32), device=dev)
    heads = torch.as_tensor(heads, device=dev).long()
    tails = torch.as_tensor(tails, device=dev).long()
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)[:, None]
    n, e = y.shape[0], heads.shape[0]
    by_head, by_tail = _SegmentSum(heads, n), _SegmentSum(tails, n)

    a, b = float(a), float(b)

    def attract_grad(yh, yt):
        # dCE/dy_h = (−2ab·d^{2(b−1)}) / (1 + a·d^{2b}) · (y_h − y_t)
        d2 = ((yh - yt) ** 2).sum(dim=1, keepdim=True).clamp_min(1e-12)
        coef = (-2.0 * a * b * d2.pow(b - 1.0)) / (1.0 + a * d2.pow(b))
        return (coef * (yh - yt)).clamp(-4.0, 4.0)

    def repulse_grad(yh, yt):
        d2 = ((yh - yt) ** 2).sum(dim=-1, keepdim=True)
        coef = (2.0 * b) / ((0.001 + d2) * (1.0 + a * d2.clamp_min(1e-12).pow(b)))
        return (coef * (yh - yt)).clamp(-4.0, 4.0)

    for epoch in range(n_epochs):
        alpha = initial_alpha * (1.0 - epoch / n_epochs)
        yh, yt = y[heads], y[tails]
        g_att = attract_grad(yh, yt) * w
        upd = by_head(g_att) - by_tail(g_att)
        if negative_sample_rate > 0:
            neg = torch.randint(0, n, (e, negative_sample_rate), generator=generator, device=dev)
            g_rep = repulse_grad(yh[:, None, :], y[neg]).sum(dim=1) * w
            upd = upd + by_head(g_rep)
        y = y + alpha * upd
    return y - y.mean(dim=0, keepdim=True)


def umap(
    embeddings: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    spread: float = 1.0,
    metric: str = "cosine",
    n_epochs: int | None = None,
    negative_sample_rate: int = 5,
    random_state: int = 42,
    dense_threshold: int = 4096,
    device=None,
) -> np.ndarray:
    """UMAP on the card: [N, D] → [N, n_components].

    ``n_epochs=None`` follows umap-learn: 500 epochs up to 10k points, 200
    beyond. Above ``dense_threshold`` points the graph comes from the sparse
    COO tier with a PCA start; the layout optimiser is the same."""
    dev = resolve_device(device)
    x = np.asarray(embeddings, np.float32)
    n = len(x)
    if n <= 2:  # nothing to optimise
        return np.zeros((n, n_components), np.float32)
    if n_epochs is None:
        n_epochs = 500 if n <= 10_000 else 200
    a, b = find_ab_params(spread, min_dist)
    if n <= dense_threshold:
        w = fuzzy_simplicial_set(x, n_neighbors, metric=metric, device=dev)
        y0 = spectral_init(w, n_components, random_state)
        heads, tails = np.nonzero(w)
        weights = w[heads, tails].astype(np.float32)
    else:
        heads, tails, weights = fuzzy_simplicial_set_edges(x, n_neighbors, metric=metric, device=dev)
        y0 = pca_init(x, n_components, random_state, device=dev)
    gen = torch.Generator(device=dev).manual_seed(random_state)
    y = optimize_layout(y0, heads, tails, weights, gen, a, b, n_epochs=n_epochs,
                        negative_sample_rate=negative_sample_rate, device=dev)
    return y.cpu().numpy()
