"""Exact t-SNE in PyTorch: a 2-D projection on the card.

Counterpart of ``evr_tpu/viz/tsne_jax.py``: exact (O(N²)) t-SNE, per-row
bandwidths by 40 vectorised bisection steps, then the gradient loop with
early exaggeration and momentum. The start comes from numpy's seeded
generator, as in the JAX package, so both give the same layout for one seed.
Exact t-SNE is practical to about 20k points ([N, N] arrays).

Used through ``viz.projection.project_embeddings(method="tsne_jax")``.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.utils.device import resolve_device


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(dim=1)
    return (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)


def _calibrate_p(d2: torch.Tensor, perplexity: float, n_iter: int = 40) -> torch.Tensor:
    """Per-row bandwidths by bisection so each row's entropy is log(perplexity);
    the symmetrised joint probabilities."""
    n = d2.shape[0]
    target = torch.log(torch.tensor(perplexity, device=d2.device))
    off_diag = ~torch.eye(n, dtype=torch.bool, device=d2.device)

    def row_entropy(beta):
        logits = torch.where(off_diag, -d2 * beta[:, None], float("-inf"))
        logp = torch.log_softmax(logits, dim=1)
        p = torch.exp(logp)
        h = -torch.where(p > 0, p * logp, 0.0).sum(dim=1)
        return h, p

    beta = torch.ones(n, device=d2.device)
    lo = torch.zeros(n, device=d2.device)
    hi = torch.full((n,), float("inf"), device=d2.device)
    for _ in range(n_iter):
        too_high = row_entropy(beta)[0] > target  # entropy too high: raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    p = row_entropy(beta)[1]
    return ((p + p.T) / (2.0 * n)).clamp_min(1e-12)


def _tsne_optimize(
    p: torch.Tensor,
    y0: torch.Tensor,
    n_iter: int = 400,
    exaggeration_iters: int = 100,
    learning_rate: float = 100.0,
    momentum: float = 0.8,
    exaggeration: float = 12.0,
) -> torch.Tensor:
    n = p.shape[0]
    mask = 1.0 - torch.eye(n, device=p.device)

    def grad_kl(y, p_eff):
        num = mask / (1.0 + _pairwise_sq_dists(y))
        q = (num / num.sum()).clamp_min(1e-12)
        pq = (p_eff - q) * num
        # dKL/dy_i = 4 Σ_j (p_ij - q_ij)(1+|y_i-y_j|²)^-1 (y_i - y_j)
        return 4.0 * (torch.diag(pq.sum(dim=1)) - pq) @ y

    y, vel = y0, torch.zeros_like(y0)
    for i in range(n_iter):
        p_eff = p * exaggeration if i < exaggeration_iters else p
        vel = momentum * vel - learning_rate * grad_kl(y, p_eff)
        y = y + vel
        y = y - y.mean(dim=0, keepdim=True)
    return y


def tsne(
    embeddings: np.ndarray,
    n_components: int = 2,
    perplexity: float = 30.0,
    n_iter: int = 400,
    random_state: int = 42,
    metric: str = "cosine",
    device=None,
) -> np.ndarray:
    """Exact t-SNE on the card: [N, D] → [N, n_components]."""
    dev = resolve_device(device)
    x = np.asarray(embeddings, np.float32)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    n = len(x)
    perplexity = min(perplexity, max(2.0, (n - 1) / 3))
    p = _calibrate_p(_pairwise_sq_dists(torch.as_tensor(x, device=dev)), perplexity)
    y0 = torch.as_tensor(
        np.random.default_rng(random_state).normal(size=(n, n_components)) * 1e-2,
        dtype=torch.float32, device=dev,
    )
    return _tsne_optimize(p, y0, n_iter=n_iter).cpu().numpy()
