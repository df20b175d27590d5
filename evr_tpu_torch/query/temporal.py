"""Temporal event-sequence search — "X, then Y, then Z" over one video
(copy of the JAX package's ``query/temporal.py``: numpy, the same tie order).

The reference retrieves single events only; this adds ordered multi-event
chains, the natural extension for a video *event retrieval* system: given
K sub-queries, find frames f₁ < f₂ < … < f_K inside one video maximizing
the summed CLIP similarities, optionally constrained to a maximum
frame-index gap between consecutive steps.

Shape of the computation (why this is cheap): ALL K sub-queries encode as
ONE batched text encode, scoring is one [K, D]×[D, n] GEMM per candidate
video, and the ordered-chain optimum is exact dynamic programming over the
frame axis — `M[i][j] = S[i][j] + max_{j' < j, j−j' ≤ gap} M[i−1][j']`,
O(K·n) total via a sliding-window maximum. No per-frame Python loops over
metadata, no beam approximations.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

NEG = np.float32(-1e30)


@dataclass
class ChainHit:
    video: str
    frame_indices: list[int]  # positions within the video, strictly increasing
    frame_names: list[str]
    step_scores: list[float]
    total_score: float


def _windowed_running_max(
    values: np.ndarray, max_gap: int | None
) -> tuple[np.ndarray, np.ndarray]:
    """For each j: (max, argmax) of values[max(0, j−gap) .. j−1].

    ``max_gap=None`` = unbounded (prefix running max). Monotonic-deque
    sliding-window maximum, O(n).
    """
    n = values.shape[0]
    best = np.full(n, NEG, np.float32)
    arg = np.full(n, -1, np.int64)
    if max_gap is None:
        run_v, run_i = NEG, -1
        for j in range(1, n):
            if values[j - 1] > run_v:
                run_v, run_i = values[j - 1], j - 1
            best[j], arg[j] = run_v, run_i
        return best, arg
    dq: deque[int] = deque()  # indices, values decreasing
    for j in range(1, n):
        i = j - 1  # index entering the window for position j
        while dq and values[dq[-1]] <= values[i]:
            dq.pop()
        dq.append(i)
        while dq and dq[0] < j - max_gap:
            dq.popleft()
        if dq:
            best[j], arg[j] = values[dq[0]], dq[0]
    return best, arg


def chain_dp(scores: np.ndarray, max_gap: int | None = None):
    """Best strictly-increasing chain through a [K, n] score matrix.

    Returns ``(total, indices [K])`` or ``(-inf, [])`` when no valid chain
    exists (n < K, or the gap constraint is unsatisfiable).
    """
    K, n = scores.shape
    if n < K:
        return float("-inf"), []
    M = scores[0].astype(np.float32).copy()
    parents = []
    for i in range(1, K):
        prev_best, prev_arg = _windowed_running_max(M, max_gap)
        M = scores[i].astype(np.float32) + prev_best
        parents.append(prev_arg)
    j = int(np.argmax(M))
    total = float(M[j])
    # an infeasible chain carries at least one NEG term; CLIP cosines are
    # in [-K, K], so half of NEG cleanly separates feasible totals
    if total <= float(NEG) / 2:
        return float("-inf"), []
    chain = [j]
    for prev_arg in reversed(parents):
        j = int(prev_arg[j])
        if j < 0:
            return float("-inf"), []
        chain.append(j)
    return total, chain[::-1]


def temporal_search(
    encode_texts,
    index,
    queries: list[str],
    top_k: int = 5,
    max_gap: int | None = None,
    video_name: str | None = None,
) -> list[ChainHit]:
    """Rank videos by their best ordered chain for ``queries``.

    ``encode_texts``: callable(list[str]) → L2-normalised [K, D] (the
    engine's batched text encode — ONE dispatch for all sub-queries).
    ``index``: a ``FrameIndex`` (per-video normalised embeddings via
    ``get_embeddings``). ``max_gap``: max frame-index gap between
    consecutive steps (None = unbounded). Returns the ``top_k`` best
    chains across videos (or within ``video_name``).
    """
    if len(queries) < 2:
        raise ValueError("temporal search needs at least 2 sub-queries")
    vecs = np.asarray(encode_texts(list(queries)), np.float32)  # [K, D]
    videos = [video_name] if video_name else list(index.videos)
    hits: list[ChainHit] = []
    for name in videos:
        emb = index.get_embeddings(name, normalised=True)  # [n, D]
        if emb.shape[0] < len(queries):
            continue
        scores = vecs @ emb.T  # [K, n]
        total, chain = chain_dp(scores, max_gap)
        if not chain:
            continue
        names = index.frame_names(name)
        hits.append(
            ChainHit(
                video=name,
                frame_indices=chain,
                frame_names=[names[j] for j in chain],
                step_scores=[float(scores[i, j]) for i, j in enumerate(chain)],
                total_score=total,
            )
        )
    hits.sort(key=lambda h: h.total_score, reverse=True)
    return hits[:top_k]
