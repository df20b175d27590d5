"""Result diversification: maximal-marginal-relevance (MMR) re-selection
(copy of the JAX package's ``query/diversify.py``).

No reference analog (`Backend/query_strategies.py` returns raw rank order):
in an event-retrieval UI the top-k for a query is frequently k
near-duplicate frames of the same shot, which buries every other matching
event. MMR (Carbonell & Goldstein, 1998) greedily selects

    argmax_d  lam * rel(d) - (1 - lam) * max_{s in S} sim(d, s)

so each pick balances relevance against similarity to what is already
selected. ``lam=1`` reproduces plain relevance order; lower values trade
score for coverage.

Scale note: candidate sets here are small (top_k x the strategy over-fetch,
a few hundred rows at most), so the pairwise similarity is one [M,D]x[D,M]
numpy GEMM and the greedy loop runs on host — a device dispatch would spend
more on the transport round trip than the entire computation (PERF.md).
"""

from __future__ import annotations

import numpy as np


def mmr_order(
    relevance: np.ndarray, pairwise: np.ndarray, lam: float, k: int
) -> np.ndarray:
    """Greedy MMR selection order.

    ``relevance`` [M] query-document scores, ``pairwise`` [M, M]
    document-document similarities, ``lam`` in [0, 1]. Returns the indices
    of the ``min(k, M)`` selected documents, in selection order (the first
    pick is always the most relevant document).
    """
    m = int(relevance.shape[0])
    if pairwise.shape != (m, m):
        raise ValueError(
            f"pairwise must be [{m}, {m}], got {pairwise.shape}"
        )
    if not 0.0 <= lam <= 1.0:
        raise ValueError(f"lam must be in [0, 1], got {lam}")
    k = max(0, min(k, m))
    if k == 0:
        return np.zeros((0,), np.int64)

    rel = np.asarray(relevance, np.float64)
    sim = np.asarray(pairwise, np.float64)
    selected = np.empty(k, np.int64)
    selected[0] = int(np.argmax(rel))
    # max similarity of every candidate to the selected set, updated
    # incrementally — O(M) per pick, O(M·k) total
    max_to_sel = sim[:, selected[0]].copy()
    remaining = np.ones(m, bool)
    remaining[selected[0]] = False
    for i in range(1, k):
        score = lam * rel - (1.0 - lam) * max_to_sel
        score[~remaining] = -np.inf
        pick = int(np.argmax(score))
        selected[i] = pick
        remaining[pick] = False
        np.maximum(max_to_sel, sim[:, pick], out=max_to_sel)
    return selected


def mmr_select(hits: list, vectors: np.ndarray, lam: float, k: int) -> list:
    """Select ``min(k, len(hits))`` diverse hits via MMR.

    ``hits`` carry ``.score`` (query relevance); ``vectors`` [M, D] are the
    hits' L2-normalised embeddings (cosine pairwise similarity). Returns
    the selected hits in selection order.
    """
    if not hits:
        return []
    vecs = np.asarray(vectors, np.float32)
    if vecs.ndim != 2 or vecs.shape[0] != len(hits):
        raise ValueError(
            f"vectors must be [{len(hits)}, D], got {vecs.shape}"
        )
    rel = np.asarray([h.score for h in hits], np.float32)
    order = mmr_order(rel, vecs @ vecs.T, lam, k)
    return [hits[i] for i in order]
