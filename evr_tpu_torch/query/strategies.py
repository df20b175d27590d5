"""Retrieval strategies over the port's engine and index.

Counterpart of ``evr_tpu/query/strategies.py`` for the two CLIP strategies
the serving path's text search dispatches:

| method        | semantics                                                 |
|---------------|-----------------------------------------------------------|
| text_clip     | top_k×3 candidates, optional MMR diversification and a   |
|               | negative query (normalise(q⁺ − w·q⁻)), events by score   |
| text_adaptive | the same candidates kept where score ≥ threshold          |

Candidates come from the cached text features and one ``FrameIndex.search``
(the JAX package's fused one-dispatch text searcher is not ported yet; its
result is the same top-k). The keyword, object, speech, temporal and
video-level strategies are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from evr_tpu_torch.index.store import FrameIndex, SearchHit

from .events import format_event_for_frontend
from .metadata import MetadataStore
from .text import identity_preprocessor

CANDIDATE_OVERFETCH = 3  # top_k × 3 candidates, as the reference over-fetches


class QueryEngine:
    def __init__(
        self,
        embedding_engine,
        index: FrameIndex,
        metadata: MetadataStore,
    ):
        self.engine = embedding_engine
        self.index = index
        self.metadata = metadata
        # the Vietnamese preprocessing pipeline is not ported yet
        self.preprocess = identity_preprocessor

    # -- shared plumbing --------------------------------------------------
    def _candidates(self, processed_text: str, top_k: int, video_name: str | None) -> list[SearchHit]:
        vec = self.engine.get_text_features(processed_text)
        return self.index.search(vec, top_k * CANDIDATE_OVERFETCH, video_name)[0]

    def _negative_vec(self, processed_text: str, negative_query: str, weight: float):
        """Composite direction ``normalise(q⁺ − w·q⁻)``; both encodes hit the
        engine's text-feature cache."""
        vp = np.asarray(self.engine.get_text_features(processed_text), np.float32).reshape(-1)
        vn = np.asarray(
            self.engine.get_text_features(self.preprocess(negative_query)), np.float32
        ).reshape(-1)
        vp = vp / max(float(np.linalg.norm(vp)), 1e-12)
        vn = vn / max(float(np.linalg.norm(vn)), 1e-12)
        v = vp - float(weight) * vn
        return v / max(float(np.linalg.norm(v)), 1e-12)

    def _frame_for_hit(self, hit: SearchHit):
        try:
            frameidx = int(hit.frame_name.rsplit(".", 1)[0])
        except ValueError:
            return None
        return self.metadata.frame_by_idx(hit.video, frameidx)

    def _mmr(self, hits: list[SearchHit], lam: float, k: int) -> list[SearchHit]:
        """MMR over the metadata-valid candidates (``query.diversify``), with
        the candidates' embeddings read from the index."""
        from .diversify import mmr_select

        hits = [h for h in hits if self._frame_for_hit(h) is not None]
        if not hits:
            return hits
        by_video = {v: self.index.get_embeddings(v) for v in {h.video for h in hits}}
        vecs = np.stack([by_video[h.video][h.frame_index] for h in hits])
        return mmr_select(hits, vecs, lam, k)

    def _events(self, hits: list[SearchHit], top_k: int) -> list[dict]:
        results = []
        for hit in hits:
            frame = self._frame_for_hit(hit)
            if frame is None:
                continue
            data = dict(frame.raw)
            data["clip_similarity"] = hit.score
            event = format_event_for_frontend(data, fps=self.metadata.fps(hit.video))
            event["clip_similarity"] = hit.score
            results.append(event)
        results.sort(key=lambda e: e.get("clip_similarity", 0), reverse=True)
        return results[:top_k]

    # -- strategies -------------------------------------------------------
    def query_text_clip(
        self,
        query: str,
        top_k: int,
        video_name: str | None = None,
        mmr_lambda: float | None = None,
        negative_query: str | None = None,
        negative_weight: float = 0.8,
    ):
        """``negative_query``: candidates are scored against the composite
        direction, so frames like the negative are pushed down, not removed."""
        processed = self.preprocess(query)
        if negative_query:
            vec = self._negative_vec(processed, negative_query, negative_weight)
            hits = self.index.search(vec, top_k * CANDIDATE_OVERFETCH, video_name)[0]
        else:
            hits = self._candidates(processed, top_k, video_name)
        if mmr_lambda is not None:
            hits = self._mmr(hits, mmr_lambda, top_k)
        return self._events(hits, top_k)

    def query_text_adaptive(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        video_name: str | None = None,
        mmr_lambda: float | None = None,
    ):
        processed = self.preprocess(query)
        hits = [
            h
            for h in self._candidates(processed, top_k, video_name)
            if math.isfinite(h.score) and h.score >= adaptive_threshold
        ]
        if mmr_lambda is not None:
            hits = self._mmr(hits, mmr_lambda, top_k)
        return self._events(hits, top_k)
