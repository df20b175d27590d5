"""Retrieval strategies over the port's engine and index.

Counterpart of ``evr_tpu/query/strategies.py`` for the two CLIP strategies
the serving path's text search dispatches:

| method        | semantics                                                 |
|---------------|-----------------------------------------------------------|
| text_clip     | top_k×3 candidates, optional MMR diversification and a   |
|               | negative query (normalise(q⁺ − w·q⁻)), events by score   |
| text_adaptive | the same candidates kept where score ≥ threshold          |

Candidates come, as in the JAX package, from the one-call text searcher
(``index.fused_search.TextSearcher``: encode → normalise → GEMM → top-k,
results cached per index version) over every exact tier. An ANN tier
(``search_impl`` "ivf" or "ivfpq") probes its lists through
``FrameIndex.search`` with the engine's cached text features, its global
searches coalesced by a micro-batcher under ``batch_window_ms``. A negative
query scores the composite direction through ``FrameIndex.search``. The
keyword, object, speech, temporal and video-level strategies are not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np

from evr_tpu_torch.index.store import FrameIndex, SearchHit

from .events import format_event_for_frontend
from .metadata import MetadataStore
from .text import identity_preprocessor

CANDIDATE_OVERFETCH = 3  # top_k × 3 candidates, as the reference over-fetches
ANN_MAX_BATCH = 8  # the ANN tier's micro-batches: a probe scores 8 queries for about the cost of 1


class QueryEngine:
    def __init__(
        self,
        embedding_engine,
        index: FrameIndex,
        metadata: MetadataStore,
        batch_window_ms: float | None = None,
    ):
        """``batch_window_ms``: concurrent single queries arriving within
        the window coalesce into one dispatch (``serving.batcher``); None
        disables."""
        self.engine = embedding_engine
        self.index = index
        self.metadata = metadata
        # the Vietnamese preprocessing pipeline is not ported yet
        self.preprocess = identity_preprocessor
        ann = getattr(index, "search_impl", None) in ("ivf", "ivfpq")
        # the one-call searcher scores the exact GEMM over the index snapshot;
        # an ANN tier must probe its lists through FrameIndex.search. Engines
        # without the full interface (test stubs) take the two-step path.
        self._searcher = None
        if hasattr(embedding_engine, "tokenizer") and hasattr(embedding_engine, "params") and not ann:
            from evr_tpu_torch.index.fused_search import TextSearcher

            self._searcher = TextSearcher(embedding_engine, index, batch_window_ms=batch_window_ms)
        # the ANN tier keeps micro-batching: concurrent global searches share
        # one probe (scoped searches run the small exact path per call)
        self._ann_batcher = None
        if self._searcher is None and batch_window_ms is not None and ann:
            from evr_tpu_torch.serving.batcher import MicroBatcher, flush_padded

            def _ann_batch(k, items):
                return flush_padded(items, ANN_MAX_BATCH, lambda padded: self.index.search_raw(
                    np.stack([np.asarray(v, np.float32).reshape(-1) for v in padded]), k))

            self._ann_batcher = MicroBatcher(_ann_batch, max_batch=ANN_MAX_BATCH,
                                             window_s=batch_window_ms / 1e3)

    # -- shared plumbing --------------------------------------------------
    def _candidates(self, processed_text: str, top_k: int, video_name: str | None) -> list[SearchHit]:
        return self._candidates_n(processed_text, top_k * CANDIDATE_OVERFETCH, video_name)

    def _hits(self, scores, rows) -> list[SearchHit]:
        hits = []
        for score, row in zip(scores, rows):
            if not math.isfinite(float(score)):
                continue
            video, frame, fidx = self.index.resolve_row(int(row))
            hits.append(SearchHit(video, frame, float(score), int(row), fidx))
        return hits

    def _candidates_n(self, processed_text: str, k: int, video_name: str | None) -> list[SearchHit]:
        if self._searcher is not None:
            scores, rows = self._searcher.search(processed_text, k, video_name)
            return self._hits(scores[0], rows[0])
        vec = self.engine.get_text_features(processed_text)
        if self._ann_batcher is not None and video_name is None:
            return self._hits(*self._ann_batcher.submit(k, vec))
        return self.index.search(vec, k, video_name)[0]

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
