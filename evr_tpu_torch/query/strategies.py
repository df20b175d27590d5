"""The retrieval strategies over the port's engine and index.

Counterpart of ``evr_tpu/query/strategies.py``, method for method:

| method              | semantics                                             |
|---------------------|-------------------------------------------------------|
| text_clip           | top_k×3 CLIP candidates, optional MMR and a negative  |
|                     | query (normalise(q⁺ − w·q⁻)), events by score         |
| text_adaptive       | the same candidates kept where score ≥ threshold      |
| keyword_only        | frames whose OCR text holds the keyword (folded)      |
| text_keyword        | CLIP candidates whose OCR text holds the keyword      |
| object_only         | frames matching objects, caption, tags or OCR×0.7     |
| text_object         | CLIP candidates matching objects, caption or tags     |
| text_object_keyword | CLIP candidates matching both                         |
| speech_only         | frames inside transcript segments holding the keyword |
| text_speech         | CLIP candidates inside such segments                  |
| video               | videos ranked by the mean of their best frames        |
| (temporal)          | ordered chains of sub-queries in one video            |

Candidates come, as in the JAX package, from the one-call text searcher
(``index.fused_search.TextSearcher``: encode → normalise → GEMM → top-k,
results cached per index version) over every exact tier. An ANN tier
(``search_impl`` "ivf" or "ivfpq") probes its lists through
``FrameIndex.search`` with the engine's cached text features, its global
searches coalesced by a micro-batcher under ``batch_window_ms``. A negative
query scores the composite direction through ``FrameIndex.search``; a
temporal query encodes its sub-queries in one ``encode_texts`` call. The
metadata strategies are host lookups in ``MetadataStore``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from evr_tpu_torch.index.store import FrameIndex, SearchHit

from .events import format_event_for_frontend
from .metadata import SPEECH_CONF, MetadataStore
from .text import QueryPreprocessor, identity_preprocessor

OBJECT_ONLY_THRESHOLD_CAP = 0.65  # object_only never asks more than a caption hit's confidence
CANDIDATE_OVERFETCH = 3  # top_k × 3 candidates, as the reference over-fetches
ANN_MAX_BATCH = 8  # the ANN tier's micro-batches: a probe scores 8 queries for about the cost of 1


class QueryEngine:
    def __init__(
        self,
        embedding_engine,
        index: FrameIndex,
        metadata: MetadataStore,
        preprocessor: QueryPreprocessor | None = None,
        batch_window_ms: float | None = None,
    ):
        """``preprocessor``: the query hook (``query.text``), identity when
        None. ``batch_window_ms``: concurrent single queries arriving within
        the window coalesce into one dispatch (``serving.batcher``); None
        disables."""
        self.engine = embedding_engine
        self.index = index
        self.metadata = metadata
        self.preprocess = preprocessor or identity_preprocessor
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

    def _format_event(self, video: str, frame, extra: dict) -> dict:
        data = dict(frame.raw)
        data.update(extra)
        return format_event_for_frontend(data, fps=self.metadata.fps(video))

    def _clip_event(self, video: str, frame, score: float) -> dict:
        event = self._format_event(video, frame, {"clip_similarity": score})
        event["clip_similarity"] = score
        return event

    def _events(self, hits: list[SearchHit], top_k: int) -> list[dict]:
        results = []
        for hit in hits:
            frame = self._frame_for_hit(hit)
            if frame is None:
                continue
            results.append(self._clip_event(hit.video, frame, hit.score))
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

    # -- temporal chains ---------------------------------------------------
    def query_temporal(
        self,
        queries: list[str],
        top_k: int = 5,
        max_gap: int | None = None,
        video_name: str | None = None,
    ):
        """Ordered multi-event chains ("X, then Y, then Z"): one batched text
        encode for every sub-query, one GEMM per candidate video and an exact
        O(K·n) DP over the frame axis (``query.temporal``). Each result is the
        first step's event plus ``chain`` (the steps' events) and
        ``total_score``."""
        from .temporal import temporal_search

        if len(queries) < 2:
            raise ValueError("temporal search needs at least 2 sub-queries")
        processed = [self.preprocess(q) for q in queries]
        chains = temporal_search(
            self.engine.encode_texts, self.index, processed,
            top_k=top_k, max_gap=max_gap, video_name=video_name,
        )
        results = []
        for ch in chains:
            steps = []
            for fname, score in zip(ch.frame_names, ch.step_scores):
                frame = self._frame_for_hit(SearchHit(ch.video, fname, score, -1, -1))
                if frame is None:
                    steps.append({"video": ch.video, "frame": fname, "clip_similarity": score})
                else:
                    steps.append(self._clip_event(ch.video, frame, score))
            entry = dict(steps[0]) if steps else {"video": ch.video}
            entry["chain"] = steps
            entry["total_score"] = ch.total_score
            results.append(entry)
        return results

    # -- OCR keyword -------------------------------------------------------
    def _videos(self, video_name: str | None) -> list[str]:
        return [video_name] if video_name else self.metadata.videos()

    def query_keyword(
        self,
        keyword: str,
        adaptive_threshold: float,
        top_k: int,
        video_name: str | None = None,
    ):
        results = []
        for video in self._videos(video_name):
            for frame in self.metadata.frames(video):
                conf = self.metadata.keyword_best_match(frame, keyword)
                if conf > 0.0 and conf >= adaptive_threshold:
                    results.append(self._format_event(
                        video, frame, {"text_confidence": conf, "clip_similarity": 0.0}))
        results.sort(key=lambda e: e.get("confidence", 0), reverse=True)
        return results[:top_k]

    def _clip_frames(self, query: str, adaptive_threshold: float, top_k: int,
                     video_name: str | None):
        """(hit, frame) for the CLIP candidates at or above the threshold that
        have metadata, in candidate order."""
        for hit in self._candidates(self.preprocess(query), top_k, video_name):
            if hit.score < adaptive_threshold:
                continue
            frame = self._frame_for_hit(hit)
            if frame is not None:
                yield hit, frame

    def query_text_keyword(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        keyword: str | None = None,
        text_confidence: float | None = None,
        video_name: str | None = None,
    ):
        keyword_to_use = keyword if keyword else query
        keyword_threshold = text_confidence if text_confidence is not None else adaptive_threshold
        results = []
        for hit, frame in self._clip_frames(query, adaptive_threshold, top_k, video_name):
            text_conf = self.metadata.keyword_best_match(frame, keyword_to_use)
            if text_conf <= 0.0 or text_conf < keyword_threshold:
                continue
            event = self._format_event(hit.video, frame, {
                "clip_similarity": hit.score, "text_confidence": text_conf,
                "object_confidence": 0.0})
            event["confidence"] = max(hit.score, text_conf)
            event["clip_similarity"] = hit.score
            event["text_confidence"] = text_conf
            event["detection_type"] = "text+clip"
            results.append(event)
        results.sort(key=lambda e: e["confidence"], reverse=True)
        return results[:top_k]

    # -- objects -----------------------------------------------------------
    def query_object(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        video_name: str | None = None,
    ):
        actual_threshold = min(adaptive_threshold, OBJECT_ONLY_THRESHOLD_CAP)
        results = []
        for video in self._videos(video_name):
            for frame in self.metadata.frames(video):
                found, conf, label = self.metadata.object_best_match(frame, query, include_ocr=True)
                if found and conf >= actual_threshold:
                    results.append(self._format_event(video, frame, {
                        "object_confidence": conf, "detection_type": "object",
                        "object_label": label}))
        results.sort(key=lambda e: e["confidence"], reverse=True)
        return results[:top_k]

    def query_text_object(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        object_keyword: str | None = None,
        object_confidence: float | None = None,
        video_name: str | None = None,
    ):
        object_to_use = object_keyword if object_keyword else query
        obj_threshold = object_confidence if object_confidence is not None else adaptive_threshold
        results = []
        for hit, frame in self._clip_frames(query, adaptive_threshold, top_k, video_name):
            # objects, caption and tags only, as the reference's text_object
            found, obj_conf, label = self.metadata.object_best_match(
                frame, object_to_use, include_ocr=False)
            if not found or obj_conf < obj_threshold:
                continue
            event = self._format_event(hit.video, frame, {
                "clip_similarity": hit.score, "object_confidence": obj_conf,
                "text_confidence": 0.0, "object_label": label})
            event["confidence"] = max(hit.score, obj_conf)
            event["clip_similarity"] = hit.score
            event["object_confidence"] = obj_conf
            event["detection_type"] = "object+clip"
            results.append(event)
        results.sort(key=lambda e: e["confidence"], reverse=True)
        return results[:top_k]

    def query_text_object_keyword(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        keyword: str | None = None,
        text_confidence: float | None = None,
        object_keyword: str | None = None,
        object_confidence: float | None = None,
        video_name: str | None = None,
    ):
        keyword_to_use = keyword if keyword else query
        object_to_use = object_keyword if object_keyword else query
        keyword_threshold = text_confidence if text_confidence is not None else adaptive_threshold
        obj_threshold = object_confidence if object_confidence is not None else adaptive_threshold
        results = []
        for hit, frame in self._clip_frames(query, adaptive_threshold, top_k, video_name):
            text_conf = self.metadata.keyword_best_match(frame, keyword_to_use)
            if text_conf <= 0.0 or text_conf < keyword_threshold:
                continue
            # all four object sources, OCR×0.7 included
            found, obj_conf, label = self.metadata.object_best_match(
                frame, object_to_use, include_ocr=True)
            if not found or obj_conf < obj_threshold:
                continue
            event = self._format_event(hit.video, frame, {
                "clip_similarity": hit.score, "text_confidence": text_conf,
                "object_confidence": obj_conf, "object_label": label})
            event["confidence"] = max(hit.score, text_conf, obj_conf)
            event["clip_similarity"] = hit.score
            event["text_confidence"] = text_conf
            event["object_confidence"] = obj_conf
            event["detection_type"] = "text+object+clip"
            results.append(event)
        results.sort(key=lambda e: e["confidence"], reverse=True)
        return results[:top_k]

    # -- speech ------------------------------------------------------------
    def query_speech(
        self,
        keyword: str,
        top_k: int,
        video_name: str | None = None,
    ):
        """Frames inside transcript segments whose text holds the keyword
        (accent-insensitive), at the flat SPEECH_CONF; events carry the
        segment's text."""
        results = []
        for video in self._videos(video_name):
            for frame, seg_text in self.metadata.speech_frames(video, keyword):
                event = self._format_event(video, frame, {"clip_similarity": 0.0})
                event["confidence"] = SPEECH_CONF
                event["speech_confidence"] = SPEECH_CONF
                event["speech_text"] = seg_text
                event["detection_type"] = "speech"
                results.append(event)
        results.sort(key=lambda e: e.get("confidence", 0), reverse=True)
        return results[:top_k]

    def query_text_speech(
        self,
        query: str,
        adaptive_threshold: float,
        top_k: int,
        keyword: str | None = None,
        video_name: str | None = None,
    ):
        """CLIP candidates whose covering transcript segment holds the
        keyword; confidence = max(clip, speech)."""
        keyword_to_use = keyword if keyword else query
        results = []
        for hit, frame in self._clip_frames(query, adaptive_threshold, top_k, video_name):
            conf, seg_text = self.metadata.speech_best_match(hit.video, frame, keyword_to_use)
            if conf <= 0.0:
                continue
            event = self._format_event(hit.video, frame, {"clip_similarity": hit.score})
            event["confidence"] = max(hit.score, conf)
            event["clip_similarity"] = hit.score
            event["speech_confidence"] = conf
            event["speech_text"] = seg_text
            event["detection_type"] = "speech+clip"
            results.append(event)
        results.sort(key=lambda e: e["confidence"], reverse=True)
        return results[:top_k]

    # -- whole videos ------------------------------------------------------
    def query_videos(
        self,
        query: str,
        top_k: int = 5,
        frames_per_video: int = 3,
        video_name: str | None = None,
    ):
        """Rank videos: each scores the mean of its best ``frames_per_video``
        frame similarities among one over-fetched candidate search. One event
        per video, its best frame's, with ``video_score`` (which drives
        ``confidence``), ``matched_frames`` and ``top_frames``."""
        processed = self.preprocess(query)
        total = self.index.total_frames
        if total == 0:
            return []
        # enough rows that top_k videos each surface several frames even when
        # one video holds the global top of the list
        k = min(total, max(top_k * 20, 100))
        by_video: dict[str, list[SearchHit]] = {}
        for h in self._candidates_n(processed, k, video_name):
            by_video.setdefault(h.video, []).append(h)
        scored = []
        for video, hs in by_video.items():
            hs.sort(key=lambda h: h.score, reverse=True)
            top = hs[: max(1, frames_per_video)]
            scored.append((sum(h.score for h in top) / len(top), video, hs))
        scored.sort(key=lambda t: t[0], reverse=True)
        results = []
        for video_score, video, hs in scored[:top_k]:
            frame = self._frame_for_hit(hs[0])
            if frame is None:
                continue
            event = self._clip_event(video, frame, hs[0].score)
            event["confidence"] = float(video_score)
            event["video_score"] = float(video_score)
            event["matched_frames"] = len(hs)
            event["top_frames"] = [h.frame_name for h in hs[:frames_per_video]]
            results.append(event)
        return results

    # -- dispatch ----------------------------------------------------------
    def search(self, method: str, **kwargs):
        try:
            fn = SEARCH_METHOD_DISPATCH[method]
        except KeyError:
            raise ValueError(
                f"unknown search_method {method!r}; expected one of {sorted(SEARCH_METHOD_DISPATCH)}"
            ) from None
        return fn(self, **kwargs)


SEARCH_METHOD_DISPATCH: dict[str, Callable] = {
    "text_clip": QueryEngine.query_text_clip,
    "text_adaptive": QueryEngine.query_text_adaptive,
    "keyword_only": QueryEngine.query_keyword,
    "text_keyword": QueryEngine.query_text_keyword,
    "object_only": QueryEngine.query_object,
    "text_object": QueryEngine.query_text_object,
    "text_object_keyword": QueryEngine.query_text_object_keyword,
    "speech_only": QueryEngine.query_speech,
    "text_speech": QueryEngine.query_text_speech,
    "video": QueryEngine.query_videos,
}

SEARCH_METHODS = tuple(SEARCH_METHOD_DISPATCH)
