"""Text → top-k search in one call: tokens up once, results down once.

Counterpart of ``evr_tpu/index/fused_search.py``. The serving hot path is
tokenize (host) → ``engine.text_tower`` (``encode_text``, or the MoE tower)
→ normalise → GEMM → top-k. ``TextSearcher``
uploads the tokens once, runs the encode and ``ops.topk.cosine_topk`` with no
host synchronisation between them, and copies the k-sized result back with
one ``.cpu()``. The text encode runs every block in full, as the JAX
searcher's does (``encode_text`` without ``eot_fast_final``), and the search
is ``cosine_topk`` whatever the index's ``search_impl``: the fused top-k
kernel K4 is reached through ``FrameIndex.search`` only.

Results are cached per (model, index version, queries, k, video); with
``batch_window_ms`` concurrent single queries coalesce into one dispatch
(``serving.batcher``).
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.ops.topk import cosine_topk
from evr_tpu_torch.parallel.sharded_search import ShardedIndex

RESULT_CACHE_SIZE = 4096  # entries; the cache is cleared when it grows past this


def fetch_topk(scores: torch.Tensor, rows: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(scores float32 [Q, k], rows int64 [Q, k]) on the host by one copy:
    both go down in one float64 tensor, exact for fp32 scores and for row
    ids below 2^53."""
    both = torch.stack([scores.double(), rows.double()]).cpu().numpy()
    return both[0].astype(np.float32), both[1].astype(np.int64)


def pad_to_k(scores: np.ndarray, rows: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Results of fewer than k columns (the index shrank inside a batching
    window) padded to the promised k with −inf scores and row 0."""
    if scores.shape[1] >= k:
        return scores, rows
    pad = ((0, 0), (0, k - scores.shape[1]))
    return np.pad(scores, pad, constant_values=-np.inf), np.pad(rows, pad, constant_values=0)


class TextSearcher:
    """One-call text search over a ``FrameIndex``.

    ``batch_window_ms``: concurrent single-query searches arriving within the
    window coalesce into one dispatch of at most ``max_batch`` queries,
    padded to a power-of-two bucket (``serving.batcher.flush_padded``). Off
    by default."""

    def __init__(self, engine, index, batch_window_ms: float | None = None, max_batch: int = 16):
        self.engine = engine
        self.index = index
        self._result_cache: dict[tuple, tuple] = {}
        self._batcher = None
        if batch_window_ms is not None:
            from evr_tpu_torch.serving.batcher import MicroBatcher

            self.max_batch = max_batch
            self._batcher = MicroBatcher(self._search_group, max_batch=max_batch,
                                         window_s=batch_window_ms / 1e3)

    def _dispatch(self, queries: list, k: int, device_index, row_scales, start: int, end: int,
                  params=None) -> tuple[np.ndarray, np.ndarray]:
        engine = self.engine
        tokens = engine.tokenizer(list(queries), context_length=engine.cfg.text.context_length)
        with torch.inference_mode():
            tokens = torch.from_numpy(tokens).to(engine.device)
            txt = engine.text_tower(engine.params if params is None else params, tokens)
            # cosine_topk takes every storage dtype (int8 rows rescaled after
            # the GEMM), masks rows outside [start, end) and normalises the
            # query; a sharded snapshot searches shard by shard and merges
            return fetch_topk(*(device_index.topk(txt, start, end, k)
                                if isinstance(device_index, ShardedIndex)
                                else cosine_topk(device_index, txt, start, end, k, row_scales)))

    def _search_group(self, key, items: list) -> list:
        """MicroBatcher flush: the coalesced queries of one group as one
        dispatch. The group key holds the submit-time (model, version, k,
        scope); the flush pins the params to that model (a concurrent
        ``set_active_model`` must not reach into the group), clamps k to the
        flush-time snapshot and pads the results back to the promised k."""
        from evr_tpu_torch.serving.batcher import flush_padded

        model, _version, k, video_name = key
        params = self.engine.models[model]["clip"]
        device_index, row_scales, start, end, flush_version = self.index.snapshot(video_name)
        k_now = max(1, min(k, end - start))

        def run(padded):
            s, r = self._dispatch(padded, k_now, device_index, row_scales, start, end, params=params)
            return pad_to_k(s, r, k)

        results = flush_padded(items, self.max_batch, run)
        # cached under the FLUSH-time version, the snapshot the results
        # reflect: under the submit-time one a window that saw the index
        # advance would serve stale rows
        for query, (s_row, r_row) in zip(items, results):
            self._result_cache[(model, flush_version, (query,), k, video_name)] = (
                s_row[None], r_row[None])
        if len(self._result_cache) > RESULT_CACHE_SIZE:
            self._result_cache.clear()
        return results

    def search(self, queries, top_k: int, video_name: str | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], global rows [Q, k]) in one call."""
        if isinstance(queries, str):
            queries = [queries]
        device_index, row_scales, start, end, version = self.index.snapshot(video_name)
        k = max(1, min(top_k, end - start))
        cache_key = (self.engine.active_model, version, tuple(queries), k, video_name)
        if cache_key in self._result_cache:
            return self._result_cache[cache_key]
        if self._batcher is not None and len(queries) == 1:
            # cached inside _search_group, under the flush-time version
            row = self._batcher.submit((self.engine.active_model, version, k, video_name), queries[0])
            return row[0][None], row[1][None]
        out = self._dispatch(queries, k, device_index, row_scales, start, end)
        self._result_cache[cache_key] = out
        if len(self._result_cache) > RESULT_CACHE_SIZE:
            self._result_cache.clear()
        return out

    def invalidate(self) -> None:
        """Drop every cached result (after the index or a model changes)."""
        self._result_cache.clear()
