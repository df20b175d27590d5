"""Image → top-k search in one call.

Counterpart of ``evr_tpu/index/fused_image_search.py`` and the image-query
mirror of ``fused_search.TextSearcher``: a staged uint8 image goes up once,
``(u8/255 − mean)/std`` → ``engine.image_tower`` → ``ops.topk.cosine_topk`` run with
no host synchronisation between them, and the k-sized result comes back by
one copy. The normalisation is explicit here, where the engine's frame encode
folds it into the patch GEMM (``encode_staged_u8``), so the two differ in
fp32 rounding. The reference re-encodes every candidate frame from disk per
image query; here candidates come from the resident index and only the query
image is encoded.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
from evr_tpu_torch.ops.topk import cosine_topk
from evr_tpu_torch.parallel.sharded_search import ShardedIndex

from .fused_search import fetch_topk, pad_to_k


class ImageSearcher:
    """``batch_window_ms``: coalesce concurrent single-image searches into
    one dispatch (the leader/follower scheme of ``TextSearcher``)."""

    def __init__(self, engine, index, batch_window_ms: float | None = None, max_batch: int = 8):
        self.engine = engine
        self.index = index
        self._mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=engine.device)
        self._std = torch.tensor(CLIP_STD, dtype=torch.float32, device=engine.device)
        self._batcher = None
        if batch_window_ms is not None:
            from evr_tpu_torch.serving.batcher import MicroBatcher

            self.max_batch = max_batch
            self._batcher = MicroBatcher(self._search_group, max_batch=max_batch,
                                         window_s=batch_window_ms / 1e3)

    def _search_group(self, key, items: list) -> list:
        """The flush contract of ``TextSearcher._search_group``: params pinned
        to the submit-time model, k clamped to the flush-time snapshot,
        results padded back to the promised k."""
        from evr_tpu_torch.serving.batcher import flush_padded

        model, _version, k, video_name = key
        params = self.engine.models[model]["clip"]
        snapshot = self.index.snapshot(video_name)
        k_now = max(1, min(k, snapshot[3] - snapshot[2]))

        def run(padded):
            return pad_to_k(*self._run_fused(np.stack(padded), k_now, snapshot, params), k)

        return flush_padded(items, self.max_batch, run)

    def search(self, staged_u8: np.ndarray, top_k: int, video_name: str | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """staged_u8: uint8 [Q, S, S, 3], already resized and cropped."""
        snapshot = self.index.snapshot(video_name)
        k = max(1, min(top_k, snapshot[3] - snapshot[2]))
        if self._batcher is not None and staged_u8.shape[0] == 1:
            row = self._batcher.submit((self.engine.active_model, snapshot[4], k, video_name),
                                       staged_u8[0])
            return row[0][None], row[1][None]
        return self._run_fused(staged_u8, k, snapshot, self.engine.params)

    def _run_fused(self, staged_u8: np.ndarray, k: int, snapshot, params
                   ) -> tuple[np.ndarray, np.ndarray]:
        device_index, row_scales, start, end, _ = snapshot
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(staged_u8)).to(self.engine.device)
            x = (x.float() / 255.0 - self._mean) / self._std
            img = self.engine.image_tower(params, x)
            return fetch_topk(*(device_index.topk(img, start, end, k)
                                if isinstance(device_index, ShardedIndex)
                                else cosine_topk(device_index, img, start, end, k, row_scales)))
