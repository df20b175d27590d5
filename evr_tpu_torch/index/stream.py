"""Streaming double-buffered embedding of a frame folder.

Counterpart of ``evr_tpu/index/stream.py``: a producer thread stages
batches through the engine's native stager while the card encodes the
previous batch. A producer error (a stager that cannot be built, a folder
that vanished) is raised on the caller's side after the producer ends.
"""

from __future__ import annotations

import pathlib
import queue
import threading

import numpy as np

from evr_tpu_torch.index.engine import IMAGE_EXTENSIONS


def embed_folder_streaming(
    engine,
    folder,
    batch_size: int | None = None,
    normalise: bool = True,
    queue_depth: int = 2,
) -> tuple[np.ndarray, list[str]]:
    """Like ``EmbeddingEngine.embed_folder`` but with staging overlapped
    against device compute; files the stager cannot decode (any but a JPEG)
    are skipped. Returns (embeddings, frame_names)."""
    folder = pathlib.Path(folder)
    batch_size = batch_size or engine.batch_size
    candidates = sorted(
        p.name for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTENSIONS
    )

    work: queue.Queue = queue.Queue(maxsize=queue_depth)
    sentinel = object()
    producer_error: list[BaseException] = []

    def produce():
        try:
            for i in range(0, len(candidates), batch_size):
                chunk = candidates[i : i + batch_size]
                batch, ok = engine._stage_native([folder / n for n in chunk])
                work.put((batch[ok], [chunk[j] for j in ok]))
        except BaseException as e:  # raised on the consumer side
            producer_error.append(e)
        finally:
            work.put(sentinel)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()

    embs: list[np.ndarray] = []
    names_out: list[str] = []
    while True:
        item = work.get()
        if item is sentinel:
            break
        batch, names = item
        if len(batch):
            embs.append(engine.encode_staged_images(batch))
            names_out.extend(names)
    thread.join()
    if producer_error:
        raise producer_error[0]

    emb = (
        np.concatenate(embs, axis=0)
        if embs
        else np.zeros((0, engine.cfg.embed_dim), np.float32)
    )
    if normalise and len(emb):
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    return emb.astype(np.float32), names_out
