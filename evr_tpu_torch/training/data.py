"""Caption dataset and batch pipeline for contrastive fine-tuning.

Counterpart of ``evr_tpu/training/data.py`` (reference: ``ContentAwareDataset``
of ``Backend/clip_finetune_correct.py``): JSON dicts keyed by relative image
path with ``{"caption": ..., "category": ...}`` values; entries without a
caption or a file are dropped; the category mapping {"Sensitive content": 0,
"Violence": 1, "NonViolence": 2} with NonViolence the default; several JSONs
concatenate. Images are staged to uint8 on the host (cv2 decode, resize,
centre crop: ``ops.preprocess.stage_image_fast``) and batched with static
shapes; tokens come from the port's CLIP tokenizer. The native C++ stager
of the JAX package is not ported.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterator

import numpy as np

from evr_tpu_torch.ops.preprocess import stage_image_fast
from evr_tpu_torch.tokenizer import get_default_tokenizer

CATEGORY_MAPPING = {"Sensitive content": 0, "Violence": 1, "NonViolence": 2}
DEFAULT_CATEGORY_ID = 2


def prefetch_batches(iterator, depth: int = 2):
    """Producer-thread prefetch: host staging of batch i+1 overlaps the
    device step on batch i. An exception in the producer is re-raised
    here."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    errors: list[BaseException] = []

    def produce():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            errors.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        yield item
    if errors:
        raise errors[0]


class CaptionDataset:
    """(image path, caption, category_id) triples from caption JSONs."""

    def __init__(self, json_paths, base_dir, category_mapping: dict[str, int] | None = None,
                 check_files: bool = True):
        if isinstance(json_paths, (str, pathlib.Path)):
            json_paths = [json_paths]
        self.base_dir = pathlib.Path(base_dir)
        self.category_mapping = dict(category_mapping or CATEGORY_MAPPING)
        self.items: list[tuple[pathlib.Path, str, int]] = []
        for jp in json_paths:
            data = json.loads(pathlib.Path(jp).read_text(encoding="utf-8"))
            for rel_path, meta in data.items():
                caption = (meta.get("caption") or "").strip()
                if not caption:
                    continue
                full = self.base_dir / rel_path
                if check_files and not full.exists():
                    continue
                cat = self.category_mapping.get(meta.get("category", "NonViolence"), DEFAULT_CATEGORY_ID)
                self.items.append((full, caption, cat))

    def __len__(self) -> int:
        return len(self.items)

    def category_counts(self) -> dict[int, int]:
        counts: dict[int, int] = {}
        for _, _, cat in self.items:
            counts[cat] = counts.get(cat, 0) + 1
        return counts

    def split(self, val_fraction: float = 0.2, seed: int = 42):
        """(train, val) split with a fixed seed, the JAX package's order."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.items))
        n_val = int(len(order) * val_fraction)
        val, train = object.__new__(CaptionDataset), object.__new__(CaptionDataset)
        for ds, idx in ((val, order[:n_val]), (train, order[n_val:])):
            ds.base_dir = self.base_dir
            ds.category_mapping = self.category_mapping
            ds.items = [self.items[i] for i in idx]
        return train, val

    def batches(self, batch_size: int, image_size: int = 224, shuffle: bool = True,
                seed: int = 42, drop_remainder: bool = True, epoch: int = 0,
                tokenizer=None, process_index: int = 0,
                process_count: int = 1) -> Iterator[dict[str, np.ndarray]]:
        """Yield {'images': uint8 [B,S,S,3], 'tokens': int32 [B,77],
        'labels': int32 [B]} with static shapes: the epoch's order is
        shuffled with seed + epoch; an unreadable image is skipped and its
        batch padded back up by repetition.

        Several processes: pass this process's ``(process_index,
        process_count)`` and the per-process ``batch_size``. Every process
        shuffles the same order and takes a disjoint equal-length stride of
        it, dropping the trailing items that would leave one process a batch
        more than another (its peers would wait for it in a collective)."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        tokenizer = tokenizer or get_default_tokenizer()
        order = np.arange(len(self.items))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        if process_count > 1:
            per = len(order) // process_count
            order = order[process_index * per : (process_index + 1) * per]
        end = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
        for i in range(0, end, batch_size):
            images, captions, labels = [], [], []
            for j in order[i : i + batch_size]:
                path, caption, cat = self.items[j]
                try:
                    images.append(stage_image_fast(path, image_size))
                except IOError:
                    continue
                captions.append(caption)
                labels.append(cat)
            if not images:
                continue
            while drop_remainder and len(images) < batch_size:
                images.append(images[len(images) % max(1, len(images))])
                captions.append(captions[len(captions) % max(1, len(captions))])
                labels.append(labels[len(labels) % max(1, len(labels))])
            yield {
                "images": np.stack(images),
                "tokens": tokenizer(captions),
                "labels": np.asarray(labels, np.int32),
            }
