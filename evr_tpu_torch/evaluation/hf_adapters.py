"""HuggingFace model adapters for the comparison harness.

Counterpart of ``evr_tpu/evaluation/hf_adapters.py``. The reference's
`ModelComparison` zoo loads three HF-backed model families beside the
fine-tuned CLIP (`compare_models.py:15`, `:306-344`): OpenAI CLIP / laion
OpenCLIP checkpoints (both published as HF `CLIPModel` repos, e.g.
``laion/CLIP-ViT-H-14-laion2B-s32B-b79K`` for the reference's OpenCLIP
ViT-H-14), FLAVA (``facebook/flava-full``, `:333-344`), and a raw ViT-B/16
aligned into CLIP space with a least-squares projection (`:423-472` — see
`evaluation.projection_align.ProjectedAdapter`).

These adapters satisfy the harness's ``ModelAdapter`` protocol
(`evaluation.compare`). They are ``transformers`` models, not the port's
towers: they accept either a repo id (resolved via ``from_pretrained``,
which needs the network or a local HF cache) or an already constructed
model + preprocessing callables, so zero-egress environments and tests can
inject local or tiny models. ``device``: None means the card (it raises
without one); pass "cpu" to run on the CPU.

FLAVA note: ``FlavaModel`` outputs *sequence* embeddings ([B, T, H]); this
adapter pools the CLS token then L2-normalises. The reference instead
L2-normalises the raw sequence tensor along dim 1 and stacks it
(`compare_models.py:550-560`) — an artifact that yields per-token rows; the
CLS pooling here is what FLAVA's own contrastive heads use.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from evr_tpu_torch.utils.device import resolve_device


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _load_images(paths: Sequence[str]):
    from PIL import Image

    return [Image.open(p).convert("RGB") for p in paths]


class HFCLIPAdapter:
    """`transformers.CLIPModel` adapter (OpenAI CLIP ports and laion
    OpenCLIP hub checkpoints — `compare_models.py:306-331`)."""

    def __init__(
        self,
        model="openai/clip-vit-base-patch32",
        processor=None,
        batch_size: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(model, str):
            from transformers import AutoProcessor, CLIPModel

            processor = processor or AutoProcessor.from_pretrained(model)
            model = CLIPModel.from_pretrained(model)
        if processor is None:
            raise ValueError("pass a processor when injecting a model object")
        self.model = model.to(self.device).eval()
        self.processor = processor
        self.batch_size = batch_size

    def encode_image_files(self, paths: Sequence[str]) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(paths), self.batch_size):
                images = _load_images(paths[i : i + self.batch_size])
                inputs = self.processor(images=images, return_tensors="pt")
                px = inputs["pixel_values"].to(self.device)
                f = self.model.get_image_features(pixel_values=px)
                feats.append(f.cpu().numpy())
        return _l2(np.concatenate(feats, axis=0).astype(np.float32))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                inputs = self.processor(
                    text=list(texts[i : i + self.batch_size]),
                    return_tensors="pt",
                    padding=True,
                    truncation=True,
                )
                f = self.model.get_text_features(
                    input_ids=inputs["input_ids"].to(self.device),
                    attention_mask=inputs["attention_mask"].to(self.device),
                )
                feats.append(f.cpu().numpy())
        return _l2(np.concatenate(feats, axis=0).astype(np.float32))


class FlavaAdapter:
    """`transformers.FlavaModel` adapter (`compare_models.py:333-344`,
    encode paths `:527-595`). CLS-pooled, L2-normalised features."""

    def __init__(
        self,
        model="facebook/flava-full",
        processor=None,
        batch_size: int = 8,  # the reference's FLAVA batch (`:527`)
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(model, str):
            from transformers import FlavaModel, FlavaProcessor

            processor = processor or FlavaProcessor.from_pretrained(model)
            model = FlavaModel.from_pretrained(model)
        if processor is None:
            raise ValueError("pass a processor when injecting a model object")
        self.model = model.to(self.device).eval()
        self.processor = processor
        self.batch_size = batch_size

    def encode_image_files(self, paths: Sequence[str]) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(paths), self.batch_size):
                images = _load_images(paths[i : i + self.batch_size])
                inputs = self.processor(images=images, return_tensors="pt")
                out = self.model(
                    pixel_values=inputs["pixel_values"].to(self.device),
                    return_dict=True,
                )
                cls = out.image_embeddings[:, 0, :]
                feats.append(cls.cpu().numpy())
        return _l2(np.concatenate(feats, axis=0).astype(np.float32))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                inputs = self.processor(
                    text=list(texts[i : i + self.batch_size]),
                    return_tensors="pt",
                    padding=True,
                    truncation=True,
                )
                out = self.model(
                    input_ids=inputs["input_ids"].to(self.device),
                    attention_mask=inputs["attention_mask"].to(self.device),
                    return_dict=True,
                )
                cls = out.text_embeddings[:, 0, :]
                feats.append(cls.cpu().numpy())
        return _l2(np.concatenate(feats, axis=0).astype(np.float32))


class ViTEncoderAdapter:
    """Image-only `transformers.ViTModel` adapter (the reference's
    'ViT-B/16 + projection' entry, `compare_models.py:423-472`). Wrap it in
    `projection_align.ProjectedAdapter` to score t2i retrieval against a
    CLIP text tower."""

    def __init__(
        self,
        model="google/vit-base-patch16-224",
        preprocess: Callable | None = None,
        batch_size: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        if isinstance(model, str):
            from transformers import AutoImageProcessor, ViTModel

            preprocess = preprocess or AutoImageProcessor.from_pretrained(model)
            model = ViTModel.from_pretrained(model)
        if preprocess is None:
            raise ValueError("pass a preprocess callable when injecting a model")
        self.model = model.to(self.device).eval()
        self.preprocess = preprocess
        self.batch_size = batch_size

    def encode_image_files(self, paths: Sequence[str]) -> np.ndarray:
        feats = []
        with torch.no_grad():
            for i in range(0, len(paths), self.batch_size):
                images = _load_images(paths[i : i + self.batch_size])
                inputs = self.preprocess(images=images, return_tensors="pt")
                out = self.model(pixel_values=inputs["pixel_values"].to(self.device))
                cls = out.last_hidden_state[:, 0, :]
                feats.append(cls.cpu().numpy())
        return np.concatenate(feats, axis=0).astype(np.float32)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError(
            "ViTEncoderAdapter has no text tower — wrap it in "
            "projection_align.ProjectedAdapter with a CLIP adapter"
        )
