"""Frame captioning for training pairs and for ingest (PyTorch).

Counterpart of ``evr_tpu/data_prep/captioning.py``: a ``Captioner``
protocol with

- ``TemplateCaptioner``: deterministic category-conditioned captions from
  the file name;
- ``HFCaptioner``: a HuggingFace image-to-text pipeline whose weights are on
  this machine (``local_files_only=True``: a model that is not there raises
  at construction, nothing is fetched), on the card unless the caller passes
  ``device="cpu"``;
- ``PrefixCaptioner``: CLIP image embeddings from an ``EmbeddingEngine``,
  then the prefix captioner (``models.captioner``) on the engine's device,
  decoded to text; ``caption_batch`` keeps the device batching when
  ``ingest.annotate_folder`` captions a whole folder.

``caption_folder`` captions a folder into the training JSON schema with
interim saves.
"""

from __future__ import annotations

import json
import pathlib
from typing import Protocol

CATEGORY_PROMPTS = {
    "Violence": "a scene showing violent activity",
    "Sensitive content": "a scene containing sensitive adult content",
    "NonViolence": "an everyday scene",
}


class Captioner(Protocol):
    def __call__(self, image_path, category: str | None = None) -> str: ...


class TemplateCaptioner:
    """Deterministic captions from filename + category prompt."""

    def __call__(self, image_path, category: str | None = None) -> str:
        stem = pathlib.Path(image_path).stem.replace("_", " ")
        prefix = CATEGORY_PROMPTS.get(category or "", "a video frame")
        return f"{prefix}, frame {stem}"


class HFCaptioner:
    """HuggingFace image-to-text captioner over local weights only."""

    def __init__(self, model_name: str, max_new_tokens: int = 40, device=None):
        """``model_name``: a local directory, or a hub name whose snapshot is
        in the local cache (``snapshot_download(local_files_only=True)``
        raises otherwise, before the pipeline is built). The pipeline runs
        on ``device``: the card unless the caller passes ``"cpu"``
        (``utils.device.resolve_device``; no card raises)."""
        from evr_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        path = model_name
        if not pathlib.Path(model_name).is_dir():
            from huggingface_hub import snapshot_download

            path = snapshot_download(model_name, local_files_only=True)
        from transformers import pipeline

        self.pipe = pipeline("image-to-text", model=path, max_new_tokens=max_new_tokens, device=self.device,
                             model_kwargs={"local_files_only": True})

    def __call__(self, image_path, category: str | None = None) -> str:
        out = self.pipe(str(image_path))
        return out[0]["generated_text"].strip() if out else ""


def caption_folder(images_dir, out_json, captioner: Captioner | None = None, category: str | None = None,
                   save_every: int = 50) -> dict:
    """Caption every image in a folder into ``{file name: {caption,
    category}}``, resuming a partial ``out_json`` and saving it every
    ``save_every`` images."""
    images_dir = pathlib.Path(images_dir)
    out_json = pathlib.Path(out_json)
    captioner = captioner or TemplateCaptioner()
    results: dict = {}
    if out_json.exists():
        results = json.loads(out_json.read_text(encoding="utf-8"))
    paths = sorted(p for p in images_dir.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    for i, path in enumerate(paths):
        if path.name in results:
            continue
        results[path.name] = {"caption": captioner(path, category), "category": category or "NonViolence"}
        if (i + 1) % save_every == 0:
            out_json.write_text(json.dumps(results, indent=2, ensure_ascii=False))
    out_json.write_text(json.dumps(results, indent=2, ensure_ascii=False))
    return results


class PrefixCaptioner:
    """CLIP image embedding (``engine.encode_image_files``, unit rows) →
    the prefix captioner on the engine's device (greedy ``generate``, or
    ``beam_search`` when ``beam_size`` > 1, fp32) → decoded text. Chunks of
    the engine's batch size, the last padded with zero rows, as the JAX
    captioner pads to one compiled shape."""

    def __init__(self, engine, captioner_params, cap_cfg, tokenizer=None, beam_size: int = 1):
        from evr_tpu_torch.models.convert import params_from_numpy

        self.engine = engine
        self.params = params_from_numpy(captioner_params, engine.device)
        self.cap_cfg = cap_cfg
        if tokenizer is None:
            from evr_tpu_torch.tokenizer import get_default_tokenizer

            tokenizer = get_default_tokenizer()
        self.tokenizer = tokenizer
        self.beam_size = beam_size
        self._chunk = max(1, int(getattr(engine, "batch_size", 32)))

    def _generate(self, feats):
        from evr_tpu_torch.models.captioner import beam_search, generate

        if self.beam_size > 1:
            return beam_search(self.params, self.cap_cfg, feats, beam_size=self.beam_size)
        return generate(self.params, self.cap_cfg, feats, sample=False)

    def caption_batch(self, paths) -> list[str]:
        import numpy as np
        import torch

        from evr_tpu_torch.models.captioner import decode_tokens

        feats = self.engine.encode_image_files(list(paths), normalise=True)
        out: list[str] = []
        B = self._chunk
        for i in range(0, len(feats), B):
            chunk = feats[i:i + B]
            n = chunk.shape[0]
            if n < B:
                chunk = np.concatenate([chunk, np.zeros((B - n, chunk.shape[1]), chunk.dtype)])
            tokens, _ = self._generate(torch.from_numpy(np.ascontiguousarray(chunk)).to(self.engine.device))
            out.extend(decode_tokens(self.tokenizer, tokens[:n], self.cap_cfg.eot_id))
        return out

    def __call__(self, image_path, category: str | None = None) -> str:
        return self.caption_batch([image_path])[0]
