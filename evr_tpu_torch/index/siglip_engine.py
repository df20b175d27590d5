"""SiglipEngine — the serving adapter of the SigLIP model family (PyTorch).

Counterpart of the JAX package's ``index/siglip_engine.py``. It gives
``models/siglip.py`` the part of ``EmbeddingEngine``'s surface that
``ServingContext`` and ``QueryEngine`` read (``cfg.embed_dim``,
``active_model``, ``model_name``, ``get_text_features``, ``encode_texts``,
``encode_staged_images``, ``embed_folder``), so a SigLIP tower backs the
whole retrieval stack: the per-model indexes, every strategy (through the
two-step dispatch: the one-call ``TextSearcher`` and ``ImageSearcher`` are
CLIP's, and this engine has no ``tokenizer`` or ``models`` attribute, so
neither is built), and image and hybrid search through ``stage_array``.

Preprocessing: SigLIP squashes a frame to S x S (cubic, no crop) and maps
it to [-1, 1]; staging is this engine's own (``stage_array``,
``models.siglip.stage_pixels``).

Tokenisation: SigLIP's SentencePiece vocabulary is a deployment asset. Pass
``tokenize_fn`` (texts → [B, context] int ids, padded), e.g. a local
``transformers.SiglipTokenizer``; without one the deterministic byte-level
``tokenizer.fallbacks.SiglipFallbackTokenizer`` stands in, and
``tokenizer_source`` records which is active.

The engine runs on ``device`` (None: the card; "cpu" on request).
``params_dtype``: "float32", "bfloat16" (every floating leaf cast, as the
JAX engine casts them) or "int8" (the block linears, ``models.quant``).
``compute_dtype``: None is bfloat16 on the card and float32 on the CPU, as
``EmbeddingEngine`` computes; the JAX engine's default is float32.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.siglip import (
    SiglipConfig,
    encode_image,
    encode_text,
    init_siglip_params,
    stage_pixels,
)
from evr_tpu_torch.utils.device import resolve_device

PARAMS_DTYPES = ("float32", "bfloat16", "int8")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


class SiglipEngine:
    """Batched SigLIP encoders behind the EmbeddingEngine surface."""

    def __init__(
        self,
        cfg: SiglipConfig | None = None,
        params=None,
        tokenize_fn=None,
        batch_size: int = 64,
        compute_dtype: str | None = None,
        rng_seed: int = 0,
        params_dtype: str = "float32",
        device=None,
    ):
        if params_dtype not in PARAMS_DTYPES:
            raise ValueError(f"unknown params_dtype {params_dtype!r} (supported: {PARAMS_DTYPES})")
        self.cfg = cfg or SiglipConfig()
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r} (supported: {sorted(COMPUTE_DTYPES)})")
        self.compute_dtype = COMPUTE_DTYPES[compute_dtype]
        if params is None:
            params = init_siglip_params(rng_seed, self.cfg, self.device)
        self.params_dtype = params_dtype
        self.params = params_from_numpy(
            params, self.device, torch.bfloat16 if params_dtype == "bfloat16" else None)
        if params_dtype == "int8":
            from evr_tpu_torch.models.quant import quantize_siglip_params

            self.params = quantize_siglip_params(self.params)
        if tokenize_fn is None:
            from evr_tpu_torch.tokenizer.fallbacks import SiglipFallbackTokenizer

            tokenize_fn = SiglipFallbackTokenizer(
                context_length=self.cfg.text.context_length, vocab_size=self.cfg.text.vocab_size)
            self.tokenizer_source = "fallback"
        else:
            self.tokenizer_source = "provided"
        self.tokenize_fn = tokenize_fn
        self.batch_size = batch_size
        self.active_model = "original"
        self.model_name = "siglip"  # /api/models reads this
        self._text_cache: dict[tuple, np.ndarray] = {}

    # -- serving surface ---------------------------------------------------
    def set_active_model(self, name: str) -> bool:
        return name == self.active_model

    def available_models(self) -> list[str]:
        return [self.active_model]

    @torch.inference_mode()
    def encode_staged_images(self, staged_u8: np.ndarray, normalise: bool = True,
                             pad: bool = True) -> np.ndarray:
        """[B, S, S, 3] uint8 (staged at ``cfg.vision.image_size``) → [B,
        width] unit-norm float32 features, in batches of ``batch_size``.
        SigLIP features are always served unit-norm (``normalise`` is
        accepted for the engine surface). The last batch is not padded
        (``pad`` is accepted for the surface): a batch's rows are
        independent."""
        del normalise, pad
        out = []
        for i in range(0, len(staged_u8), self.batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(staged_u8[i:i + self.batch_size])).to(self.device)
            feats = encode_image(self.params, self.cfg, stage_pixels(chunk, self.compute_dtype),
                                 self.compute_dtype)
            out.append(_unit(feats).cpu().numpy())
        if not out:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        return np.concatenate(out, axis=0)

    @torch.inference_mode()
    def encode_texts(self, texts, normalise: bool = True) -> np.ndarray:
        del normalise
        tokens = np.asarray(self.tokenize_fn(list(texts)))
        if tokens.ndim != 2 or tokens.shape[1] != self.cfg.text.context_length:
            raise ValueError(
                f"tokenize_fn must return [B, {self.cfg.text.context_length}] ids, got {tokens.shape}")
        tokens = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        return _unit(encode_text(self.params, self.cfg, tokens, self.compute_dtype)).cpu().numpy()

    def get_text_features(self, query: str) -> np.ndarray:
        key = (self.active_model, query)
        if key not in self._text_cache:
            self._text_cache[key] = self.encode_texts([query])[0]
        return self._text_cache[key]

    def clear_text_cache(self) -> None:
        self._text_cache.clear()

    def stage_array(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB [H, W, 3] → [S, S, 3] uint8, as HF's
        ``SiglipImageProcessor``: a plain square resize (cubic), no crop.
        ``ServingContext`` prefers it to the CLIP stager."""
        import cv2

        s = self.cfg.vision.image_size
        out = cv2.resize(np.asarray(rgb), (s, s), interpolation=cv2.INTER_CUBIC)
        return np.clip(out, 0, 255).astype(np.uint8)

    def embed_folder(self, folder, normalise: bool = True, progress=None) -> tuple:
        """Embed every image of a folder sorted by file name (the order that
        aligns index rows with metadata frames, as ``EmbeddingEngine``'s);
        unreadable frames are skipped. Returns (features, names)."""
        import cv2

        del normalise
        folder = pathlib.Path(folder)
        names = sorted(p.name for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTS)
        staged, kept = [], []
        for i, name in enumerate(names):
            bgr = cv2.imread(str(folder / name))
            if bgr is None:
                continue  # an unreadable frame is skipped, the ingest goes on
            staged.append(self.stage_array(bgr[:, :, ::-1]))
            kept.append(name)
            if progress:
                progress(i + 1, len(names))
        if not staged:
            return np.zeros((0, self.cfg.embed_dim), np.float32), []
        return self.encode_staged_images(np.stack(staged)), kept

    @classmethod
    def from_hf(cls, model_or_path, tokenize_fn=None, **kw) -> "SiglipEngine":
        """Build from a ``transformers.SiglipModel`` or a local checkpoint
        directory (read with ``local_files_only=True``: no network)."""
        from evr_tpu_torch.models.siglip import from_hf_siglip_state_dict, siglip_config_from_hf

        if isinstance(model_or_path, (str, bytes, os.PathLike)):
            from transformers import SiglipModel

            model_or_path = SiglipModel.from_pretrained(str(model_or_path), local_files_only=True)
        cfg = siglip_config_from_hf(model_or_path.config)
        params = from_hf_siglip_state_dict(model_or_path.state_dict(), cfg)
        return cls(cfg=cfg, params=params, tokenize_fn=tokenize_fn, **kw)
