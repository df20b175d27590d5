"""Projection and fusion heads over the CLIP towers (PyTorch).

Counterpart of ``evr_tpu/models/heads.py``. Reference counterparts:

- 512→P projection pair with Xavier init / zero bias + learnable
  logit_scale (`content/source_training/training_CLIP_multimodal.py:104-160`,
  also the T4 contrastive trainer);
- fusion model: concat(img, txt) → Linear(2D, 512) → ReLU → Dropout(0.1) →
  classifier, plus per-modality auxiliary classifiers
  (`content/CLIP_finetune_HEAD/training_CLIP.py:64-127`, and the v3
  progressive trainer's head).

Inits draw from an explicit ``torch.Generator`` (or an int seed) on the CPU
as float32 tensors; the JAX package's random streams cannot be reproduced,
so parity runs carry its initial heads across (``params_from_numpy``). The
fusion dropout's keep-mask draws from a ``torch.Generator`` on the
features' device (``_keep_mask``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .layers import Params, linear


def _generator(rng: torch.Generator | int) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _xavier(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    bound = math.sqrt(6.0 / (d_in + d_out))
    return torch.rand((d_in, d_out), generator=gen, dtype=torch.float32) * (2 * bound) - bound


def _linear_params(kernel: torch.Tensor) -> Params:
    return {"kernel": kernel, "bias": torch.zeros((kernel.shape[1],), dtype=torch.float32)}


def _keep_mask(shape, keep: float, generator: torch.Generator | None, device) -> torch.Tensor:
    """Bernoulli(keep) mask of ``shape`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < keep


# -- projection pair (T3/T4) ----------------------------------------------


@dataclass(frozen=True)
class ProjectionConfig:
    embed_dim: int = 512  # CLIP output dim
    proj_dim: int = 256  # 0 → identity (no projection)


def init_projection_params(rng: torch.Generator | int, cfg: ProjectionConfig) -> Params:
    logit_scale = torch.tensor(math.log(1 / 0.07), dtype=torch.float32)
    if cfg.proj_dim <= 0:
        return {"logit_scale": logit_scale}
    gen = _generator(rng)
    return {
        "image_projection": _linear_params(_xavier(gen, cfg.embed_dim, cfg.proj_dim)),
        "text_projection": _linear_params(_xavier(gen, cfg.embed_dim, cfg.proj_dim)),
        "logit_scale": logit_scale,
    }


def project_features(
    params: Params, image_features: torch.Tensor | None, text_features: torch.Tensor | None
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Apply the projection pair + L2 normalise (the trainers always
    normalise after projecting)."""

    def proj(x, name):
        if x is None:
            return None
        if name in params:
            x = linear(x, params[name])
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    return proj(image_features, "image_projection"), proj(text_features, "text_projection")


# -- fusion head (T5 / T2) ------------------------------------------------


@dataclass(frozen=True)
class FusionConfig:
    embed_dim: int = 512
    hidden_dim: int = 512
    num_classes: int = 2
    dropout: float = 0.1


def init_fusion_params(rng: torch.Generator | int, cfg: FusionConfig) -> Params:
    gen = _generator(rng)
    return {
        "fusion": _linear_params(_xavier(gen, cfg.embed_dim * 2, cfg.hidden_dim)),
        "classifier": _linear_params(_xavier(gen, cfg.hidden_dim, cfg.num_classes)),
        "image_classifier": _linear_params(_xavier(gen, cfg.embed_dim, cfg.num_classes)),
        "text_classifier": _linear_params(_xavier(gen, cfg.embed_dim, cfg.num_classes)),
    }


def fusion_forward(
    params: Params,
    cfg: FusionConfig,
    image_features: torch.Tensor,  # [B, D] L2-normalised
    text_features: torch.Tensor,  # [B, D] L2-normalised
    deterministic: bool = True,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Returns the T5 output dict: fused/image/text logits + the features.
    With ``deterministic=False`` and dropout > 0, each fusion unit is kept
    with probability 1 − dropout (mask from ``generator``) and scaled by
    1/keep."""
    image_logits = linear(image_features, params["image_classifier"])
    text_logits = linear(text_features, params["text_classifier"])
    combined = torch.cat([image_features, text_features], dim=-1)
    h = torch.relu(linear(combined, params["fusion"]))
    if not deterministic and cfg.dropout > 0:
        keep = 1.0 - cfg.dropout
        mask = _keep_mask(h.shape, keep, generator, h.device)
        h = torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
    fused_logits = linear(h, params["classifier"])
    return {
        "fused_logits": fused_logits,
        "image_logits": image_logits,
        "text_logits": text_logits,
        "image_features": image_features,
        "text_features": text_features,
    }
