"""Classification head over CLIP image features (PyTorch).

Counterpart of ``evr_tpu/models/classifier.py``: a 512 → 512 → ReLU →
Dropout(0.1) → num_classes MLP over the L2-normalised image embedding
(``CLIPWithClassifier`` of the reference trainer), trained jointly with the
contrastive loss for the Violence / Sensitive / NonViolence domain. Dropout
draws its mask from an explicit ``torch.Generator``; the JAX package's
random streams cannot be reproduced, so parity runs use dropout 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layers import Params, linear


@dataclass(frozen=True)
class ClassifierConfig:
    embed_dim: int = 512
    hidden_dim: int = 512
    num_classes: int = 3
    dropout: float = 0.1


def init_classifier_params(rng: np.random.Generator | int, cfg: ClassifierConfig) -> Params:
    """Random head weights as numpy float32 arrays (``init_linear``'s
    scales: kernels N(0, d_in^-1/2), zero biases)."""
    rng = np.random.default_rng(rng)

    def lin(d_in, d_out):
        return {
            "kernel": rng.standard_normal((d_in, d_out), dtype=np.float32) * d_in ** -0.5,
            "bias": np.zeros((d_out,), np.float32),
        }

    return {"fc1": lin(cfg.embed_dim, cfg.hidden_dim), "fc2": lin(cfg.hidden_dim, cfg.num_classes)}


def classifier_forward(
    params: Params,
    cfg: ClassifierConfig,
    features: torch.Tensor,
    *,
    deterministic: bool = True,
    generator: torch.Generator | None = None,
    keep_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """features [B, embed_dim] → logits [B, num_classes]. With
    ``deterministic=False`` and dropout > 0, each hidden unit is kept with
    probability 1 − dropout (mask from ``generator``, or ``keep_mask`` [B,
    hidden] where given: a mesh step draws the global batch's mask and hands
    each slot its rows) and scaled by 1/keep."""
    h = torch.relu(linear(features, params["fc1"]))
    if not deterministic and cfg.dropout > 0.0:
        keep = 1.0 - cfg.dropout
        mask = (torch.rand(h.shape, generator=generator, device=h.device) < keep
                if keep_mask is None else keep_mask)
        h = torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))
    return linear(h, params["fc2"])
