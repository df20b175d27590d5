"""Contrastive losses over one device's batch (PyTorch).

Counterpart of the single-device functions of
``evr_tpu/parallel/contrastive.py``: the reference's in-batch symmetric
InfoNCE (CE over logit_scale·img·textᵀ with diagonal targets, both
directions averaged) and the SigLIP pairwise sigmoid loss. The global-batch
versions over a device mesh wait for ROADMAP item A15.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None])[:, 0]


def infonce_loss_single(
    image_features: torch.Tensor, text_features: torch.Tensor, logit_scale: torch.Tensor
) -> torch.Tensor:
    """Symmetric CE with diagonal targets over L2-normalised features."""
    logits = logit_scale.exp() * image_features @ text_features.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (
        _cross_entropy(logits, labels).mean() + _cross_entropy(logits.T, labels).mean()
    )


def siglip_loss_single(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    logit_bias: torch.Tensor,
) -> torch.Tensor:
    """SigLIP (arxiv 2303.15343): −1/|B| Σ_i Σ_j log σ(z_ij (t·x_i·y_j + b)),
    z = +1 on the diagonal and −1 elsewhere."""
    logits = logit_scale.exp() * image_features @ text_features.T + logit_bias
    n = logits.shape[0]
    z = 2.0 * torch.eye(n, dtype=torch.float32, device=logits.device) - 1.0
    return -F.logsigmoid(z * logits.float()).sum(-1).mean()
