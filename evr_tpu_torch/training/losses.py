"""Training losses (PyTorch).

Counterpart of ``evr_tpu/training/losses.py``: ``total = contrastive_weight
* (CE_i2t + CE_t2i)/2 + classification_weight * CE_cls`` with diagonal
contrastive targets (or the SigLIP pairwise loss), the classifier reading
the L2-normalised image features, optional label smoothing. With a ``mesh``
and an ``axis`` the inputs are one shard a local slot and the loss is the
global batch's: the contrastive term through ``parallel.contrastive``'s
global losses, the classification terms as slot means averaged over the
slots (JAX's ``pmean``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from evr_tpu_torch.parallel.contrastive import (
    global_infonce_loss,
    global_siglip_loss,
    infonce_loss_single,
    siglip_loss_single,
    slot_mean,
)


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-example CE with optional label smoothing; fp32 internally."""
    logits = logits.float()
    n = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), n).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n
    return -(onehot * logp).sum(-1)


def combined_clip_loss(
    image_features: torch.Tensor,  # [b, D] L2-normalised
    text_features: torch.Tensor,  # [b, D] L2-normalised
    logit_scale: torch.Tensor,
    class_logits: torch.Tensor | None = None,
    class_labels: torch.Tensor | None = None,
    contrastive_weight: float = 1.0,
    classification_weight: float = 0.2,
    label_smoothing: float = 0.0,
    contrastive_impl: str = "infonce",
    logit_bias: torch.Tensor | None = None,
    axis: str | None = None,
    mesh=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Joint contrastive + classification loss → (total, metrics). With
    ``axis`` (and its ``mesh``) every tensor argument but the scalars is a
    list of one shard a local slot, and the scalars may be too; total and
    metrics are the global batch's, on the first slot's device."""
    if axis is not None:
        return _global_clip_loss(
            image_features, text_features, logit_scale, class_logits, class_labels,
            contrastive_weight, classification_weight, label_smoothing, contrastive_impl,
            logit_bias, axis, mesh)
    if contrastive_impl == "siglip":
        bias = (
            torch.tensor(-10.0, device=image_features.device) if logit_bias is None else logit_bias
        )
        contrastive = siglip_loss_single(image_features, text_features, logit_scale, bias)
    elif contrastive_impl == "infonce":
        contrastive = infonce_loss_single(image_features, text_features, logit_scale)
    else:
        raise ValueError(f"unknown contrastive_impl {contrastive_impl!r}")
    metrics = {"contrastive_loss": contrastive}
    total = contrastive_weight * contrastive
    if class_logits is not None and class_labels is not None:
        cls = softmax_cross_entropy(class_logits, class_labels, label_smoothing).mean()
        acc = (class_logits.argmax(-1) == class_labels).float().mean()
        metrics["classification_loss"] = cls
        metrics["classification_accuracy"] = acc
        total = total + classification_weight * cls
    metrics["total_loss"] = total
    return total, metrics


def _global_clip_loss(image_features, text_features, logit_scale, class_logits, class_labels,
                      contrastive_weight, classification_weight, label_smoothing,
                      contrastive_impl, logit_bias, axis, mesh):
    n = mesh.axis_size(axis)
    if contrastive_impl == "siglip":
        if logit_bias is None:
            logit_bias = torch.tensor(-10.0, device=image_features[0].device)
        contrastive = global_siglip_loss(image_features, text_features, logit_scale, logit_bias, mesh, axis)
    elif contrastive_impl == "infonce":
        contrastive = global_infonce_loss(image_features, text_features, logit_scale, mesh, axis)
    else:
        raise ValueError(f"unknown contrastive_impl {contrastive_impl!r}")
    metrics = {"contrastive_loss": contrastive}
    total = contrastive_weight * contrastive
    if class_logits is not None and class_labels is not None:
        cls = slot_mean([softmax_cross_entropy(lg, lb, label_smoothing).mean()
                         for lg, lb in zip(class_logits, class_labels)], n)
        acc = slot_mean([(lg.argmax(-1) == lb).float().mean()
                         for lg, lb in zip(class_logits, class_labels)], n)
        metrics["classification_loss"] = cls
        metrics["classification_accuracy"] = acc
        total = total + classification_weight * cls
    metrics["total_loss"] = total
    return total, metrics
