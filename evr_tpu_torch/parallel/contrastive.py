"""Contrastive losses, over one device's batch or a mesh's global batch
(PyTorch).

Counterpart of ``evr_tpu/parallel/contrastive.py``: the reference's in-batch
symmetric InfoNCE (CE over logit_scale·img·textᵀ with diagonal targets, both
directions averaged) and the SigLIP pairwise sigmoid loss.

The global versions take one feature shard a local slot (slot order, each on
its slot's device). They gather the features of every slot (in-process by
copies, across processes by ``multihost.gather_rows``), score each slot's rows
against every global column with labels offset by the slot's position, and
average the slots' losses (JAX's ``pmean``). At equal global batch the loss
is the single-device loss, and its gradient flows back to every slot's
features: through the copies in one process, and through the gather's
backward, a sum over the processes, across them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import multihost


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


def gather_features(parts: list[torch.Tensor]) -> torch.Tensor:
    """The global batch's rows of ``parts`` (one shard a local slot), in slot
    order, on the first part's device; differentiable."""
    dev = parts[0].device
    return multihost.gather_rows(torch.cat([p.to(dev) for p in parts], dim=0))


def slot_mean(values: list[torch.Tensor], n_slots: int) -> torch.Tensor:
    """JAX's ``pmean`` over ``n_slots`` slots of one scalar a local slot: the
    local values summed in slot order (then over the processes) and
    divided, on the first value's device. The gradient reaches the local
    values only, as each slot's does in JAX."""
    dev = values[0].device
    total = values[0]
    for v in values[1:]:
        total = total + v.to(dev)
    if multihost.process_count() > 1:
        every = multihost.sum_over_processes(total.detach())
        total = every + (total - total.detach())
    return total / n_slots


def _per_slot(x, n: int) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def global_infonce_loss(
    image_features: list[torch.Tensor],  # one [b, D] shard a local slot, L2-normalised
    text_features: list[torch.Tensor],
    logit_scale,  # a tensor, or one a local slot
    mesh,
    axis: str = "data",
) -> torch.Tensor:
    """InfoNCE over the global batch: each slot's rows against every global
    column, labels offset by the slot's position, the slots' losses averaged.
    The same value as ``infonce_loss_single`` on the whole batch."""
    n = mesh.axis_size(axis)
    slots = mesh.leaders(axis)
    d = image_features[0].shape[1]
    both = gather_features([torch.cat([i, t], dim=1) for i, t in zip(image_features, text_features)])
    scales = _per_slot(logit_scale, len(slots))
    local = []
    for s, img, txt, scale in zip(slots, image_features, text_features, scales):
        b, dev = img.shape[0], img.device
        every = both.to(dev)
        labels = mesh.axis_index(s, axis) * b + torch.arange(b, device=dev)
        scale = scale.to(dev).exp()
        logits_i = scale * img @ every[:, d:].T
        logits_t = scale * txt @ every[:, :d].T
        local.append(0.5 * (_cross_entropy(logits_i, labels).mean()
                            + _cross_entropy(logits_t, labels).mean()))
    return slot_mean(local, n)


def global_siglip_loss(
    image_features: list[torch.Tensor],  # one [b, D] shard a local slot, L2-normalised
    text_features: list[torch.Tensor],
    logit_scale,
    logit_bias,
    mesh,
    axis: str = "data",
) -> torch.Tensor:
    """SigLIP over the global batch: every (i, j) pair appears once in the
    image-rows × all-texts products, so gathering the text features and
    averaging the slots' row means gives the single-device loss."""
    n = mesh.axis_size(axis)
    slots = mesh.leaders(axis)
    all_txt = gather_features(list(text_features))
    scales = _per_slot(logit_scale, len(slots))
    biases = _per_slot(logit_bias, len(slots))
    local = []
    for s, img, scale, bias in zip(slots, image_features, scales, biases):
        b, dev = img.shape[0], img.device
        txt = all_txt.to(dev)
        logits = scale.to(dev).exp() * img @ txt.T + bias.to(dev)
        pos = torch.arange(txt.shape[0], device=dev)[None, :] == (mesh.axis_index(s, axis) * b + torch.arange(b, device=dev))[:, None]
        z = torch.where(pos, 1.0, -1.0)
        local.append(-F.logsigmoid(z * logits.float()).sum(-1).mean())
    return slot_mean(local, n)


def split_rows(mesh, x: torch.Tensor, axis: str = "data") -> list[torch.Tensor]:
    """This process's rows of a global batch split evenly over its groups of
    ``axis``, each on its leader slot's device."""
    slots = mesh.leaders(axis)
    if x.shape[0] % len(slots):
        raise ValueError(f"{x.shape[0]} rows do not split over {len(slots)} local slots")
    b = x.shape[0] // len(slots)
    devices = mesh.slot_devices
    return [x[i * b:(i + 1) * b].to(devices[s]) for i, s in enumerate(slots)]


def make_sharded_infonce(mesh, axis: str = "data"):
    """``fn(img, txt, logit_scale)``: ``global_infonce_loss`` over this
    process's rows of the global batch, split over its slots."""
    def fn(img, txt, logit_scale):
        return global_infonce_loss(split_rows(mesh, img, axis), split_rows(mesh, txt, axis), logit_scale,
                                   mesh, axis)

    return fn
