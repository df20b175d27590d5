"""SigLIP contrastive fine-tuning: the trainer of the second model family.

Counterpart of the JAX package's ``training/siglip_train.py``. One step

    uint8 frames → [-1, 1] → both towers → L2 normalise →
    the pairwise sigmoid loss (``parallel.contrastive.siglip_loss_single``)
    → clip by global norm → AdamW,

on one device, or over a mesh's data axis: each slot encodes its rows of
the batch with its own detached aliases of its device's params, the loss is
``global_siglip_loss`` over the slots (the text features gathered; the
sigmoid loss has no softmax over the batch, so it equals the one-slot loss
on the global batch up to the order of its sums), and the gradients are
summed over the slots in slot order on the first slot's device (then over
the processes), as ``training.finetune.make_grad_fn`` does for CLIP.

The optimizer is ``optax.chain(clip_by_global_norm(grad_clip),
adamw(...))`` over every leaf, ``logit_scale`` and ``logit_bias``
included, built from the port's ``finetune.clip_by_global_norm`` and
``variants.AdamW``. Params are updated in place; ``fit_siglip`` works on a
fresh copy of the params it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from evr_tpu_torch.models import siglip as sig
from evr_tpu_torch.parallel.contrastive import global_siglip_loss, siglip_loss_single
from evr_tpu_torch.utils.device import resolve_device

from .finetune import _sum_grads_over_processes, _to_device, clip_by_global_norm, flat_leaves
from .partition import map_with_paths
from .variants import AdamW


@dataclass
class SiglipTrainConfig:
    lr: float = 1e-5
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-6
    grad_clip: float = 1.0
    compute_dtype: str = "float32"


class SiglipTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class SiglipOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2, eps,
    weight_decay))`` over every leaf of a params tree; no clip when
    ``grad_clip`` ≤ 0."""

    def __init__(self, tc: SiglipTrainConfig):
        self.grad_clip = tc.grad_clip
        self.adamw = AdamW(tc.lr, weight_decay=tc.weight_decay, b1=tc.betas[0], b2=tc.betas[1], eps=tc.eps)

    def init(self, params) -> dict:
        return self.adamw.init(flat_leaves(params))

    @torch.no_grad()
    def apply(self, params, grads: dict[str, torch.Tensor], state: dict) -> None:
        """Update ``params`` in place from ``grads`` (path key → gradient)."""
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        self.adamw.apply(flat_leaves(params), grads, state)


def make_siglip_optimizer(tc: SiglipTrainConfig) -> SiglipOptimizer:
    return SiglipOptimizer(tc)


def _dtype(tc: SiglipTrainConfig) -> torch.dtype:
    return torch.bfloat16 if tc.compute_dtype == "bfloat16" else torch.float32


def siglip_grads(params, cfg: sig.SiglipConfig, batch, dtype=torch.float32, mesh=None,
                 axis: str = "data") -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, path key → gradient of every leaf) of one batch: {"images":
    uint8 [B, S, S, 3], "tokens": int [B, ctx]}, numpy or tensors. Without
    ``mesh`` the batch runs on the params' device; with one, ``batch`` holds
    this process's rows, split evenly over its slots of ``axis``, and
    ``params`` lives on the first slot's device (copied to each other
    distinct device)."""
    images = torch.as_tensor(batch["images"])
    tokens = torch.as_tensor(batch["tokens"]).long()
    dev0 = params["logit_scale"].device
    if mesh is None:
        slots, devices = [0], [dev0]
    else:
        slots, devices = mesh.leaders(axis), mesh.slot_devices
    if images.shape[0] % len(slots):
        raise ValueError(f"{images.shape[0]} rows do not split over {len(slots)} local slots")
    b = images.shape[0] // len(slots)
    replicas = {dev0: params}
    aliases, feats = [], []
    with torch.enable_grad():
        for i, s in enumerate(slots):
            dev = devices[s]
            if dev not in replicas:
                replicas[dev] = _to_device(params, dev)
            alias = map_with_paths(replicas[dev], lambda _, t: t.detach().requires_grad_(True))
            rows = slice(i * b, (i + 1) * b)
            img = sig.encode_image(alias, cfg, sig.stage_pixels(images[rows].to(dev), dtype), dtype)
            txt = sig.encode_text(alias, cfg, tokens[rows].to(dev), dtype)
            aliases.append(alias)
            feats.append((img / img.norm(dim=-1, keepdim=True), txt / txt.norm(dim=-1, keepdim=True)))
        if mesh is None:
            (img, txt), = feats
            loss = siglip_loss_single(img, txt, aliases[0]["logit_scale"], aliases[0]["logit_bias"])
        else:
            loss = global_siglip_loss([f[0] for f in feats], [f[1] for f in feats],
                                      [a["logit_scale"] for a in aliases],
                                      [a["logit_bias"] for a in aliases], mesh, axis)
        per_slot = [flat_leaves(a) for a in aliases]
        keys = list(per_slot[0])
        grads = torch.autograd.grad(loss, [leaves[k] for leaves in per_slot for k in keys], allow_unused=True)
    out = {}
    for j, k in enumerate(keys):
        acc = None
        for i in range(len(slots)):  # slot order
            g = grads[i * len(keys) + j]
            g = torch.zeros_like(per_slot[i][k]) if g is None else g
            acc = g if acc is None else acc + g.to(dev0)
        out[k] = acc
    if mesh is not None and mesh.process_count > 1:
        out = _sum_grads_over_processes(out)
    return loss.detach(), out


def make_siglip_train_step(cfg: sig.SiglipConfig, tc: SiglipTrainConfig, opt: SiglipOptimizer,
                           mesh=None, axis: str = "data"):
    """``step(state, batch) -> (state, metrics)``: ``siglip_grads`` then
    ``opt``'s update of ``state.params`` in place. ``batch``: {"images":
    uint8 [B, S, S, 3], "tokens": int [B, ctx]}; with ``mesh`` B splits
    evenly over this process's slots of ``axis``."""
    dtype = _dtype(tc)

    def step(state: SiglipTrainState, batch):
        loss, grads = siglip_grads(state.params, cfg, batch, dtype, mesh, axis)
        opt.apply(state.params, grads, state.opt_state)
        return SiglipTrainState(state.params, state.opt_state, state.step + 1), {"loss": loss}

    return step


def fit_siglip(params, cfg: sig.SiglipConfig, batches, tc: SiglipTrainConfig | None = None, mesh=None,
               steps: int | None = None, device=None) -> tuple[Any, list[float]]:
    """Iterate ``batches`` (dicts of numpy arrays) for up to ``steps``
    updates on a fresh copy of ``params`` (numpy arrays or tensors) on
    ``device`` (None: the card), or on the first slot of ``mesh``'s
    ``data`` axis; returns (trained params, per-step losses)."""
    tc = tc or SiglipTrainConfig()
    dev = mesh.slot_devices[mesh.leaders("data")[0]] if mesh is not None else resolve_device(device)
    opt = make_siglip_optimizer(tc)
    step = make_siglip_train_step(cfg, tc, opt, mesh=mesh)
    fresh = _to_device(params, dev)
    state = SiglipTrainState(fresh, opt.init(fresh), 0)
    losses = []
    for i, batch in enumerate(batches):
        if steps is not None and i >= steps:
            break
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state.params, losses
