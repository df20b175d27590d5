"""Contrastive fine-tuning on one device or over a mesh (PyTorch).

Counterpart of ``evr_tpu/training/finetune.py`` (parity target: the
production trainer ``Backend/clip_finetune_correct.py``): CLIP + 3-class
head, freeze-prefix 8, symmetric InfoNCE (weight 1.0) + classification CE
(weight 0.2), AdamW betas (0.9, 0.98) eps 1e-6 wd 0.01 in four groups
(visual ×1, text ×0.5, classifier ×5, other ×1), a cosine schedule stepped
per epoch down to lr/10 with optional linear warmup, global-norm clipping at
1.0 over the trainable leaves, a finite-update guard, early stopping, best /
final checkpoints and resume.

The optimizer is written out to follow optax as the JAX trainer chains it,
``apply_if_finite(chain(clip_by_global_norm, multi_transform({group:
adamw})), max_consecutive_nonfinite)``:

- the learning rate is evaluated at the optimizer's count before it
  increments; a skipped (non-finite) step does not advance the count, and
  the update is applied anyway once more than ``max_consecutive_nonfinite``
  steps in a row were skipped;
- decoupled weight decay on every trainable leaf, biases, LayerNorm
  parameters and ``logit_scale`` included;
- frozen leaves (``requires_grad=False``, the JAX trainer's stop_gradient)
  get no update, no decay and no moments, and never enter the norm;
- ``adam_mu_dtype="bfloat16"`` stores mu in bf16 (the update runs in fp32).

The levers follow the JAX trainer:

- ``grad_accumulation_steps`` = k > 1: ``optax.MultiSteps`` outside the
  finite guard (``MultiSteps``): a running mean of the gradients
  (``acc + (g − acc) / (n + 1)``), the inner optimizer applied, and its
  state kept, on every k-th call only; the other calls leave the params
  bit-equal. The step count and the EMA advance on every call;
- ``optimizer="muon"``: each trainable leaf is labelled
  ``"<group>:<muon|adamw>"`` (``muon.muon_param_labels``); Muon leaves take
  the orthogonalized Nesterov momentum at ``lr · group scale ·
  muon_lr_scale`` with no weight decay, the others AdamW;
- ``patch_drop``: ``n_keep = max(1, round(grid² · (1 − patch_drop)))``
  patch tokens kept per example, an argsort of uniforms drawn from the
  step's generator before the classifier's dropout (``draw_patch_keep``);
  the evaluation step runs the full sequence;
- ``remat``: the Trainer switches ``CLIPConfig.remat`` on;
- ``lora_rank`` > 0: adapters drawn at ``seed + 1`` (``lora.init_lora``),
  merged into the dense kernels inside the forward, the base frozen;
  ``Trainer.merged_clip_params`` is the tree that serves;
- ``gradcache_chunks`` > 1: the chunked exact gradient of
  ``gradcache.gradcache_parts`` (refused with moe, LoRA or
  ``patch_drop``, ``ValueError``); over a mesh the chunks are of the global
  batch, each chunk's rows encoded on the slots that hold them.

Where the JAX step donates its buffers, the port updates the params and the
moments in place. The vision tower of ViT-L/14@336px (T = 577) runs its
blocks through the fused kernels K1/K2 forward and K5b/K5a backward
(``attn_impl="auto_grad"``, as the JAX trainer pins); shorter towers take the
plain composition under autograd, and so does a vision tower that
``patch_drop`` cuts below T = 512.

``moe`` (a ``models.moe.MoEConfig``) trains the sparse towers
(``models.moe.encode_image_slots`` / ``encode_text_slots``) and adds
``moe.aux_weight`` × the load-balance term to the loss (metrics ``moe_aux``
and ``total_loss``); a dense start is Sparse-Upcycled at ``seed + 2``
(``models.moe.upcycle_clip_params``). LoRA with MoE raises. On a mesh with
an ``expert`` axis the expert-stacked leaves, their AdamW moments and the
EMA split over it (``parallel.ep``); FSDP with an ``expert`` axis raises.
Over several data slots each MoE layer routes the token groups the
one-device step forms over the global batch (the same capacity and the
same drops), each group on the slot that holds its first token: a group
that crosses into the next slot takes those rows over and hands their
outputs back (``models.moe.moe_mlp_slots``), so the step equals the
one-device step. Across processes each process must hold whole groups.

Over a mesh (``parallel.mesh``; ``make_train_step(mesh=)``, ``Trainer(mesh=,
fsdp=)``) the step equals the one-device step on the global batch: every
random draw is made for the global batch and split, the loss is the global
batch's (``losses.combined_clip_loss`` with ``axis``), and the gradients are
summed over the slots in slot order, then over the processes
(``parallel.multihost``). One gradient function (``make_grad_fn``) serves
both layouts: one device is the one-slot case. Data parallelism keeps the params once per
distinct device; FSDP (``parallel.fsdp``) keeps each slot's shard of the
params, the optimizer state and the EMA, gathers the whole params once per
device for the step and updates each shard where it lives; Muon's
Newton–Schulz takes the whole matrix (its momentum gathered, each slot
taking its shard of the update) and accumulation the whole running mean's
clip and finite decisions. On a ``("data", "model")`` mesh tensor
parallelism (``parallel.tp``) keeps each model slot's shard of the block
weights, gathers a block's weights whole where the block runs, and each slot
updates its shard. The batch splits over the groups of the data axis
(``Mesh.leaders``); the other axes' slots of a group share its rows.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from evr_tpu_torch.models.classifier import ClassifierConfig, classifier_forward
from evr_tpu_torch.models.clip import CLIPConfig, encode_image, encode_text
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.moe import (
    encode_image_slots, encode_text_slots, has_moe, image_features, text_features, upcycle_clip_params,
)
from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
from evr_tpu_torch.parallel.contrastive import slot_mean
from evr_tpu_torch.parallel.ep import input_parts, whole_grad
from evr_tpu_torch.parallel.tp import lazy_aliases, lazy_tree, splits_over
from evr_tpu_torch.utils.device import resolve_device

from .gradcache import gradcache_parts
from .lora import init_lora, merge_lora
from .losses import combined_clip_loss
from .muon import muon_direction, muon_param_labels
from .partition import iter_paths, map_with_paths, param_group_labels


@dataclass
class TrainConfig:
    seed: int = 42
    batch_size: int = 32
    epochs: int = 10
    lr: float = 1e-5
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-6
    grad_clip: float = 1.0
    early_stopping: int = 5
    freeze_layers: int = 8
    contrastive_weight: float = 1.0
    classification_weight: float = 0.2
    label_smoothing: float = 0.0
    text_lr_scale: float = 0.5
    classifier_lr_scale: float = 5.0
    eta_min_ratio: float = 0.1  # CosineAnnealingLR eta_min = lr * ratio
    compute_dtype: str = "bfloat16"
    save_dir: str = "checkpoints"
    # a non-finite gradient skips the update (optax.apply_if_finite)
    skip_nonfinite_updates: bool = True
    max_consecutive_nonfinite: int = 5
    grad_accumulation_steps: int = 1
    optimizer: str = "adamw"
    muon_lr_scale: float = 10.0
    muon_momentum: float = 0.95
    muon_ns_steps: int = 5
    contrastive_loss: str = "infonce"  # or "siglip"
    # autosave a resumable mid-epoch checkpoint every N train batches (0: off)
    save_every_steps: int = 0
    patch_drop: float = 0.0
    remat: bool = False
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("attn.qkv", "attn.out", "mlp.fc", "mlp.proj")
    moe: Any = None
    ema_decay: float = 0.0  # 0 disables; else ema = d·ema + (1−d)·params per update
    adam_mu_dtype: str = "float32"  # or "bfloat16": mu stored in bf16
    warmup_steps: int = 0
    gradcache_chunks: int = 0


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a value no lever takes."""
    if cfg.optimizer not in ("adamw", "muon"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.adam_mu_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"adam_mu_dtype {cfg.adam_mu_dtype!r}")
    if cfg.contrastive_loss not in ("infonce", "siglip"):
        raise ValueError(f"contrastive_loss {cfg.contrastive_loss!r}")


@dataclass
class TrainState:
    params: Any
    opt_state: dict
    step: int
    ema_params: Any = None


def _path_key(path) -> str:
    return "/".join(path)


def flat_leaves(tree) -> dict[str, torch.Tensor]:
    """{"clip/visual/blocks/0/attn/qkv/kernel": tensor, ...} in tree order."""
    return {_path_key(p): leaf for p, leaf in iter_paths(tree)}


# -- the optimizer -------------------------------------------------------------


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def schedule_lr(cfg: TrainConfig, steps_per_epoch: int, peak_lr: float, count: int) -> torch.Tensor:
    """The JAX trainer's schedule at optimizer count ``count`` as a float32
    scalar: torch CosineAnnealingLR(T_max=epochs, eta_min=lr·ratio) stepped
    per epoch, after ``warmup_steps`` of linear warmup from 0
    (``optax.join_schedules`` hands the cosine the count past the warmup)."""
    if cfg.warmup_steps > 0:
        if count < cfg.warmup_steps:
            frac = 1.0 - _f32(count) / cfg.warmup_steps
            return (0.0 - peak_lr) * frac + peak_lr
        count -= cfg.warmup_steps
    eta_min = peak_lr * cfg.eta_min_ratio
    epoch = torch.tensor(min(count // max(1, steps_per_epoch), cfg.epochs), dtype=torch.int32)
    return eta_min + 0.5 * (peak_lr - eta_min) * (1.0 + torch.cos(math.pi * epoch / cfg.epochs))


class GroupedAdamW:
    """AdamW in four learning-rate groups over the trainable leaves, with
    clipping by global norm and the finite-update guard (see the module
    docstring for the optax chain it follows). ``labels`` maps a leaf's path
    key to its group: "visual", "text", "classifier", "other" or "frozen";
    under ``optimizer="muon"`` a trainable leaf's label is
    ``"<group>:<muon|adamw>"`` and its Muon leaves take ``muon_direction``
    (momentum ``cfg.muon_momentum``, Nesterov, ``cfg.muon_ns_steps``) at the
    group's rate times ``cfg.muon_lr_scale``, with no weight decay."""

    def __init__(self, cfg: TrainConfig, labels: dict[str, str], steps_per_epoch: int = 1):
        self.cfg = cfg
        self.labels = labels
        self.steps_per_epoch = steps_per_epoch
        self.group_scales = {
            "visual": 1.0, "text": cfg.text_lr_scale,
            "classifier": cfg.classifier_lr_scale, "other": 1.0,
        }
        self.mu_dtype = torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else None

    def trainable(self, flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: v for k, v in flat.items() if self.labels[k] != "frozen"}

    def is_muon(self, key: str) -> bool:
        return self.labels[key].endswith(":muon")

    def init(self, params) -> dict:
        train = self.trainable(flat_leaves(params))
        adam = {k: v for k, v in train.items() if not self.is_muon(k)}
        state = {
            "count": 0,  # the inner AdamW / schedule count
            "notfinite_count": 0,
            "last_finite": True,
            "total_notfinite": 0,
            "mu": {k: torch.zeros_like(v, dtype=self.mu_dtype or v.dtype) for k, v in adam.items()},
            "nu": {k: torch.zeros_like(v) for k, v in adam.items()},
        }
        if self.cfg.optimizer == "muon":
            state["momentum"] = {k: torch.zeros_like(v) for k, v in train.items() if self.is_muon(k)}
        return state

    def learning_rates(self, count: int) -> dict[str, torch.Tensor]:
        """Each group's learning rate at optimizer count ``count`` (and each
        group's Muon rate, "<group>:muon", under ``optimizer="muon"``)."""
        lrs = {
            g: schedule_lr(self.cfg, self.steps_per_epoch, self.cfg.lr * s, count)
            for g, s in self.group_scales.items()
        }
        if self.cfg.optimizer == "muon":
            lrs.update({
                f"{g}:muon": schedule_lr(self.cfg, self.steps_per_epoch,
                                         self.cfg.lr * s * self.cfg.muon_lr_scale, count)
                for g, s in self.group_scales.items()
            })
        return lrs

    @torch.no_grad()
    def grad_stats(self, g: list[torch.Tensor]) -> tuple[bool, torch.Tensor | None]:
        """(whether every gradient is finite, their global norm where
        clipping is on): what ``apply`` decides by. Under FSDP they come from
        the whole gradients, and each slot's update of its shard takes them."""
        finite = True
        if self.cfg.skip_nonfinite_updates:
            finite = bool(torch.stack([torch.isfinite(t).all() for t in g]).all().item())
        return finite, global_norm(g) if self.cfg.grad_clip > 0 else None

    def clipped(self, g: list[torch.Tensor], norm: torch.Tensor | None) -> list[torch.Tensor]:
        """``g`` scaled to the clip where their global ``norm`` reaches it."""
        if self.cfg.grad_clip > 0 and not bool(norm < self.cfg.grad_clip):
            return [(t / norm.to(t.device)) * self.cfg.grad_clip for t in g]
        return g

    def muon(self, grad: torch.Tensor, momentum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A Muon leaf's (update direction, new momentum) from its clipped
        gradient: Nesterov momentum, then Newton–Schulz."""
        return muon_direction(grad, momentum, self.cfg.muon_momentum, True, self.cfg.muon_ns_steps)

    @torch.no_grad()
    def apply(self, params, grads: dict[str, torch.Tensor], state: dict, stats=None,
              muon_fn=None) -> bool:
        """One update of ``params`` (in place) from ``grads`` (path key →
        gradient of every trainable leaf). Returns whether it was applied.
        ``stats``: ``grad_stats`` of the whole gradients, where ``params`` and
        ``grads`` are one slot's shards; ``muon_fn(key, norm)`` then gives a
        Muon leaf's (update, momentum) shards, from the whole matrix."""
        cfg = self.cfg
        flat = self.trainable(flat_leaves(params))
        g = [grads[k] for k in flat]
        finite, norm = self.grad_stats(g) if stats is None else stats
        if cfg.skip_nonfinite_updates:
            state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
            state["last_finite"] = finite
            state["total_notfinite"] += 0 if finite else 1
            if not (finite or state["notfinite_count"] > cfg.max_consecutive_nonfinite):
                return False
        g = self.clipped(g, norm)
        count = state["count"]
        lrs = self.learning_rates(count)
        b1, b2 = cfg.betas
        c1 = 1.0 - _f32(b1) ** (count + 1)
        c2 = 1.0 - _f32(b2) ** (count + 1)
        for (key, p), grad in zip(flat.items(), g):
            dev = p.device
            label = self.labels[key]
            if self.is_muon(key):
                if muon_fn is not None:
                    u, state["momentum"][key] = muon_fn(key, norm)
                else:
                    u, state["momentum"][key] = self.muon(grad, state["momentum"][key])
                p.add_(u * (-lrs[label]).to(dev))
                continue
            # as the JAX trainer's compiled step computes it: b1, a weak scalar,
            # takes mu's dtype (bf16 for a bf16 mu); the product and the sum
            # with (1 - b1) g are fp32
            mu_old = state["mu"][key]
            b1_t = torch.tensor(b1, dtype=mu_old.dtype, device=dev).float()
            mu = (1 - b1) * grad + b1_t * mu_old.float()
            nu = (1 - b2) * (grad * grad) + b2 * state["nu"][key]
            u = (mu / c1.to(dev, mu.dtype)) / (torch.sqrt(nu / c2.to(dev)) + cfg.eps)
            u = u + cfg.weight_decay * p
            p.add_(u * (-lrs[label.split(":")[0]]).to(dev))
            state["mu"][key] = mu.to(self.mu_dtype or mu.dtype)
            state["nu"][key] = nu
        state["count"] = count + 1
        return True


class MultiSteps:
    """``optax.MultiSteps(inner, every_k)``: each call folds its gradients
    into a running mean, ``acc + (g − acc) / (n + 1)`` with n the calls
    since the last update (Welford, as optax computes it); every
    ``every_k``-th call hands the mean to ``inner`` (an optimizer with
    ``init``/``apply``), whose state changes on those calls only, and
    resets the mean to zeros. The other calls leave the params untouched.
    State: ``mini_step``, ``gradient_step`` (updates made), ``acc_grads``
    and ``inner_opt_state``."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = every_k

    def init(self, params) -> dict:
        """``params``: what ``inner.init`` takes (a params tree for
        ``GroupedAdamW``, a dict of leaves for ``variants.AdamW``)."""
        leaves = self.inner.trainable(flat_leaves(params)) if hasattr(self.inner, "trainable") else params
        return {"mini_step": 0, "gradient_step": 0,
                "acc_grads": {k: torch.zeros_like(v) for k, v in leaves.items()},
                "inner_opt_state": self.inner.init(params)}

    @torch.no_grad()
    def apply(self, params, grads: dict[str, torch.Tensor], state: dict, **inner_kw):
        """Fold ``grads`` in; on an emitting call, the inner optimizer's
        ``apply`` of the mean (its result returned). Otherwise False.
        ``inner_kw`` go to the inner ``apply`` (under FSDP ``GroupedAdamW``'s
        ``stats`` and ``muon_fn``, of the whole mean, where ``grads`` are one
        slot's shards)."""
        n = state["mini_step"]
        acc = self.mean(state["acc_grads"], grads, n)
        state["mini_step"] = (n + 1) % self.every_k
        if n != self.every_k - 1:
            state["acc_grads"] = acc
            return False
        state["gradient_step"] += 1
        state["acc_grads"] = {k: torch.zeros_like(a) for k, a in acc.items()}
        return self.inner.apply(params, acc, state["inner_opt_state"], **inner_kw)

    @staticmethod
    def mean(acc: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], n: int) -> dict[str, torch.Tensor]:
        """The running mean after its (n + 1)-th call: ``acc + (g − acc) /
        (n + 1)``, each ``g`` taken to its mean's device."""
        return {k: a + (grads[k].to(a.device) - a) / (n + 1) for k, a in acc.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float) -> dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient scaled by ``max_norm /
    norm`` where their global norm reaches ``max_norm``, else as given."""
    norm = global_norm(list(grads.values()))
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm.to(g.device)) * max_norm for k, g in grads.items()}


def make_optimizer(cfg: TrainConfig, params, steps_per_epoch: int = 1):
    """The JAX trainer's optimizer over ``params`` (``{"clip", "classifier",
    "lora"}``): ``GroupedAdamW``, under ``MultiSteps`` when
    ``grad_accumulation_steps`` > 1."""
    check_supported(cfg)
    labels = flat_leaves(param_group_labels(params, cfg.freeze_layers))
    if cfg.optimizer == "muon":
        # flat combined labels "<group>:<muon|adamw>", as the JAX trainer's
        kinds = flat_leaves(muon_param_labels(params))
        labels = {k: g if g == "frozen" else f"{g}:{kinds[k]}" for k, g in labels.items()}
    opt = GroupedAdamW(cfg, labels, steps_per_epoch)
    if cfg.grad_accumulation_steps > 1:
        return MultiSteps(opt, cfg.grad_accumulation_steps)
    return opt


# -- the step -------------------------------------------------------------------


def patch_keep_count(model_cfg: CLIPConfig, patch_drop: float) -> tuple[int, int]:
    """(patch tokens, patch tokens kept): ``max(1, round(grid² · (1 −
    patch_drop)))`` with Python's round, as the JAX trainer counts them."""
    n_patches = model_cfg.vision.grid ** 2
    return n_patches, max(1, int(round(n_patches * (1.0 - patch_drop))))


def draw_patch_keep(generator, batch: int, n_patches: int, n_keep: int, device) -> torch.Tensor:
    """FLIP's keep mask: per example the first ``n_keep`` indices of an
    argsort of ``n_patches`` uniforms drawn from ``generator`` (unsorted,
    as the JAX trainer's)."""
    u = torch.rand((batch, n_patches), generator=generator, device=device)
    return torch.argsort(u, dim=-1, stable=True)[:, :n_keep]


def _pixels(images, dev) -> torch.Tensor:
    """uint8 [B, S, S, 3] → CLIP-normalised float pixels on ``dev``."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    return (torch.as_tensor(images, device=dev).float() / 255.0 - mean) / std


def make_grad_fn(model_cfg: CLIPConfig, cls_cfg: ClassifierConfig | None, cfg: TrainConfig,
                 mesh=None, axis: str = "data"):
    """``fn(params, batch, generator, train=True) -> (metrics, grads)``:
    the loss of one batch and, with ``train``, the gradient of every
    trainable leaf (path key → tensor; zeros for a leaf the loss does not
    reach). ``batch``: uint8 images [B, S, S, 3], int tokens [B, 77] and int
    labels [B], numpy or tensors. Without ``mesh`` ``params`` is one tree
    and the batch runs on its device, one slot. With ``mesh`` ``params``
    maps each of this process's distinct devices to its tree, and ``batch``
    holds this process's rows of the global batch, split evenly over its
    slots of ``axis``.

    Every random draw is made for the global batch in one order (the
    patch-drop keep sets of ``cfg.patch_drop``, then the classifier's
    dropout mask) and each slot takes its rows. Each slot encodes its rows
    with its own detached aliases of its device's params, the frozen leaves
    (``param_group_labels``) not requiring grad, so their blocks' backward
    skips their products. With ``params["lora"]`` the adapters are merged
    into the towers' kernels inside the forward. The loss is the global
    batch's (``losses.combined_clip_loss``, with ``axis`` over more than one
    slot); the gradients are summed over the local slots in slot order on
    the first slot's device, then over the processes. Over several slots
    the result equals the one-slot step's on the global batch up to the
    order of those sums. ``cfg.gradcache_chunks`` > 1 takes GradCache's
    gradient: over several slots the chunks are of the global batch, each
    chunk's rows encoded by the slots that hold them, the head over the
    whole batch's embeddings on the first slot's device.

    ``params`` may hold ``ShardedTensor`` leaves split over another mesh axis
    (tensor parallelism, ``parallel.tp.lazy_tree``): each slot then gathers
    a block's weights where the block runs, and the gradient of each is the
    whole gradient."""
    check_supported(cfg)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if model_cfg.attn_impl == "auto":
        model_cfg = dataclasses.replace(model_cfg, attn_impl="auto_grad")
    n_patches, n_keep = patch_keep_count(model_cfg, cfg.patch_drop)
    n_slots = 1 if mesh is None else mesh.axis_size(axis)
    use_gradcache = cfg.gradcache_chunks > 1
    if use_gradcache and (cfg.moe is not None or cfg.lora_rank > 0 or cfg.patch_drop > 0.0):
        raise ValueError("gradcache_chunks > 1 is unsupported with moe/lora/patch_drop")
    across = mesh is not None and mesh.process_count > 1
    if use_gradcache and across:
        raise ValueError("gradcache_chunks > 1 runs over the slots of one process")

    def clip_of(params):
        if "lora" in params:
            return merge_lora(params["clip"], params["lora"], cfg.lora_alpha)
        return params["clip"]

    def loss(imgs, txts, clip_ps, logits, labels, whole=False):
        """The global batch's loss: from one slot's rows (``whole``: the
        whole batch's rows on one device), or from each slot's rows."""
        kw = dict(contrastive_weight=cfg.contrastive_weight,
                  classification_weight=cfg.classification_weight,
                  label_smoothing=cfg.label_smoothing, contrastive_impl=cfg.contrastive_loss)
        with_labels = bool(logits) and labels[0] is not None
        if n_slots == 1 or whole:
            return combined_clip_loss(
                imgs[0], txts[0], clip_ps[0]["logit_scale"],
                class_logits=logits[0] if with_labels else None,
                class_labels=labels[0] if with_labels else None,
                logit_bias=clip_ps[0].get("logit_bias"), **kw)
        biases = [c.get("logit_bias") for c in clip_ps]
        return combined_clip_loss(
            imgs, txts, [c["logit_scale"] for c in clip_ps],
            class_logits=logits if with_labels else None,
            class_labels=labels if with_labels else None,
            logit_bias=None if biases[0] is None else biases, axis=axis, mesh=mesh, **kw)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    def gradcache_grads(aliases, per_slot, slots, devices, images, tokens, labels, generator, train_keys):
        """GradCache (``gradcache.gradcache_parts``) over the slots: chunk c
        is rows [c·B/C, (c+1)·B/C) of the global batch, and each slot encodes
        the part of it that it holds (rows [i·b, (i+1)·b)). The head (the
        loss of the whole batch, its gradients for the embeddings and the
        loss-side leaves) runs on the first slot's device."""
        n_chunks = cfg.gradcache_chunks
        total = images.shape[0]
        if total % n_chunks:
            raise ValueError(f"gradcache: batch size {total} not divisible by {n_chunks} chunks")
        b, c = total // len(slots), total // n_chunks
        dev0 = devices[slots[0]]
        clips = [a["clip"] for a in aliases]

        def encoder(i, lo, hi):
            dev = devices[slots[i]]
            return lambda: {"img": encode_image(clips[i], model_cfg, _pixels(images[lo:hi], dev), dtype=dtype),
                            "txt": encode_text(clips[i], model_cfg, tokens[lo:hi].to(dev), dtype=dtype)}

        chunks = [[(i, encoder(i, max(lo, i * b), min(lo + c, (i + 1) * b))) for i in range(len(slots))
                   if max(lo, i * b) < min(lo + c, (i + 1) * b)] for lo in range(0, total, c)]

        def head_fn(emb, _):
            img, txt = unit(emb["img"]), unit(emb["txt"])
            logits = []
            if cls_cfg is not None and aliases[0].get("classifier") is not None:
                logits = [classifier_forward(aliases[0]["classifier"], cls_cfg, img, deterministic=False,
                                             generator=generator)]
            return loss([img], [txt], [clips[0]], logits, [None if labels is None else labels.to(dev0)],
                        whole=True)

        (_, metrics), grads = gradcache_parts(chunks, head_fn, None,
                                              [{k: leaves[k] for k in train_keys} for leaves in per_slot])
        return metrics, grads

    def fn(params, batch, generator=None, train: bool = True):
        replicas = params if mesh is not None else {flat_leaves(params)["clip/logit_scale"].device: params}
        if mesh is not None:
            slots, devices = mesh.leaders(axis), mesh.slot_devices
        else:
            slots, devices = [0], list(replicas)
        images = torch.as_tensor(batch["images"])
        tokens = torch.as_tensor(batch["tokens"])
        labels = None if batch.get("labels") is None else torch.as_tensor(batch["labels"]).long()
        if images.shape[0] % len(slots):
            raise ValueError(f"{images.shape[0]} rows do not split over {len(slots)} local slots")
        b = images.shape[0] // len(slots)
        dev0 = devices[slots[0]]
        some = replicas[dev0]
        with_cls = cls_cfg is not None and some.get("classifier") is not None
        gen_dev = generator.device if generator is not None else dev0
        keep = mask = None
        if train and cfg.patch_drop > 0.0:
            keep = draw_patch_keep(generator, b * n_slots, n_patches, n_keep, gen_dev)
        group = flat_leaves(param_group_labels(some, cfg.freeze_layers))
        train_keys = [k for k, g in group.items() if g != "frozen"]
        if splits_over(some, axis):
            # tensor parallelism: block weights gathered where each block runs
            built = [lazy_aliases(replicas[devices[g]], devices[g],
                                  lambda key: train and group[key] != "frozen", slot=g) for g in slots]
            aliases, per_slot = [a for a, _ in built], [r for _, r in built]
        else:
            aliases = [map_with_paths(replicas[devices[g]], lambda path, t: t.detach().requires_grad_(
                train and group[_path_key(path)] != "frozen")) for g in slots]
            per_slot = [flat_leaves(a) for a in aliases]
        if train and use_gradcache:
            return gradcache_grads(aliases, per_slot, slots, devices, images, tokens, labels, generator,
                                   train_keys)
        if train and with_cls and cls_cfg.dropout > 0.0:
            mask = torch.rand((b * n_slots, cls_cfg.hidden_dim), generator=generator,
                              device=gen_dev) < 1.0 - cls_cfg.dropout
        row0s = [mesh.axis_index(g, axis) * b if mesh is not None else 0 for g in slots]
        imgs, txts, logits, lbls = [], [], [], []
        with torch.enable_grad() if train else torch.no_grad():
            clip_ps = [clip_of(a) for a in aliases]
            # the towers over the slots (an MoE layer on the global batch's
            # token groups, as on one device: models.moe.run_blocks_moe_slots)
            feats, aux_i = encode_image_slots(
                clip_ps, model_cfg, cfg.moe, [_pixels(images[i * b:(i + 1) * b], devices[g])
                                              for i, g in enumerate(slots)], dtype,
                None if keep is None else [keep[r:r + b].to(devices[g]) for r, g in zip(row0s, slots)],
                row0s, b * n_slots)
            txt_feats, aux_t = encode_text_slots(
                clip_ps, model_cfg, cfg.moe, [tokens[i * b:(i + 1) * b].to(devices[g]) for i, g in enumerate(slots)],
                dtype, row0s, b * n_slots)
            for i, g in enumerate(slots):
                img = unit(feats[i])
                imgs.append(img)
                txts.append(unit(txt_feats[i]))
                if with_cls:
                    logits.append(classifier_forward(
                        aliases[i]["classifier"], cls_cfg, img, deterministic=not train,
                        keep_mask=None if mask is None else mask[row0s[i]:row0s[i] + b].to(devices[g])))
                    lbls.append(None if labels is None else labels[i * b:(i + 1) * b].to(devices[g]))
            total, metrics = loss(imgs, txts, clip_ps, logits, lbls)
            if cfg.moe is not None:
                # the Switch term of the global batch, the mean over every
                # token group: the sum of each slot's share (slot_mean over 1)
                aux = slot_mean([(a + t.to(a.device)).to(dev0) for a, t in zip(aux_i, aux_t)], 1)
                total = total + _f32(cfg.moe.aux_weight).to(dev0) * aux
                metrics = {**metrics, "total_loss": total, "moe_aux": aux}
            metrics = {k: v.detach() for k, v in metrics.items()}
            if not train:
                return metrics, None
            leaves = [(i, k, per_slot[i][k]) for i in range(len(slots)) for k in train_keys]
            flat = iter(torch.autograd.grad(total, [t for _, _, leaf in leaves for t in input_parts(leaf)],
                                            allow_unused=True))
            grads = {(i, k): whole_grad(leaf, [next(flat) for _ in input_parts(leaf)], dev0)
                     for i, k, leaf in leaves}
        out = {}
        for k in train_keys:
            acc = None
            for i in range(len(slots)):  # slot order
                gr = grads[(i, k)]
                acc = gr if acc is None else acc + gr.to(dev0)
            out[k] = acc
        return metrics, _sum_grads_over_processes(out) if across else out

    return fn


def _sum_grads_over_processes(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every process's gradients summed (one ``all_reduce`` a dtype over the
    flattened leaves)."""
    from evr_tpu_torch.parallel import multihost

    out = dict(grads)
    for dtype in {g.dtype for g in grads.values()}:
        keys = [k for k, g in grads.items() if g.dtype == dtype]
        flat = multihost.sum_over_processes(torch.cat([grads[k].reshape(-1) for k in keys]))
        for k, part in zip(keys, flat.split([grads[k].numel() for k in keys])):
            out[k] = part.view(grads[k].shape)
    return out


def _ema_update(cfg: TrainConfig, ema, params) -> None:
    """ema = d·ema + (1 − d)·params in fp32, leaf by leaf (shard by shard
    for ``ShardedTensor`` leaves)."""
    from evr_tpu_torch.parallel.fsdp import ShardedTensor

    d = _f32(cfg.ema_decay)
    with torch.no_grad():
        for e, p in zip(flat_leaves(ema).values(), flat_leaves(params).values()):
            pairs = zip(e.shards, p.shards) if isinstance(e, ShardedTensor) else [(e, p)]
            for es, ps in pairs:
                dd = d.to(es.device)
                es.copy_((es.float() * dd + ps.float() * (1.0 - dd)).to(es.dtype))


def _fsdp_apply(optimizer, state: TrainState, grads: dict[str, torch.Tensor], mesh) -> None:
    """Each local slot's update of its shards: its shard of the whole
    gradients (under ``MultiSteps``, of the whole running mean), the clip and
    finite decisions from the whole ones, the AdamW update of its shard of
    the params and moments; a Muon leaf's Newton–Schulz runs once on the
    whole matrix (the momentum gathered from the slots) and each slot takes
    its shard of the update and of the new momentum."""
    from evr_tpu_torch.parallel.fsdp import ShardedTensor, shard_of, slot_view, write_back

    flat = flat_leaves(state.params)
    opt_state, inner, whole = state.opt_state, optimizer, grads
    emitting = True
    if isinstance(optimizer, MultiSteps):
        n = opt_state["mini_step"]
        emitting = n == optimizer.every_k - 1
        acc = {k: a.full() if isinstance(a, ShardedTensor) else a for k, a in opt_state["acc_grads"].items()}
        whole = optimizer.mean(acc, grads, n)
        inner, opt_state = optimizer.inner, opt_state["inner_opt_state"]
    stats = inner.grad_stats([whole[k] for k in whole]) if emitting else None
    muon = emitting and inner.cfg.optimizer == "muon"
    if muon:
        done = {}

        def whole_muon(key, norm):
            if key not in done:
                (g,) = inner.clipped([whole[key]], norm)
                buf = opt_state["momentum"][key]
                done[key] = inner.muon(g, buf.full(g.device) if isinstance(buf, ShardedTensor) else buf)
            return done[key]

    slots = mesh.local_slots
    views = [slot_view(state.opt_state, i) for i in range(len(slots))]
    for i, g in enumerate(slots):
        dev = mesh.slot_devices[g]
        shard_grads = {k: shard_of(v, flat[k].sharding, g).to(dev) for k, v in grads.items()}
        fn = None
        if muon:
            def fn(key, norm, g=g, dev=dev):
                u, buf = whole_muon(key, norm)
                sh = flat[key].sharding
                return shard_of(u, sh, g).to(dev), shard_of(buf, sh, g).to(dev).clone()
        optimizer.apply(slot_view(state.params, i), shard_grads, views[i], stats=stats, muon_fn=fn)
    for i, view in enumerate(views):
        state.opt_state = write_back(state.opt_state, view, i)


def make_train_step(
    model_cfg: CLIPConfig,
    cls_cfg: ClassifierConfig | None,
    cfg: TrainConfig,
    optimizer: GroupedAdamW | MultiSteps,
    mesh=None,
    axis: str = "data",
    state_shardings=None,
) -> tuple[Callable, Callable]:
    """``(step, eval_step)``: ``step(state, batch, generator) -> (state,
    metrics)`` runs the loss, its gradients and one optimizer call (params
    and moments updated in place; under ``MultiSteps`` an update on every
    k-th call) and adds ``grad_norm``, the raw norm over the trainable
    leaves before clipping; the step count and the EMA advance on every
    call. ``eval_step(state, batch) -> metrics`` is the deterministic
    forward (no dropout, no patch drop).

    With ``mesh`` the batch (this process's rows of the global batch) is
    split over the slots of ``axis`` (``make_grad_fn``) and the step
    equals the one-device step on the global batch. Data parallelism keeps
    the params once, on the first slot's device, with a copy on each other
    distinct device. With ``state_shardings`` the state is a tree of
    ``ShardedTensor``s and each slot updates its own shards
    (``_fsdp_apply``; AdamW or Muon, with or without ``MultiSteps``):
    ``parallel.fsdp.fsdp_state_shardings`` splits over ``axis`` and the
    whole params are gathered once per distinct device for the gradients;
    ``parallel.tp.tp_state_shardings`` splits the block weights over the
    model axis of a ``("data", "model")`` mesh, and each slot gathers a
    block's weights where the block runs (``parallel.tp.lazy_tree``)."""
    grad_fn = make_grad_fn(model_cfg, cls_cfg, cfg, mesh, axis)

    def params_of(state):
        """The params tree, or over a mesh the params once per distinct local
        device."""
        if mesh is None:
            return state.params
        if state_shardings is not None:
            return {d: lazy_tree(state.params, d, axis) for d in mesh.local_devices}
        master = state.params
        home = flat_leaves(master)["clip/logit_scale"].device
        return {d: master if d == home else _to_device(master, d) for d in mesh.local_devices}

    def step(state: TrainState, batch, generator=None):
        metrics, grads = grad_fn(params_of(state), batch, generator, True)
        metrics["grad_norm"] = global_norm(grads.values())
        if state_shardings is not None:
            _fsdp_apply(optimizer, state, grads, mesh)
        else:
            optimizer.apply(state.params, grads, state.opt_state)
        if cfg.ema_decay > 0.0 and state.ema_params is not None:
            _ema_update(cfg, state.ema_params, state.params)
        state.step += 1
        return state, metrics

    def eval_step(state: TrainState, batch):
        return grad_fn(params_of(state), batch, None, False)[0]

    return step, eval_step


# -- the trainer ----------------------------------------------------------------


class PreemptionStop(Exception):
    """Raised inside the train loop after a SIGTERM-triggered autosave."""


def _to_device(tree, device):
    """A params tree (numpy arrays or tensors) as fresh tensors on
    ``device``, never aliases of the caller's: the step updates in place."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone()
    return params_from_numpy(tree, device)


def _detached(tree):
    return map_with_paths(tree, lambda _, t: t.detach() if isinstance(t, torch.Tensor) else t)


class Trainer:
    """End-to-end fine-tune loop: epochs, validation, early stopping,
    best/final checkpoints, resume (epoch-level and mid-epoch autosave).
    Runs on ``cuda`` unless ``device="cpu"`` is asked for, or over ``mesh``
    (``parallel.mesh``): data parallelism, or with ``fsdp=True`` the params,
    the optimizer state and the EMA sharded over the slots
    (``parallel.fsdp``); a mesh with a ``model`` axis of more than one slot
    shards the block weights over it (``parallel.tp``). Across processes (``parallel.multihost``) each
    process feeds its rows of the global batch; only the coordinator writes
    checkpoints, whole trees gathered from the shards."""

    def __init__(
        self,
        model_cfg: CLIPConfig,
        clip_params,
        cfg: TrainConfig | None = None,
        classifier_params=None,
        cls_cfg: ClassifierConfig | None = None,
        steps_per_epoch: int = 1,
        log_fn: Callable[[str], None] = print,
        device=None,
        mesh=None,
        fsdp: bool = False,
    ):
        """``device``: without a mesh (None = the card). ``mesh``: the
        trainer runs on its slots and ``device`` is its first local slot's;
        ``fsdp`` needs one."""
        self.cfg = cfg or TrainConfig()
        check_supported(self.cfg)
        if fsdp and mesh is None:
            raise ValueError("fsdp=True requires a mesh")
        if fsdp and "expert" in mesh.axis_names:
            raise ValueError(
                "fsdp=True with an 'expert' mesh axis is unsupported — pick one state layout "
                "(ZeRO-3 over data, or experts over expert)")
        if self.cfg.moe is not None and self.cfg.lora_rank > 0:
            raise ValueError("lora_rank > 0 with cfg.moe is unsupported: LoRA targets the dense mlp "
                             "kernels MoE replaces with expert stacks")
        tensor_parallel = mesh is not None and mesh.shape.get("model", 1) > 1
        expert_parallel = self.cfg.moe is not None and mesh is not None and "expert" in mesh.axis_names
        if fsdp and tensor_parallel:
            raise ValueError("fsdp=True with a 'model' mesh axis is unsupported — pick one state layout "
                             "(ZeRO-3 over data, or tensor parallelism over model)")
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.slot_devices[mesh.local_slots[0]])
        self._multihost = mesh is not None and mesh.process_count > 1
        if self.cfg.remat and not model_cfg.remat:
            model_cfg = dataclasses.replace(model_cfg, remat=True)
        self.model_cfg = model_cfg
        self.cls_cfg = cls_cfg or (
            ClassifierConfig(embed_dim=model_cfg.embed_dim)
            if classifier_params is not None else None
        )
        self.log = log_fn
        if self.cfg.moe is not None and not has_moe(clip_params):
            # Sparse Upcycling: every expert starts as the dense MLP
            clip_params = upcycle_clip_params(torch.Generator().manual_seed(self.cfg.seed + 2), clip_params,
                                              model_cfg, self.cfg.moe)
            log_fn(f"moe: sparse-upcycled dense init to {self.cfg.moe.n_experts} experts "
                   f"(top-{self.cfg.moe.router_k})")
        params = {"clip": clip_params}
        if classifier_params is not None:
            params["classifier"] = classifier_params
        params = _to_device(params, self.device)
        if self.cfg.contrastive_loss == "siglip" and "logit_bias" not in params["clip"]:
            # SigLIP's learnable bias, init -10 (arxiv 2303.15343 §3)
            params["clip"]["logit_bias"] = torch.tensor(-10.0, device=self.device)
        if self.cfg.lora_rank > 0:
            # drawn on the CPU from seed + 1, then moved (the same draw on every device)
            params["lora"] = _to_device(init_lora(
                torch.Generator().manual_seed(self.cfg.seed + 1), params["clip"], self.cfg.lora_rank,
                targets=self.cfg.lora_targets), self.device)
        self.optimizer = make_optimizer(self.cfg, params, steps_per_epoch)
        ema_on = self.cfg.ema_decay > 0.0
        self._state_shardings = None
        if fsdp or tensor_parallel or expert_parallel:
            from evr_tpu_torch.parallel.ep import ep_state_shardings
            from evr_tpu_torch.parallel.fsdp import fsdp_state_shardings, shard_tree
            from evr_tpu_torch.parallel.tp import tp_state_shardings

            # experts and their moments over the expert axis, the batch over data
            plan = (tp_state_shardings if tensor_parallel else
                    ep_state_shardings if expert_parallel else fsdp_state_shardings)
            self._state_shardings = sh = plan(params, self.optimizer, mesh, ema=ema_on)
            self.state = TrainState(
                params=shard_tree(params, sh.params),
                opt_state=shard_tree(self.optimizer.init(params), sh.opt_state),
                step=0,
                ema_params=shard_tree(params, sh.params) if ema_on else None,
            )
        else:
            self.state = TrainState(
                params=params,
                opt_state=self.optimizer.init(params),
                step=0,
                ema_params=_to_device(params, self.device) if ema_on else None,
            )
        self.train_step, self.eval_step = make_train_step(
            model_cfg, self.cls_cfg, self.cfg, self.optimizer, mesh,
            state_shardings=self._state_shardings,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.history: list[dict] = []
        self.checkpoint_seconds: list[tuple[str, float]] = []
        self._preempted = False

    def merged_clip_params(self):
        """The CLIP params the model serves: with LoRA, the adapters folded
        into the dense kernels (``lora.merge_lora``, detached); the base
        params otherwise."""
        params = self._whole(self.state.params)
        with torch.no_grad():
            if "lora" in params:
                return _detached(merge_lora(params["clip"], params["lora"], self.cfg.lora_alpha))
            return _detached(params["clip"])

    def evaluate_retrieval(self, batches) -> dict:
        """Retrieval validation over ``batches`` (R@1/5/10 and MRR both
        directions, ``evaluation.retrieval.evaluate_retrieval``) of the
        served params (``merged_clip_params``), in the compute dtype, row i
        of the images against row i of the captions."""
        from evr_tpu_torch.evaluation.retrieval import evaluate_retrieval

        dtype = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32
        mean = np.asarray(CLIP_MEAN, np.float32)
        std = np.asarray(CLIP_STD, np.float32)
        clip_p = self.merged_clip_params()
        imgs, txts = [], []
        with torch.no_grad():
            for batch in batches:
                x = (np.asarray(batch["images"], np.float32) / 255.0 - mean) / std
                x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                tokens = torch.as_tensor(batch["tokens"], device=self.device)
                img = image_features(clip_p, self.model_cfg, self.cfg.moe, x, dtype)[0]
                txt = text_features(clip_p, self.model_cfg, self.cfg.moe, tokens, dtype)[0]
                imgs.append(img.cpu().numpy())
                txts.append(txt.cpu().numpy())
        img, txt = np.concatenate(imgs), np.concatenate(txts)
        ids = list(range(len(img)))
        return evaluate_retrieval(img, txt, ids, ids, device=self.device)

    def install_preemption_autosave(self, signals=None) -> None:
        """SIGTERM sets a flag the train loop checks per batch: the next
        batch boundary writes a resumable 'autosave' checkpoint and fit()
        returns with ``preempted=True``."""
        import signal as _signal

        for s in signals or (_signal.SIGTERM,):
            _signal.signal(s, lambda signum, frame: setattr(self, "_preempted", True))

    def _whole(self, tree):
        """``tree`` itself, or under FSDP gathered from its shards onto the
        trainer's device (a collective: every process calls it)."""
        if self._state_shardings is None or tree is None:
            return tree
        from evr_tpu_torch.parallel.fsdp import gather_tree

        return gather_tree(tree, self.device)

    # -- checkpointing ----------------------------------------------------
    def checkpoint_path(self, name: str) -> pathlib.Path:
        return pathlib.Path(self.cfg.save_dir).absolute() / f"{name}.pt"

    def save_checkpoint(self, name: str, epoch: int, metrics: dict, extra: dict | None = None) -> None:
        """One torch file ``<save_dir>/<name>.pt`` with the JAX trainer's
        payload keys: params (with ``lora`` under LoRA), opt_state (Muon's
        momentum; under accumulation the mini step, the gradient step and
        the accumulated gradients), step, epoch, metrics (and ema; under
        MoE ``moe``, the ``MoEConfig`` as a dict). Written to a temporary
        name, then renamed. Under FSDP the trees are gathered whole first;
        across processes only the coordinator writes, and every process
        waits for the file."""
        from evr_tpu_torch.parallel import multihost

        t0 = time.perf_counter()
        path = self.checkpoint_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "params": _detached(self._whole(self.state.params)),
            "opt_state": self._whole(self.state.opt_state),
            "step": int(self.state.step),
            "epoch": int(epoch),
            "metrics": {k: float(v) for k, v in metrics.items()},
            **(extra or {}),
        }
        if self.cfg.moe is not None:
            # self-describing: serving rebuilds the MoEConfig from the file
            payload["moe"] = dataclasses.asdict(self.cfg.moe)
        if self.state.ema_params is not None:
            payload["ema"] = self._whole(self.state.ema_params)
        if multihost.is_coordinator():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
        multihost.barrier("evr-ckpt")
        seconds = time.perf_counter() - t0
        self.checkpoint_seconds.append((name, seconds))
        self.log(f"checkpoint {name}: {path.stat().st_size / 1e9:.2f} GB in {seconds:.1f} s")

    def restore_checkpoint(self, name: str) -> dict:
        """Full-state restore: params (LoRA's adapters too), optimizer
        moments, momentum, counts and accumulator, step, and the EMA
        (restarted from the params when the file has none)."""
        payload = torch.load(self.checkpoint_path(name), map_location=self.device, weights_only=True)
        ema = None
        if self.cfg.ema_decay > 0.0:
            ema = _to_device(payload.get("ema", payload["params"]), self.device)
        params, opt_state = payload["params"], payload["opt_state"]
        if self._state_shardings is not None:
            # each slot takes its slice of the whole restored trees
            from evr_tpu_torch.parallel.fsdp import shard_tree

            sh = self._state_shardings
            params = shard_tree(params, sh.params)
            opt_state = shard_tree(opt_state, sh.opt_state)
            ema = None if ema is None else shard_tree(ema, sh.params)
        self.state = TrainState(
            params=params, opt_state=opt_state, step=int(payload["step"]), ema_params=ema,
        )
        return payload

    # -- loops ------------------------------------------------------------
    def _autosave(self, epoch: int, batches_done: int) -> None:
        self.save_checkpoint("autosave", epoch, {}, extra={"batches_done": batches_done})

    def _run_epoch(self, batches, train: bool = True, epoch: int | None = None,
                   skip_batches: int = 0) -> dict:
        """``skip_batches`` fast-forwards a deterministic epoch iterator to
        resume mid-epoch from an autosave (the skipped batches are never
        staged)."""
        import itertools

        from .data import prefetch_batches

        it = iter(batches)
        if skip_batches:
            it = itertools.islice(it, skip_batches, None)
        agg: dict[str, list[float]] = {}
        n = 0
        for batch in prefetch_batches(it):
            if train:
                self.state, metrics = self.train_step(self.state, batch, self.generator)
            else:
                metrics = self.eval_step(self.state, batch)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(float(v))
            n += 1
            if train and epoch is not None:
                done = skip_batches + n
                if self._preempted:
                    self._autosave(epoch, done)
                    raise PreemptionStop
                if self.cfg.save_every_steps and done % self.cfg.save_every_steps == 0:
                    self._autosave(epoch, done)
        return {k: float(np.mean(v)) for k, v in agg.items()} | {"batches": n}

    def plot_history(self, out_path) -> None:
        """Loss/accuracy curves PNG (matplotlib, imported here)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        epochs = [r["epoch"] for r in self.history]
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for ax, keys, ylabel in (
            (axes[0], ("train_total_loss", "val_total_loss"), "loss"),
            (axes[1], ("train_classification_accuracy", "val_classification_accuracy"),
             "classification accuracy"),
        ):
            for key, label in zip(keys, ("train", "val")):
                vals = [r.get(key) for r in self.history]
                if any(v is not None for v in vals):
                    ax.plot(epochs, vals, label=label)
            ax.set_xlabel("epoch")
            ax.set_ylabel(ylabel)
            ax.legend()
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)

    def fit(self, train_batches_fn, val_batches_fn=None, resume_from: str | None = None) -> dict:
        """``train_batches_fn(epoch) -> iterator of batches`` (and likewise
        for validation). ``resume_from`` restores a saved checkpoint and
        continues from its epoch + 1, or inside its epoch after a mid-epoch
        autosave. Returns the best validation loss, its epoch, the history
        and the seconds of each checkpoint save."""
        best_val, best_epoch, patience = math.inf, -1, 0
        start_epoch, resume_skip = 0, 0
        if resume_from is not None:
            payload = self.restore_checkpoint(resume_from)
            resume_skip = int(payload.get("batches_done", 0))
            if resume_skip > 0:  # mid-epoch autosave: re-enter the same epoch
                start_epoch = int(payload.get("epoch", 0))
                self.log(f"resumed from {resume_from} mid-epoch {start_epoch} "
                         f"(skipping {resume_skip} consumed batches)")
            else:
                start_epoch = int(payload.get("epoch", -1)) + 1
                self.log(f"resumed from {resume_from} at epoch {start_epoch}")
        for epoch in range(start_epoch, self.cfg.epochs):
            t0 = time.time()
            try:
                train_metrics = self._run_epoch(
                    train_batches_fn(epoch), train=True, epoch=epoch,
                    skip_batches=resume_skip if epoch == start_epoch else 0,
                )
            except PreemptionStop:
                self.log("preempted — mid-epoch state autosaved to 'autosave'")
                return {"preempted": True, "best_val_loss": best_val, "best_epoch": best_epoch,
                        "history": self.history, "checkpoint_seconds": self.checkpoint_seconds}
            row = {"epoch": epoch, **{f"train_{k}": v for k, v in train_metrics.items()}}
            if val_batches_fn is not None:
                val_metrics = self._run_epoch(val_batches_fn(epoch), train=False)
                row |= {f"val_{k}": v for k, v in val_metrics.items()}
                val_loss = val_metrics.get("total_loss", math.inf)
                if val_loss < best_val:
                    best_val, best_epoch, patience = val_loss, epoch, 0
                    self.save_checkpoint("best_model", epoch, val_metrics)
                else:
                    patience += 1
            row["seconds"] = time.time() - t0
            self.history.append(row)
            self.log(f"[epoch {epoch}] " + " ".join(
                f"{k}={v:.4g}" for k, v in row.items() if k != "epoch"))
            if val_batches_fn is not None and patience >= self.cfg.early_stopping:
                self.log(f"early stopping at epoch {epoch} (best epoch {best_epoch})")
                break
        self.save_checkpoint("final_checkpoint", len(self.history) - 1, {})
        return {"best_val_loss": best_val, "best_epoch": best_epoch, "history": self.history,
                "checkpoint_seconds": self.checkpoint_seconds}
