"""Exploratory trainer variants (T2–T6 in SURVEY.md §2.3) on one device.

Counterpart of ``evr_tpu/training/variants.py``:

- ``multimodal_loss`` — the α/β/γ-weighted CE + InfoNCE loss shared by the
  fusion trainers (`training_CLIP.py:129-165`), with the V2 extensions
  (label smoothing, entropy regularizer, manual L2 of the heads' kernels —
  `train_CLIP_v3.py:235-298`) switched on by config;
- ``ProjectionTrainer`` — frozen CLIP + learned projection pair + learnable
  logit_scale, InfoNCE (`training_CLIP_multimodal.py` /
  `training_CLIP_contrastive.py`);
- ``ProgressiveTrainer`` — the 3-phase unfreezing schedule
  (`train_CLIP_v3.py:133-179`): phase 1 heads-only, phase 2 last-3 blocks of
  both towers + projections + final LNs, phase 3 full unfreeze with
  discriminative LRs (early blocks lr/10, late lr/3); linear-warmup cosine
  schedule per phase (warmup 10%) and a cross-phase resume guard;
- ``mine_hard_negatives`` / ``hard_negative_infonce`` — the NSFW trainer's
  top-k off-diagonal mining (`train_clip_nsfw.py:194-211`), fed to the loss
  as an opt-in up-weighting;
- ``CatLIPTrainer`` — CatLIP-style pretraining (arXiv 2404.15653): the image
  tower + a multi-label BCE head over caption concepts, no text tower.

The optimizers are written out to follow the optax transformations the JAX
trainers chain (``AdamW``, ``PhaseOptimizer``):

- ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8) decays every leaf it updates,
  biases and LayerNorm parameters included, by the scheduled rate;
- the progressive trainer clips by the global norm of *every* gradient, the
  frozen towers' too, before ``multi_transform`` hands each label its AdamW
  and the "frozen" label ``set_to_zero``. The towers' backward therefore runs
  in every phase;
- each phase starts a ``warmup_cosine_decay_schedule(0, peak, ...)``: its
  first step has rate 0 and leaves the params bit-equal (its moments still
  take the step's gradient).

Params are updated in place. The towers route their blocks as the JAX
trainers pin them (``attn_impl="auto_grad"``: the fused kernels K1/K2 forward
and K5b/K5a backward at T ≥ 512, the plain composition below); inference
(``encode_projected``) keeps the configuration it was given ("auto": K1/K2 on
the card). The fusion dropout draws from a ``torch.Generator`` (per step,
seeded with the step's index unless one is passed). The projection trainer's
levers follow the JAX trainer: ``grad_accumulation_steps`` > 1 runs its AdamW
under ``finetune.MultiSteps`` (optax ``MultiSteps``), and ``freeze_clip=False``
trains the whole CLIP with rematerialised blocks (``CLIPConfig.remat``) while
``encode_projected`` keeps the configuration it was given. Over a mesh its
tower encodes are split over the slots (``ProjectionTrainer``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from evr_tpu_torch.models.clip import CLIPConfig, encode_image, encode_text
from evr_tpu_torch.models.heads import (
    FusionConfig,
    ProjectionConfig,
    _generator,
    fusion_forward,
    init_fusion_params,
    init_projection_params,
    project_features,
)
from evr_tpu_torch.models.layers import linear
from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
from evr_tpu_torch.utils.device import resolve_device

from .finetune import MultiSteps, _f32, _to_device, clip_by_global_norm, flat_leaves
from .losses import softmax_cross_entropy
from .partition import map_with_paths


# -- shared loss -----------------------------------------------------------


def multimodal_loss(
    outputs: dict[str, torch.Tensor],
    labels: torch.Tensor,
    alpha: float = 0.7,
    beta: float = 0.15,
    gamma: float = 0.15,
    temp: float = 0.07,
    label_smoothing: float = 0.0,
    entropy_weight: float = 0.0,
    weight_decay: float = 0.0,
    trainable_params: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    fusion_loss = softmax_cross_entropy(outputs["fused_logits"], labels, label_smoothing).mean()
    image_loss = softmax_cross_entropy(outputs["image_logits"], labels, label_smoothing).mean()
    text_loss = softmax_cross_entropy(outputs["text_logits"], labels, label_smoothing).mean()

    img, txt = outputs["image_features"], outputs["text_features"]
    logits = (img @ txt.T) / temp
    targets = torch.arange(logits.shape[0], device=logits.device)
    contrastive = 0.5 * (
        softmax_cross_entropy(logits, targets, label_smoothing).mean()
        + softmax_cross_entropy(logits.T, targets, label_smoothing).mean()
    )

    total = alpha * fusion_loss + beta * image_loss + gamma * text_loss + contrastive
    metrics = {
        "fusion_loss": fusion_loss,
        "image_loss": image_loss,
        "text_loss": text_loss,
        "contrastive_loss": contrastive,
    }

    if entropy_weight > 0:
        probs = torch.softmax(outputs["fused_logits"].float(), dim=1)
        entropy = -(probs * torch.log(probs + 1e-6)).sum(1).mean()
        total = total - entropy_weight * entropy  # maximise prediction entropy
        metrics["fusion_entropy"] = entropy

    if weight_decay > 0 and trainable_params is not None:
        # the norm of each kernel, not its square (`train_CLIP_v3.py:235-298`)
        l2 = sum(torch.linalg.vector_norm(leaf) for _, leaf in _iter_kernels(trainable_params))
        total = total + weight_decay * l2
        metrics["l2"] = l2

    metrics["total_loss"] = total
    return total, metrics


def _iter_kernels(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_kernels(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_kernels(v, prefix + (str(i),))
    else:
        if prefix and prefix[-1] in ("kernel",):  # torch 'weight' equivalent
            yield prefix, tree


# -- hard negatives (T6) ---------------------------------------------------


def mine_hard_negatives(similarity: torch.Tensor, k: int = 4) -> torch.Tensor:
    """Indices [B, k] of the hardest off-diagonal texts per image; of tied
    scores the lower index comes first (a stable descending sort, as
    ``lax.top_k`` orders them)."""
    B = similarity.shape[0]
    masked = similarity - 1e9 * torch.eye(B, dtype=similarity.dtype, device=similarity.device)
    return torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :k]


def hard_negative_infonce(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    k: int = 4,
    hard_weight: float = 1.0,
) -> torch.Tensor:
    """InfoNCE where the k hardest negatives get up-weighted — the loss the
    reference's mining was presumably meant to feed."""
    scale = torch.exp(logit_scale)
    logits = scale * image_features @ text_features.T
    B = logits.shape[0]
    targets = torch.arange(B, device=logits.device)
    if hard_weight != 1.0:
        hard_idx = mine_hard_negatives(logits, k)
        weights = torch.ones_like(logits).scatter(1, hard_idx, hard_weight)
        logits = logits + torch.log(weights)
    return 0.5 * (
        softmax_cross_entropy(logits, targets).mean()
        + softmax_cross_entropy(logits.T, targets).mean()
    )


# -- the optimizers -----------------------------------------------------------


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], torch.Tensor]:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps,
    decay_steps, end_value)`` as a function of the count, in float32: a
    linear ramp from 0 (exactly 0 at count 0), then a cosine from ``peak`` to
    ``end_value`` over ``decay_steps - warmup_steps``."""
    cosine_steps = decay_steps - warmup_steps
    alpha = 0.0 if peak == 0.0 else end_value / peak

    def lr(count: int) -> torch.Tensor:
        if count < warmup_steps:
            frac = 1 - _f32(count) / warmup_steps
            return (0.0 - peak) * frac + peak
        c = _f32(min(count - warmup_steps, cosine_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / cosine_steps))
        return peak * ((1 - alpha) * cosine ** 1.0 + alpha)

    return lr


class AdamW:
    """``optax.adamw`` over a dict of leaves (path key → tensor): Adam's
    moments with bias correction, ``+ weight_decay * param`` on every leaf,
    times minus the learning rate (a float, or a function of the count
    before it increments returning a float32 scalar)."""

    def __init__(self, learning_rate, weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "nu": {k: torch.zeros_like(v) for k, v in leaves.items()},
        }

    @torch.no_grad()
    def apply(self, leaves: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], state: dict) -> None:
        """Update ``leaves`` in place from ``grads`` (same keys)."""
        count = state["count"] + 1
        c1 = 1 - _f32(self.b1) ** _f32(count)
        c2 = 1 - _f32(self.b2) ** _f32(count)
        lr = self.learning_rate
        step = -(lr(state["count"]) if callable(lr) else lr)
        for key, p in leaves.items():
            g = grads[key]
            mu = (1 - self.b1) * g + self.b1 * state["mu"][key]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"][key]
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * step)
            state["mu"][key], state["nu"][key] = mu, nu
        state["count"] = count


class PhaseOptimizer:
    """``optax.chain(clip_by_global_norm(max_norm), multi_transform(
    transforms, labels))`` with ``set_to_zero`` for the "frozen" label:
    the clip reads the global norm of every gradient it is given, frozen
    leaves' included; each other label's leaves go to its ``AdamW``."""

    def __init__(self, labels: dict[str, str], transforms: dict[str, AdamW], max_norm: float = 1.0):
        self.labels = labels
        self.transforms = transforms
        self.max_norm = max_norm

    def _of(self, flat: dict, label: str) -> dict:
        return {k: v for k, v in flat.items() if self.labels[k] == label}

    def init(self, params) -> dict:
        flat = flat_leaves(params)
        return {label: tx.init(self._of(flat, label)) for label, tx in self.transforms.items()}

    @torch.no_grad()
    def apply(self, params, grads: dict[str, torch.Tensor], state: dict) -> None:
        flat = flat_leaves(params)
        grads = clip_by_global_norm({k: grads[k] for k in flat}, self.max_norm)
        for label, tx in self.transforms.items():
            tx.apply(self._of(flat, label), grads, state[label])


def _requires_grad(leaves: dict[str, torch.Tensor], flag: bool) -> None:
    for leaf in leaves.values():
        leaf.requires_grad_(flag)


def _gradients(loss_fn, leaves: dict[str, torch.Tensor]):
    """(loss metrics, gradient of every leaf in ``leaves``, zeros where the
    loss does not reach it)."""
    _requires_grad(leaves, True)
    try:
        with torch.enable_grad():
            loss, metrics = loss_fn()
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    finally:
        _requires_grad(leaves, False)
    grads = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def _compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _pixels(images, device) -> torch.Tensor:
    """uint8 images [B, S, S, 3] → CLIP-normalised float32 pixels on ``device``."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device)
    return (torch.as_tensor(images, device=device).float() / 255.0 - mean) / std


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _training_cfg(model_cfg: CLIPConfig) -> CLIPConfig:
    # gradient steps resolve "auto" per shape, as the JAX trainers pin it
    if model_cfg.attn_impl == "auto":
        return dataclasses.replace(model_cfg, attn_impl="auto_grad")
    return model_cfg


def _metrics_out(metrics: dict[str, torch.Tensor]) -> dict:
    return {k: float(v) for k, v in metrics.items()}


# -- projection trainer (T3/T4) -------------------------------------------


@dataclass
class ProjectionTrainConfig:
    proj_dim: int = 256
    freeze_clip: bool = True
    lr: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 10
    grad_accumulation_steps: int = 1
    compute_dtype: str = "bfloat16"
    num_classes: int = 0  # >0 adds a classification head on projected image feats (T4)
    classification_weight: float = 0.2


class ProjectionTrainer:
    """Frozen (or, with ``freeze_clip=False``, rematerialised and trained)
    CLIP with a trained projection pair. ``seed`` (or a ``torch.Generator``)
    draws the heads' init on the CPU; ``device``: None means the card
    (raises without one), "cpu" on request. ``mesh`` (one process): each
    batch's tower encodes are split evenly over the slots, each on its
    device, and the features gathered onto the first slot's device in slot
    order, where the heads and the loss run on the whole batch (the JAX
    trainer's step on the same batch); a tower being trained takes its
    gradients back through the copies."""

    def __init__(
        self,
        model_cfg: CLIPConfig,
        clip_params,
        cfg: ProjectionTrainConfig | None = None,
        seed: torch.Generator | int = 0,
        mesh=None,
        device=None,
    ):
        self.cfg = cfg or ProjectionTrainConfig()
        self.mesh = mesh
        if mesh is not None:
            if mesh.process_count > 1:
                raise NotImplementedError("ProjectionTrainer(mesh=...) takes a one-process mesh")
            device = mesh.slot_devices[mesh.local_slots[0]]
        self.device = resolve_device(device)
        self._infer_cfg = model_cfg  # forward-only paths keep the fused kernels
        self.model_cfg = _training_cfg(model_cfg)
        if not self.cfg.freeze_clip:
            self.model_cfg = dataclasses.replace(self.model_cfg, remat=True)
        gen = _generator(seed)
        heads = init_projection_params(gen, ProjectionConfig(model_cfg.embed_dim, self.cfg.proj_dim))
        if self.cfg.num_classes > 0:
            dim = self.cfg.proj_dim or model_cfg.embed_dim
            heads["classifier"] = {
                "kernel": torch.randn((dim, self.cfg.num_classes), generator=gen) * 0.02,
                "bias": torch.zeros((self.cfg.num_classes,), dtype=torch.float32),
            }
        self.params = _to_device({"clip": clip_params, "heads": heads}, self.device)
        self.optimizer = AdamW(self.cfg.lr, weight_decay=self.cfg.weight_decay)
        if self.cfg.grad_accumulation_steps > 1:
            self.optimizer = MultiSteps(self.optimizer, self.cfg.grad_accumulation_steps)
        self.opt_state = self.optimizer.init(self._trainable())

    def _trainable(self) -> dict[str, torch.Tensor]:
        if self.cfg.freeze_clip:
            return flat_leaves({"heads": self.params["heads"]})
        return flat_leaves(self.params)

    def _towers(self, encode, x: torch.Tensor, cfg, dtype) -> torch.Tensor:
        """``encode(params, cfg, x, dtype=)`` on the trainer's device, or
        over the mesh's slots (rows split evenly, features back on the
        trainer's device in slot order)."""
        clip = self.params["clip"]
        if self.mesh is None:
            return encode(clip, cfg, x.to(self.device), dtype=dtype)
        slots = self.mesh.leaders("data" if "data" in self.mesh.axis_names else self.mesh.axis_names)
        if x.shape[0] % len(slots):
            raise ValueError(f"{x.shape[0]} rows do not split over {len(slots)} slots")
        b = x.shape[0] // len(slots)
        outs = []
        for i, s in enumerate(slots):
            dev = self.mesh.slot_devices[s]
            p = clip if dev == self.device else map_with_paths(clip, lambda _, t: t.to(dev))
            outs.append(encode(p, cfg, x[i * b:(i + 1) * b].to(dev), dtype=dtype).to(self.device))
        return torch.cat(outs)

    def _loss(self, batch):
        cfg = self.cfg
        dtype = _compute_dtype(cfg.compute_dtype)
        # frozen towers (stop_gradient) run without grad
        with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.freeze_clip):
            x = _pixels(batch["images"], "cpu" if self.mesh is not None else self.device)
            img = self._towers(encode_image, x, self.model_cfg, dtype)
            tokens = torch.as_tensor(batch["tokens"])
            txt = self._towers(encode_text, tokens, self.model_cfg, dtype)
        heads = self.params["heads"]
        img_p, txt_p = project_features(heads, _unit(img), _unit(txt))
        loss = hard_negative_infonce(img_p, txt_p, heads["logit_scale"])
        metrics = {"contrastive_loss": loss}
        if cfg.num_classes > 0 and "labels" in batch:
            labels = torch.as_tensor(batch["labels"], device=self.device).long()
            cls = softmax_cross_entropy(linear(img_p, heads["classifier"]), labels).mean()
            metrics["classification_loss"] = cls
            loss = loss + cfg.classification_weight * cls
        metrics["total_loss"] = loss
        return loss, metrics

    def gradients(self, batch) -> tuple[dict, dict[str, torch.Tensor]]:
        """(metrics, the gradient of every trainable leaf) of one batch."""
        return _gradients(lambda: self._loss(batch), self._trainable())

    def train_step(self, batch) -> dict:
        metrics, grads = self.gradients(batch)
        self.optimizer.apply(self._trainable(), grads, self.opt_state)
        return _metrics_out(metrics)

    @torch.inference_mode()
    def encode_projected(self, staged_images=None, tokens=None):
        """Projected, normalised features (numpy) for retrieval validation /
        the chunked embedding-export deployment path
        (`training_CLIP_multimodal.py:787-886`)."""
        dtype = _compute_dtype(self.cfg.compute_dtype)
        img = txt = None
        if staged_images is not None:
            x = _pixels(staged_images, "cpu" if self.mesh is not None else self.device)
            img = _unit(self._towers(encode_image, x, self._infer_cfg, dtype))
        if tokens is not None:
            txt = _unit(self._towers(encode_text, torch.as_tensor(tokens), self._infer_cfg, dtype))
        img_p, txt_p = project_features(self.params["heads"], img, txt)
        return tuple(None if v is None else v.cpu().numpy() for v in (img_p, txt_p))


# -- progressive trainer (T2) ----------------------------------------------


@dataclass
class ProgressiveTrainConfig:
    num_classes: int = 3
    lr: float = 1e-4
    weight_decay: float = 0.01
    label_smoothing: float = 0.1
    entropy_weight: float = 0.01
    manual_l2: float = 1e-5
    alpha: float = 0.7
    beta: float = 0.15
    gamma: float = 0.15
    temp: float = 0.07
    warmup_fraction: float = 0.1  # OneCycle warmup 10%
    steps_per_phase: int = 100
    compute_dtype: str = "float32"


def _phase_label(path: tuple, n_visual: int, n_text: int, phase: int) -> str:
    """Trainability label for one tensor under the given phase."""
    if path[0] == "heads":
        return "head"
    # path like ('clip','visual','blocks','10',...)
    if phase == 1:
        return "frozen"
    if phase == 2:
        if path[1] == "visual" and path[2:3] == ("blocks",) and int(path[3]) >= n_visual - 3:
            return "late"
        if path[1] == "text" and path[2:3] == ("blocks",) and int(path[3]) >= n_text - 3:
            return "late"
        if path[1] == "visual" and path[2] in ("ln_post", "proj"):
            return "late"
        if path[1] == "text" and path[2] in ("ln_final", "text_projection"):
            return "late"
        return "frozen"
    # phase 3: discriminative LRs — early blocks lr/10, late lr/3, rest lr
    if path[1] in ("visual", "text") and path[2:3] == ("blocks",):
        n = n_visual if path[1] == "visual" else n_text
        return "late" if int(path[3]) >= n - 3 else "early"
    return "mid"


class ProgressiveTrainer:
    """3-phase fusion-head fine-tune with per-phase optimizers. ``seed``
    (or a ``torch.Generator``) draws the fusion heads' init on the CPU;
    ``device``: None means the card, "cpu" on request."""

    PHASE_LR_SCALE = {"head": 1.0, "late": 1 / 3, "mid": 1.0, "early": 1 / 10}

    def __init__(
        self,
        model_cfg: CLIPConfig,
        clip_params,
        cfg: ProgressiveTrainConfig | None = None,
        seed: torch.Generator | int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = _training_cfg(model_cfg)
        self.cfg = cfg or ProgressiveTrainConfig()
        self.fusion_cfg = FusionConfig(model_cfg.embed_dim, num_classes=self.cfg.num_classes)
        heads = init_fusion_params(_generator(seed), self.fusion_cfg)
        self.params = _to_device({"clip": clip_params, "heads": heads}, self.device)
        self.phase = 0
        self.history: list[dict] = []
        self._enter_phase(1)

    # -- phase machinery --------------------------------------------------
    def labels_for_phase(self, phase: int):
        nv = len(self.params["clip"]["visual"]["blocks"])
        nt = len(self.params["clip"]["text"]["blocks"])
        return map_with_paths(self.params, lambda path, _leaf: _phase_label(path, nv, nt, phase))

    def _enter_phase(self, phase: int):
        if phase <= self.phase:
            raise ValueError(
                f"cross-phase resume refused: already in phase {self.phase}"
            )  # train_CLIP_v3.py:517-529 semantics
        self.phase = phase
        cfg = self.cfg
        warm = max(1, int(cfg.steps_per_phase * cfg.warmup_fraction))
        decay = max(warm + 1, cfg.steps_per_phase)
        transforms = {
            label: AdamW(warmup_cosine_decay(cfg.lr * s, warm, decay), weight_decay=cfg.weight_decay)
            for label, s in self.PHASE_LR_SCALE.items()
        }
        self.optimizer = PhaseOptimizer(flat_leaves(self.labels_for_phase(phase)), transforms)
        self.opt_state = self.optimizer.init(self.params)

    def next_phase(self):
        self._enter_phase(self.phase + 1)

    def _loss(self, batch, generator):
        cfg, params = self.cfg, self.params
        dtype = _compute_dtype(cfg.compute_dtype)
        x = _pixels(batch["images"], self.device)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        img = encode_image(params["clip"], self.model_cfg, x, dtype=dtype)
        txt = encode_text(params["clip"], self.model_cfg, tokens, dtype=dtype)
        outputs = fusion_forward(
            params["heads"], self.fusion_cfg, _unit(img), _unit(txt),
            deterministic=False, generator=generator,
        )
        return multimodal_loss(
            outputs,
            torch.as_tensor(batch["labels"], device=self.device).long(),
            alpha=cfg.alpha,
            beta=cfg.beta,
            gamma=cfg.gamma,
            temp=cfg.temp,
            label_smoothing=cfg.label_smoothing,
            entropy_weight=cfg.entropy_weight,
            weight_decay=cfg.manual_l2,
            trainable_params=params["heads"],
        )

    def gradients(self, batch, generator=None) -> tuple[dict, dict[str, torch.Tensor]]:
        """(metrics, the gradient of every leaf, frozen ones included) of one
        batch; the dropout mask from ``generator`` (default: seeded with
        the step's index, ``len(history)``)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(len(self.history))
        return _gradients(lambda: self._loss(batch, generator), flat_leaves(self.params))

    def train_step(self, batch, generator=None) -> dict:
        """batch: {'images': uint8 [B,S,S,3], 'tokens': int [B,77],
        'labels': int [B]}."""
        metrics, grads = self.gradients(batch, generator)
        self.optimizer.apply(self.params, grads, self.opt_state)
        out = _metrics_out(metrics) | {"phase": self.phase}
        self.history.append(out)
        return out


# -- CatLIP classification pretraining (arXiv 2404.15653) -------------------

_EN_STOPWORDS = frozenset(
    "a an the of in on at to for with and or is are was were be been being "
    "this that these those it its as by from his her their there here has "
    "have had not no so up down out over under".split()
)


def build_concept_vocab(
    captions, size: int = 1000, min_count: int = 2
) -> dict[str, int]:
    """Caption corpus → concept vocabulary for CatLIP-style pretraining.

    CatLIP (arXiv 2404.15653 §3.1) extracts noun synsets via POS tagging +
    WordNet; this zero-dependency equivalent uses frequency-filtered
    lowercase unigrams minus stopwords — the same supervision shape
    (presence of a concept word in the caption = positive label), buildable
    offline from any caption JSON.
    """
    import collections
    import re

    counts: collections.Counter = collections.Counter()
    for cap in captions:
        for w in re.findall(r"[a-z]+", str(cap).lower()):
            if len(w) >= 2 and w not in _EN_STOPWORDS:
                counts[w] += 1
    keep = [w for w, c in counts.most_common() if c >= min_count][:size]
    return {w: i for i, w in enumerate(sorted(keep))}


def concept_targets(captions, vocab: dict[str, int]) -> np.ndarray:
    """Multi-hot [N, len(vocab)] float32 targets (word present → 1)."""
    import re

    out = np.zeros((len(captions), len(vocab)), np.float32)
    for i, cap in enumerate(captions):
        for w in re.findall(r"[a-z]+", str(cap).lower()):
            j = vocab.get(w)
            if j is not None:
                out[i, j] = 1.0
    return out


@dataclass
class CatLIPTrainConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    compute_dtype: str = "bfloat16"


class CatLIPTrainer:
    """CatLIP-style pretraining: image tower + multi-label BCE over caption
    concepts — no text tower in the step (the paper's source of its 2.7×
    pretraining speedup; arXiv 2404.15653). The trained vision tower then
    seeds the ordinary contrastive fine-tune (``Trainer``) — ``clip_params``
    returns the full CLIP tree with the updated vision tower in place.
    ``seed`` draws the head's init on the CPU; ``device``: None means the
    card, "cpu" on request.
    """

    def __init__(
        self,
        model_cfg: CLIPConfig,
        clip_params,
        vocab: dict[str, int],
        cfg: CatLIPTrainConfig | None = None,
        seed: torch.Generator | int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = _training_cfg(model_cfg)
        self.cfg = cfg or CatLIPTrainConfig()
        self.vocab = vocab
        head = {
            "kernel": torch.randn((model_cfg.embed_dim, len(vocab)), generator=_generator(seed)) * 0.02,
            "bias": torch.zeros((len(vocab),), dtype=torch.float32),
        }
        # fresh copies: the step updates in place, the caller's tree stays
        self.params = _to_device({"clip": clip_params, "head": head}, self.device)
        self.optimizer = AdamW(self.cfg.lr, weight_decay=self.cfg.weight_decay)
        self.opt_state = self.optimizer.init(self._trainable())

    def _trainable(self) -> dict[str, torch.Tensor]:
        # vision tower + head train; the text tower is untouched (not even
        # run) — that is the whole point of the method
        return flat_leaves({"clip": {"visual": self.params["clip"]["visual"]}, "head": self.params["head"]})

    def _loss(self, batch):
        x = _pixels(batch["images"], self.device)
        img = encode_image(self.params["clip"], self.model_cfg, x,
                           dtype=_compute_dtype(self.cfg.compute_dtype))
        head = self.params["head"]
        logits = (img @ head["kernel"] + head["bias"]).float()
        targets = torch.as_tensor(batch["targets"], device=self.device).float()
        # optax.sigmoid_binary_cross_entropy
        loss = (-targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)).mean()
        return loss, {"bce_loss": loss}

    def gradients(self, batch) -> tuple[dict, dict[str, torch.Tensor]]:
        """(metrics, the gradient of every trainable leaf) of one batch."""
        return _gradients(lambda: self._loss(batch), self._trainable())

    def train_step(self, batch) -> dict:
        """batch: {'images': uint8 [B,S,S,3], 'targets': float32 [B,C]}."""
        metrics, grads = self.gradients(batch)
        self.optimizer.apply(self._trainable(), grads, self.opt_state)
        return _metrics_out(metrics)

    def clip_params(self):
        """Full CLIP tree with the CatLIP-pretrained vision tower — drop-in
        init for the contrastive ``Trainer``."""
        return self.params["clip"]
