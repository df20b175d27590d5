"""CLIP knowledge distillation: a frozen large teacher into a small student,
on one device.

Counterpart of ``evr_tpu/training/distill.py`` (MobileCLIP, arXiv
2311.17049 §3, and CLIP-KD): the student matches the teacher's softened
image↔text similarity rows over the batch (bidirectional KL, scaled by T²),
optionally plus a direct embedding-alignment term, beside its own InfoNCE.

The teacher runs under ``torch.no_grad()`` with its own ``attn_impl`` (on
the card, "auto": its blocks take the forward kernels K1/K2) and its params
never require grad; the student resolves "auto" to "auto_grad", as the JAX
step does. Teacher and student may differ in width and depth; only the
alignment term needs equal embed dims. The optimizer is optax's
``chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay=wd))``
(b1 0.9, b2 0.999, eps 1e-8, decay on every leaf, no schedule):
``variants.PhaseOptimizer`` over one label. Params are updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from evr_tpu_torch.models.clip import CLIPConfig, encode_image, encode_text
from evr_tpu_torch.utils.device import resolve_device

from .finetune import _to_device, flat_leaves
from .losses import combined_clip_loss
from .variants import AdamW, PhaseOptimizer, _gradients, _pixels

Params = dict[str, Any]


def similarity_kd_loss(s_img, s_txt, t_img, t_txt, temperature: float = 2.0) -> torch.Tensor:
    """Bidirectional KL between the teacher's and the student's batch
    similarity rows. Inputs: L2-normalised [B, D] features (the teacher's D
    may differ from the student's); the loss is scaled by T²."""
    t = torch.tensor(temperature, dtype=torch.float32, device=s_img.device)
    s_sim = (s_img @ s_txt.T).float() / t
    t_sim = (t_img @ t_txt.T).float() / t
    t_rows = torch.log_softmax(t_sim, dim=-1)
    s_rows = torch.log_softmax(s_sim, dim=-1)
    t_cols = torch.log_softmax(t_sim.T, dim=-1)
    s_cols = torch.log_softmax(s_sim.T, dim=-1)
    kl_rows = (torch.exp(t_rows) * (t_rows - s_rows)).sum(-1).mean()
    kl_cols = (torch.exp(t_cols) * (t_cols - s_cols)).sum(-1).mean()
    return 0.5 * (kl_rows + kl_cols) * t * t


def embed_align_loss(s_feat, t_feat) -> torch.Tensor:
    """1 − cosine between student and teacher embeddings (equal embed dims),
    averaged over the batch."""
    return (1.0 - (s_feat * t_feat).sum(-1)).mean()


@dataclass
class DistillConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    compute_dtype: str = "bfloat16"
    # total = contrastive_weight·InfoNCE + kd_weight·sim-KD + align_weight·(1 − cos)
    contrastive_weight: float = 1.0
    kd_weight: float = 1.0
    align_weight: float = 0.0  # needs teacher.embed_dim == student.embed_dim
    kd_temperature: float = 2.0
    grad_clip: float = 1.0


class DistillationTrainer:
    """Distill a frozen teacher CLIP into a trainable student CLIP.
    ``device``: None means the card (raises without one), "cpu" on
    request."""

    def __init__(
        self,
        student_cfg: CLIPConfig,
        student_params: Params,
        teacher_cfg: CLIPConfig,
        teacher_params: Params,
        cfg: DistillConfig | None = None,
        device=None,
    ):
        self.cfg = cfg or DistillConfig()
        if self.cfg.align_weight > 0.0 and student_cfg.embed_dim != teacher_cfg.embed_dim:
            raise ValueError(
                f"align_weight needs matching embed dims "
                f"(student {student_cfg.embed_dim} != teacher "
                f"{teacher_cfg.embed_dim}); use the similarity-KD term alone"
            )
        self.device = resolve_device(device)
        # gradient steps resolve "auto" per shape, as the JAX step does
        if student_cfg.attn_impl == "auto":
            student_cfg = dataclasses.replace(student_cfg, attn_impl="auto_grad")
        self.student_cfg = student_cfg
        self.teacher_cfg = teacher_cfg
        # fresh copies: the step updates the student in place
        self.params = _to_device(student_params, self.device)
        self.teacher_params = _to_device(teacher_params, self.device)
        leaves = flat_leaves(self.params)
        self.optimizer = PhaseOptimizer(
            {k: "student" for k in leaves},
            {"student": AdamW(self.cfg.lr, weight_decay=self.cfg.weight_decay)},
            max_norm=self.cfg.grad_clip if self.cfg.grad_clip > 0 else math.inf,  # 0: no clip
        )
        self.opt_state = self.optimizer.init(self.params)

    def _encode_pair(self, params, model_cfg, batch):
        dtype = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32
        x = _pixels(batch["images"], self.device)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        img = encode_image(params, model_cfg, x, dtype=dtype)
        txt = encode_text(params, model_cfg, tokens, dtype=dtype)
        return img / img.norm(dim=-1, keepdim=True), txt / txt.norm(dim=-1, keepdim=True)

    def teacher_features(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """The teacher's unit image and text rows of ``batch`` (no grad)."""
        with torch.no_grad():
            return self._encode_pair(self.teacher_params, self.teacher_cfg, batch)

    def _loss(self, batch, teacher):
        cfg = self.cfg
        s_img, s_txt = self._encode_pair(self.params, self.student_cfg, batch)
        t_img, t_txt = teacher
        con, metrics = combined_clip_loss(s_img, s_txt, self.params["logit_scale"])
        kd = similarity_kd_loss(s_img, s_txt, t_img, t_txt, cfg.kd_temperature)
        loss = cfg.contrastive_weight * con + cfg.kd_weight * kd
        metrics = {**metrics, "kd_loss": kd}
        if cfg.align_weight > 0.0:
            al = 0.5 * (embed_align_loss(s_img, t_img) + embed_align_loss(s_txt, t_txt))
            loss = loss + cfg.align_weight * al
            metrics["align_loss"] = al
        metrics["total_loss"] = loss
        return loss, metrics

    def gradients(self, batch) -> tuple[dict, dict[str, torch.Tensor]]:
        """(metrics, the gradient of every student leaf) of one batch."""
        teacher = self.teacher_features(batch)
        return _gradients(lambda: self._loss(batch, teacher), flat_leaves(self.params))

    def train_step(self, batch) -> dict:
        """batch: {'images': uint8 [B, S, S, 3], 'tokens': int [B, 77]}."""
        metrics, grads = self.gradients(batch)
        self.optimizer.apply(self.params, grads, self.opt_state)
        return {k: float(v) for k, v in metrics.items()}
