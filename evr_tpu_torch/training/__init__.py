"""Contrastive fine-tuning of the CLIP towers (single device; the trainer
variants and levers wait for ROADMAP item A14, distributed training for
A15)."""

from .data import CaptionDataset, prefetch_batches
from .finetune import (
    GroupedAdamW,
    TrainConfig,
    Trainer,
    TrainState,
    check_supported,
    make_grad_fn,
    make_optimizer,
    make_train_step,
)
from .losses import combined_clip_loss, softmax_cross_entropy
from .partition import count_labels, freeze_paths, param_group_labels

__all__ = [
    "CaptionDataset",
    "GroupedAdamW",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "check_supported",
    "combined_clip_loss",
    "count_labels",
    "freeze_paths",
    "make_grad_fn",
    "make_optimizer",
    "make_train_step",
    "param_group_labels",
    "prefetch_batches",
    "softmax_cross_entropy",
]
