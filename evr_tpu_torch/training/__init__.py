"""Contrastive fine-tuning of the CLIP towers: the trainer and its levers
(gradient accumulation, Muon, LoRA, remat, GradCache, FLIP patch drop,
Mixture-of-Experts), on one device or over a mesh (data parallelism, FSDP,
tensor and expert parallelism, several processes), the sharded
checkpoints, the trainer variants, distillation, and SCST of the prefix
captioner (``scst``)."""

from .data import CaptionDataset, prefetch_batches
from .distill import DistillationTrainer, DistillConfig, embed_align_loss, similarity_kd_loss
from .finetune import (
    GroupedAdamW,
    MultiSteps,
    TrainConfig,
    Trainer,
    TrainState,
    check_supported,
    make_grad_fn,
    make_optimizer,
    make_train_step,
)
from .gradcache import chunk_batch, gradcache_value_and_grad
from .lora import init_lora, lora_param_fraction, merge_lora
from .losses import combined_clip_loss, softmax_cross_entropy
from .muon import muon_param_labels, newton_schulz_orthogonalize
from .partition import count_labels, freeze_paths, param_group_labels

__all__ = [
    "CaptionDataset",
    "DistillConfig",
    "DistillationTrainer",
    "GroupedAdamW",
    "MultiSteps",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "check_supported",
    "chunk_batch",
    "combined_clip_loss",
    "count_labels",
    "embed_align_loss",
    "freeze_paths",
    "gradcache_value_and_grad",
    "init_lora",
    "lora_param_fraction",
    "make_grad_fn",
    "make_optimizer",
    "make_train_step",
    "merge_lora",
    "muon_param_labels",
    "newton_schulz_orthogonalize",
    "param_group_labels",
    "prefetch_batches",
    "similarity_kd_loss",
    "softmax_cross_entropy",
]
