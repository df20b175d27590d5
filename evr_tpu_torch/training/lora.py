"""LoRA parameter-efficient fine-tuning (arXiv 2106.09685) on one device.

Counterpart of ``evr_tpu/training/lora.py``. The adapters are a small tree
mirroring the towers' block structure: each adapted linear holds
``{"a": [d_in, r], "b": [r, d_out]}`` with ``a`` ~ N(0, 1/r) and ``b`` = 0,
so the adapted model equals the base model exactly at step 0.

``merge_lora`` computes ``W' = W + (alpha / r) · a @ b`` for every adapted
kernel. The train step merges inside its forward and differentiates through
the merge: the towers run on ordinary dense weights (every block route, the
fused kernels K1/K2 and their backward K5 included, applies unchanged) and
autograd carries the dense kernel's gradient onto the factors
(``dA = dW · bᵀ``, ``dB = aᵀ · dW``). Serving needs no adapter support:
merge once and every surface reads an ordinary CLIP tree.

The base stays frozen in the optimizer (``partition.param_group_labels``
labels it "frozen" when a ``"lora"`` subtree is present); ``logit_scale``
(and SigLIP's ``logit_bias``) stay trainable.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .partition import iter_paths

Params = dict[str, Any]

# Block linears that receive adapters, as paths inside one residual block.
DEFAULT_TARGETS: tuple[str, ...] = ("attn.qkv", "attn.out", "mlp.fc", "mlp.proj")


def _target_path(target: str) -> tuple[str, ...]:
    return tuple(target.split("."))


def _block_linear(block: Params, target: str) -> Params:
    node: Any = block
    for k in _target_path(target):
        node = node[k]
    return node


def init_lora(
    generator: torch.Generator | int,
    clip_params: Params,
    rank: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    towers: Sequence[str] = ("visual", "text"),
) -> Params:
    """Zero-effect adapters for every targeted linear in every block, as
    float32 CPU tensors: ``a`` drawn from ``generator`` (or a seed) in the
    order tower, block, target; ``b`` zeros. Returns ``{"visual": {"blocks":
    [...]}, "text": {"blocks": [...]}}`` with one ``{"a", "b"}`` dict per
    (block, target)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))
    lora: Params = {}
    for tower in towers:
        tower_blocks = []
        for block in clip_params[tower]["blocks"]:
            entry: Params = {}
            for target in targets:
                d_in, d_out = _block_linear(block, target)["kernel"].shape
                node = entry
                path = _target_path(target)
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = {
                    "a": torch.randn((d_in, rank), generator=generator, dtype=torch.float32) * (rank ** -0.5),
                    "b": torch.zeros((rank, d_out), dtype=torch.float32),
                }
            tower_blocks.append(entry)
        lora[tower] = {"blocks": tower_blocks}
    return lora


def merge_lora(clip_params: Params, lora: Params, alpha: float = 16.0) -> Params:
    """Fold adapters into dense kernels: ``W + (alpha / r) · a @ b``.

    A function of both trees (differentiable in either), returning a full
    CLIP tree that shares every un-adapted leaf with the input."""

    def merge_block(block: Params, adapters: Params) -> Params:
        out = dict(block)
        for key, sub in adapters.items():
            if isinstance(sub, dict) and "a" in sub and "b" in sub:
                a, b = sub["a"], sub["b"]
                scale = alpha / a.shape[1]
                lin = dict(out[key])
                lin["kernel"] = lin["kernel"] + scale * (a @ b)
                out[key] = lin
            else:
                out[key] = merge_block(block[key], sub)
        return out

    merged = dict(clip_params)
    for tower, tower_lora in lora.items():
        t = dict(merged[tower])
        t["blocks"] = [merge_block(block, adapters) for block, adapters in zip(t["blocks"], tower_lora["blocks"])]
        merged[tower] = t
    return merged


def lora_param_fraction(clip_params: Params, lora: Params) -> float:
    """Trainable-adapter parameter count as a fraction of the base model."""
    def count(tree) -> int:
        return sum(leaf.numel() if isinstance(leaf, torch.Tensor) else int(np.size(leaf))
                   for _, leaf in iter_paths(tree))

    return count(lora) / count(clip_params)
