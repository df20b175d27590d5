"""Parameter partitioning: freeze prefixes and optimizer groups.

A copy of ``evr_tpu/training/partition.py`` (pure Python; the port imports
nothing of the JAX package): the same paths, labels and torch tensor order,
over the port's params (nested dicts and lists of tensors).

Parity targets in the reference trainer (`Backend/clip_finetune_correct.py`):

- freeze the first N parameter *tensors* of the visual tower and of the text
  transformer, in torch ``Module.parameters()`` iteration order (`:118-142`);
- four optimizer groups with distinct learning rates (`:384-423`):
  visual ×1, text ×0.5, classifier ×5, everything else ×1.

The torch iteration order is reproduced explicitly below so that
``freeze_layers=8`` freezes exactly the same logical tensors as the
reference: for the visual tower, direct parameters first
(class_embedding, positional_embedding, proj), then submodules in
registration order (conv1, ln_pre, resblocks...); for the text tower only
``transformer.parameters()`` — per-block (attn.in_proj w/b, attn.out_proj
w/b, ln_1 w/b, mlp.c_fc w/b, mlp.c_proj w/b, ln_2 w/b).
"""

from __future__ import annotations

from typing import Any

from evr_tpu_torch.utils.tree import Path, iter_paths, map_with_paths

_BLOCK_ORDER = (
    ("attn", "qkv", "kernel"),
    ("attn", "qkv", "bias"),
    ("attn", "out", "kernel"),
    ("attn", "out", "bias"),
    ("ln_1", "scale"),
    ("ln_1", "bias"),
    ("mlp", "fc", "kernel"),
    ("mlp", "fc", "bias"),
    ("mlp", "proj", "kernel"),
    ("mlp", "proj", "bias"),
    ("ln_2", "scale"),
    ("ln_2", "bias"),
)


def _visual_tensor_order(n_blocks: int) -> list[Path]:
    order: list[Path] = [
        ("visual", "class_embedding"),
        ("visual", "pos_embedding"),
        ("visual", "proj"),
        ("visual", "patch_embed", "kernel"),
        ("visual", "ln_pre", "scale"),
        ("visual", "ln_pre", "bias"),
    ]
    for i in range(n_blocks):
        order += [("visual", "blocks", str(i)) + p for p in _BLOCK_ORDER]
    order += [("visual", "ln_post", "scale"), ("visual", "ln_post", "bias")]
    return order


def _text_tensor_order(n_blocks: int) -> list[Path]:
    order: list[Path] = []
    for i in range(n_blocks):
        order += [("text", "blocks", str(i)) + p for p in _BLOCK_ORDER]
    return order


def freeze_paths(clip_params: dict, freeze_layers: int) -> set[Path]:
    """Paths of the tensors frozen by ``freeze_layers`` (reference semantics:
    the first N tensors of each tower, counted per tower)."""
    if freeze_layers <= 0:
        return set()
    nv = len(clip_params["visual"]["blocks"])
    nt = len(clip_params["text"]["blocks"])
    frozen = set(_visual_tensor_order(nv)[:freeze_layers])
    frozen |= set(_text_tensor_order(nt)[:freeze_layers])
    return frozen


def param_group_labels(params: dict, freeze_layers: int = 0) -> Any:
    """Label tree (the params' structure, a label per leaf) for the
    optimizer groups of ``training.finetune.make_optimizer``.

    ``params`` is the full trainable tree ``{"clip": ..., "classifier": ...}``.
    Labels: 'frozen' | 'visual' | 'text' | 'classifier' | 'other'
    (reference group split at `clip_finetune_correct.py:391-401`:
    'visual' in name → visual; 'transformer' in name → text — which in the
    torch model matches only text resblocks; classifier → classifier;
    else → other, incl. logit_scale, token_embedding, projections).

    LoRA mode (a ``"lora"`` subtree present — `training.lora`): the entire
    base CLIP tree is frozen except the scalar calibration leaves
    (logit_scale / SigLIP logit_bias); adapters take their tower's LR group
    so the text ×0.5 scale still applies. Frozen leaves keep no moments.
    """
    frozen = {("clip",) + p for p in freeze_paths(params.get("clip", {}), freeze_layers)}
    lora_mode = "lora" in params

    def label(path: Path, _leaf):
        if path[0] == "lora":
            return "visual" if path[1] == "visual" else "text"
        if lora_mode and path[0] == "clip":
            return "other" if path[1] in ("logit_scale", "logit_bias") else "frozen"
        if path in frozen:
            return "frozen"
        if path[0] == "classifier":
            return "classifier"
        if path[0] == "clip" and len(path) > 1:
            if path[1] == "visual":
                return "visual"
            if path[1] == "text" and len(path) > 2 and path[2] == "blocks":
                return "text"
        return "other"

    return map_with_paths(params, label)


def count_labels(labels: Any) -> dict[str, int]:
    counts: dict[str, int] = {}
    for _, leaf in iter_paths(labels):
        counts[leaf] = counts.get(leaf, 0) + 1
    return counts
