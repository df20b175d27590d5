"""Checkpoint interop: torch CLIP state dicts → the port's param trees.

Counterpart of ``evr_tpu/models/torch_import.py``. Two source layouts:

1. **OpenAI pip-``clip`` layout**, used by ``clip.load('ViT-B/32')`` and by
   every reference fine-tune checkpoint (keys prefixed ``clip_model.``):
   fused ``attn.in_proj_weight``, ``visual.proj`` applied as ``x @ proj``.
2. **HuggingFace ``CLIPModel`` layout**: split q/k/v projections,
   ``visual_projection.weight`` applied as ``x @ W.T``.

Conversion is numpy only and returns the JAX package's params layout as
numpy arrays (``params_from_numpy`` moves them to a device). Fine-tune
checkpoints may carry a classifier head (``classifier.0/3.weight``), which
converts into the ``models.classifier`` tree.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Any, Mapping

import numpy as np

from .clip import CLIPConfig, TextConfig, VisionConfig

Array = np.ndarray


def _np(t) -> Array:
    if isinstance(t, np.ndarray):
        return t
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _ln(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _linear_t(sd: Mapping[str, Any], prefix: str) -> dict:
    """torch Linear (y = x Wᵀ + b) → the port's (y = x K + b): K = Wᵀ."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


# -- OpenAI pip-clip layout ----------------------------------------------


def _openai_block(sd, prefix: str) -> dict:
    return {
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "attn": {
            "qkv": {
                "kernel": _np(sd[f"{prefix}.attn.in_proj_weight"]).T,
                "bias": _np(sd[f"{prefix}.attn.in_proj_bias"]),
            },
            "out": _linear_t(sd, f"{prefix}.attn.out_proj"),
        },
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {
            "fc": _linear_t(sd, f"{prefix}.mlp.c_fc"),
            "proj": _linear_t(sd, f"{prefix}.mlp.c_proj"),
        },
    }


def config_from_openai_state_dict(sd: Mapping[str, Any]) -> CLIPConfig:
    """The CLIPConfig an OpenAI-layout state dict's shapes imply. Heads are
    taken as width // 64, as the JAX package takes them (right for every
    OpenAI tower; a checkpoint of narrower heads needs its config given)."""
    v_width = _np(sd["visual.conv1.weight"]).shape[0]
    patch = _np(sd["visual.conv1.weight"]).shape[-1]
    v_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
    grid = int(round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5))
    embed_dim = _np(sd["text_projection"]).shape[1]
    t_width = _np(sd["ln_final.weight"]).shape[0]
    t_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    vocab = _np(sd["token_embedding.weight"]).shape[0]
    ctx = _np(sd["positional_embedding"]).shape[0]
    return CLIPConfig(
        embed_dim=embed_dim,
        vision=VisionConfig(image_size=grid * patch, patch_size=patch, width=v_width,
                            layers=v_layers, heads=v_width // 64),
        text=TextConfig(context_length=ctx, vocab_size=vocab, width=t_width, layers=t_layers,
                        heads=t_width // 64),
    )


def from_openai_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig | None = None) -> dict:
    cfg = cfg or config_from_openai_state_dict(sd)
    visual = {
        # OIHW conv weight → HWIO
        "patch_embed": {"kernel": _np(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _np(sd["visual.class_embedding"]),
        "pos_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [_openai_block(sd, f"visual.transformer.resblocks.{i}")
                   for i in range(cfg.vision.layers)],
        "ln_post": _ln(sd, "visual.ln_post"),
        # applied as x @ proj in the source model: no transpose
        "proj": _np(sd["visual.proj"]),
    }
    text = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "pos_embedding": _np(sd["positional_embedding"]),
        "blocks": [_openai_block(sd, f"transformer.resblocks.{i}") for i in range(cfg.text.layers)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
    }
    return {"visual": visual, "text": text, "logit_scale": _np(sd["logit_scale"]).reshape(())}


# -- HuggingFace CLIPModel layout ----------------------------------------


def _hf_block(sd, prefix: str) -> dict:
    q, k, v = (_np(sd[f"{prefix}.self_attn.{n}_proj.weight"]) for n in "qkv")
    qb, kb, vb = (_np(sd[f"{prefix}.self_attn.{n}_proj.bias"]) for n in "qkv")
    return {
        "ln_1": _ln(sd, f"{prefix}.layer_norm1"),
        "attn": {
            "qkv": {"kernel": np.concatenate([q.T, k.T, v.T], axis=1),
                    "bias": np.concatenate([qb, kb, vb])},
            "out": _linear_t(sd, f"{prefix}.self_attn.out_proj"),
        },
        "ln_2": _ln(sd, f"{prefix}.layer_norm2"),
        "mlp": {"fc": _linear_t(sd, f"{prefix}.mlp.fc1"), "proj": _linear_t(sd, f"{prefix}.mlp.fc2")},
    }


def from_hf_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    # HF's vision pre-LN key is historically spelled "pre_layrnorm"
    pre_ln_key = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
                  else "vision_model.pre_layernorm")
    visual = {
        "patch_embed": {"kernel": _np(sd["vision_model.embeddings.patch_embedding.weight"])
                        .transpose(2, 3, 1, 0)},
        "class_embedding": _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "pos_embedding": _np(sd["vision_model.embeddings.position_embedding.weight"]),
        "ln_pre": _ln(sd, pre_ln_key),
        "blocks": [_hf_block(sd, f"vision_model.encoder.layers.{i}") for i in range(cfg.vision.layers)],
        "ln_post": _ln(sd, "vision_model.post_layernorm"),
        "proj": _np(sd["visual_projection.weight"]).T,
    }
    text = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "pos_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "blocks": [_hf_block(sd, f"text_model.encoder.layers.{i}") for i in range(cfg.text.layers)],
        "ln_final": _ln(sd, "text_model.final_layer_norm"),
        "text_projection": _np(sd["text_projection.weight"]).T,
    }
    return {"visual": visual, "text": text, "logit_scale": _np(sd["logit_scale"]).reshape(())}


# -- checkpoint files ----------------------------------------------------


def read_torch_file(path) -> Any:
    """The object a ``.pt`` file holds, on the CPU. Tensors only (a Trainer
    file, most reference files) load with ``weights_only=True``, memory-mapped
    where the file is a zip archive, so a leaf is read only when used. A
    reference file that also pickles other objects (numpy scalars in its
    ``metrics``) is refused by that loader and is read as the JAX package
    reads it, with ``weights_only=False``: only open files you trust."""
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def checkpoint_from_blob(blob) -> dict:
    """A reference checkpoint's contents (the ``{'model_state_dict': ...,
    'epoch': ...}`` dict the reference trainer writes, or a bare state dict)
    → ``{"clip", "classifier", "meta"}``, the ``classifier.*`` keys split off
    into a classifier tree (None without them)."""
    sd = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    sd = {k: v for k, v in sd.items() if hasattr(v, "shape") or isinstance(v, np.ndarray)}
    clip_sd = {k.removeprefix("clip_model."): v for k, v in sd.items()
               if not k.startswith("classifier.")}
    classifier = None
    if any(k.startswith("classifier.") for k in sd):
        classifier = {
            "fc1": {"kernel": _np(sd["classifier.0.weight"]).T, "bias": _np(sd["classifier.0.bias"])},
            "fc2": {"kernel": _np(sd["classifier.3.weight"]).T, "bias": _np(sd["classifier.3.bias"])},
        }
    meta = {k: v for k, v in (blob.items() if isinstance(blob, dict) else [])
            if k in ("epoch", "loss", "metrics")}
    return {"clip": from_openai_state_dict(clip_sd), "classifier": classifier, "meta": meta}


def load_checkpoint(path) -> dict:
    """Load a reference fine-tune checkpoint (.pt) into numpy trees:
    ``{"clip", "classifier", "meta"}`` (``checkpoint_from_blob``)."""
    return checkpoint_from_blob(read_torch_file(path))
