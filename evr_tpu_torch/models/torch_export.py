"""Checkpoint interop, outbound: the port's param trees → torch state dicts.

Counterpart of ``evr_tpu/models/torch_export.py`` and the inverse of
``torch_import``: writes the OpenAI pip-``clip`` layout (fused
``attn.in_proj_*``, ``visual.proj`` as ``x @ proj``) in the reference
trainer's checkpoint dict (``{epoch, model_state_dict, metrics}`` with
``clip_model.``/``classifier.`` prefixes), so a model fine-tuned here loads in
the reference serving stack unchanged and round-trips through
``torch_import`` exactly. Leaves may be numpy arrays or tensors on any
device.
"""

from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_to_openai(prefix: str, bp: dict, out: dict) -> None:
    out[f"{prefix}.attn.in_proj_weight"] = _np(bp["attn"]["qkv"]["kernel"]).T
    out[f"{prefix}.attn.in_proj_bias"] = _np(bp["attn"]["qkv"]["bias"])
    out[f"{prefix}.attn.out_proj.weight"] = _np(bp["attn"]["out"]["kernel"]).T
    out[f"{prefix}.attn.out_proj.bias"] = _np(bp["attn"]["out"]["bias"])
    out[f"{prefix}.ln_1.weight"] = _np(bp["ln_1"]["scale"])
    out[f"{prefix}.ln_1.bias"] = _np(bp["ln_1"]["bias"])
    out[f"{prefix}.mlp.c_fc.weight"] = _np(bp["mlp"]["fc"]["kernel"]).T
    out[f"{prefix}.mlp.c_fc.bias"] = _np(bp["mlp"]["fc"]["bias"])
    out[f"{prefix}.mlp.c_proj.weight"] = _np(bp["mlp"]["proj"]["kernel"]).T
    out[f"{prefix}.mlp.c_proj.bias"] = _np(bp["mlp"]["proj"]["bias"])
    out[f"{prefix}.ln_2.weight"] = _np(bp["ln_2"]["scale"])
    out[f"{prefix}.ln_2.bias"] = _np(bp["ln_2"]["bias"])


def to_openai_state_dict(params: dict) -> dict[str, np.ndarray]:
    """CLIP params → the OpenAI pip-clip state dict (numpy values)."""
    v, t = params["visual"], params["text"]
    out: dict[str, np.ndarray] = {
        "visual.conv1.weight": _np(v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "visual.class_embedding": _np(v["class_embedding"]),
        "visual.positional_embedding": _np(v["pos_embedding"]),
        "visual.ln_pre.weight": _np(v["ln_pre"]["scale"]),
        "visual.ln_pre.bias": _np(v["ln_pre"]["bias"]),
        "visual.ln_post.weight": _np(v["ln_post"]["scale"]),
        "visual.ln_post.bias": _np(v["ln_post"]["bias"]),
        "visual.proj": _np(v["proj"]),
        "token_embedding.weight": _np(t["token_embedding"]),
        "positional_embedding": _np(t["pos_embedding"]),
        "ln_final.weight": _np(t["ln_final"]["scale"]),
        "ln_final.bias": _np(t["ln_final"]["bias"]),
        "text_projection": _np(t["text_projection"]),
        "logit_scale": _np(params["logit_scale"]),
    }
    for i, bp in enumerate(v["blocks"]):
        _block_to_openai(f"visual.transformer.resblocks.{i}", bp, out)
    for i, bp in enumerate(t["blocks"]):
        _block_to_openai(f"transformer.resblocks.{i}", bp, out)
    return out


def save_reference_checkpoint(
    path,
    clip_params: dict,
    classifier_params: dict | None = None,
    epoch: int = 0,
    metrics: dict | None = None,
) -> None:
    """Write a reference-format .pt checkpoint that the reference stack and
    both packages' ``torch_import.load_checkpoint`` read."""
    import torch

    sd = {f"clip_model.{k}": torch.from_numpy(np.array(v))
          for k, v in to_openai_state_dict(clip_params).items()}
    if classifier_params is not None:
        for i, fc in ((0, "fc1"), (3, "fc2")):
            sd[f"classifier.{i}.weight"] = torch.from_numpy(np.array(_np(classifier_params[fc]["kernel"]).T))
            sd[f"classifier.{i}.bias"] = torch.from_numpy(np.array(_np(classifier_params[fc]["bias"])))
    torch.save({"epoch": epoch, "model_state_dict": sd, "metrics": metrics or {}}, path)
