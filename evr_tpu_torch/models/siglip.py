"""SigLIP dual encoder in PyTorch — the second model family next to CLIP.

Counterpart of the JAX package's ``models/siglip.py``: the same
configurations, params layout (kernels ``[in, out]``, the patch conv HWIO,
packed qkv) and forward functions. The parity target of both is HuggingFace
``transformers.SiglipModel`` (Zhai et al., arXiv 2303.15343).

What differs from CLIP (``models/clip.py``):

- no class token and no pre-LN; a biased patch conv; the vision tower pools
  with a MAP head (a learned probe query cross-attends over every token,
  then LayerNorm and a residual MLP);
- a bidirectional text tower pooled at the last position (no mask), then a
  learned ``head`` linear;
- no projection: features live at tower width; logits are
  ``exp(logit_scale) · cos + logit_bias``;
- tanh-GELU and LayerNorm eps 1e-6 (CLIP: quickGELU, 1e-5).

The blocks run this module's own plain composition, never
``layers.block_apply`` or a kernel of ``ops``: the fused kernels K1/K2 carry
CLIP's eps and activations. Attention is written as the JAX package's
einsums: scores in the compute dtype divided by √d rounded to that dtype,
the softmax in fp32, a cast back, then the product with v. Block linears go
through ``layers.linear``, so int8 params (``models.quant``) take the exact
int8 product of ``ops.int8``; the MAP head and the text head stay in
floating point.

The compute dtype is an argument (bfloat16 on the card, float32 on the CPU
and for parity tests). ``init_siglip_params`` draws from a seeded
``torch.Generator`` on the target device; the JAX package's random streams
cannot be reproduced, so tests carry its params across with
``models.convert.params_from_numpy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from evr_tpu_torch.utils.device import resolve_device

from .layers import layer_norm, linear

Params = Any
LN_EPS_SIGLIP = 1e-6


@dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SiglipTextConfig:
    context_length: int = 64
    vocab_size: int = 32000
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072


@dataclass(frozen=True)
class SiglipConfig:
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    text: SiglipTextConfig = field(default_factory=SiglipTextConfig)

    @property
    def embed_dim(self) -> int:
        # no projection: features live at tower width
        return self.text.width


# -- init -------------------------------------------------------------------


def init_siglip_params(seed: int, cfg: SiglipConfig, device=None) -> Params:
    """Random SigLIP weights at the JAX package's init scales, float32
    tensors on ``device`` (None: the card), drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    v, t = cfg.vision, cfg.text

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def zeros(n):
        return torch.zeros(n, device=dev)

    def ln(w):
        return {"scale": torch.ones(w, device=dev), "bias": zeros(w)}

    def lin(d_in, d_out, std=None):
        return {"kernel": normal((d_in, d_out), d_in ** -0.5 if std is None else std), "bias": zeros(d_out)}

    def block(width, mlp_dim, n_layers):
        std = width ** -0.5
        proj_std = std * (2 * n_layers) ** -0.5
        return {
            "ln_1": ln(width),
            "attn": {"qkv": lin(width, 3 * width, std), "out": lin(width, width, proj_std)},
            "ln_2": ln(width),
            "mlp": {"fc": lin(width, mlp_dim, (2 * width) ** -0.5), "proj": lin(mlp_dim, width, proj_std)},
        }

    visual = {
        "patch_embed": {
            "kernel": normal((v.patch_size, v.patch_size, 3, v.width), v.width ** -0.5),
            "bias": zeros(v.width),
        },
        "pos_embedding": normal((v.grid * v.grid, v.width), 0.02),
        "blocks": [block(v.width, v.mlp_dim, v.layers) for _ in range(v.layers)],
        "ln_post": ln(v.width),
        "head": {
            "probe": normal((1, v.width), 0.02),
            "attn": {"qkv": lin(v.width, 3 * v.width), "out": lin(v.width, v.width)},
            "ln": ln(v.width),
            "mlp": {"fc": lin(v.width, v.mlp_dim), "proj": lin(v.mlp_dim, v.width)},
        },
    }
    text = {
        "token_embedding": normal((t.vocab_size, t.width), 0.02),
        "pos_embedding": normal((t.context_length, t.width), 0.02),
        "blocks": [block(t.width, t.mlp_dim, t.layers) for _ in range(t.layers)],
        "ln_final": ln(t.width),
        "head": lin(t.width, t.width),
    }
    return {
        "visual": visual,
        "text": text,
        # the sigmoid-loss parameterisation (paper init: scale log 10, bias -10)
        "logit_scale": torch.tensor(math.log(10.0), device=dev),
        "logit_bias": torch.tensor(-10.0, device=dev),
    }


# -- forward ----------------------------------------------------------------


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (through float32), as a Python float:
    the constant a weakly typed JAX scalar becomes. A tensor op with it
    computes in float32 and rounds once, as XLA does; no device copy."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def stage_pixels(staged_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 staged frames → SigLIP's [-1, 1] pixels, ``x · (2/255) − 1`` in
    ``dtype``. The factor is rounded to ``dtype`` before the product, as the
    JAX package's constant is (in bfloat16, 111 of the 256 pixel values
    differ from a product by the unrounded factor)."""
    return staged_u8.to(dtype) * rounded(2.0 / 255.0, dtype) - 1.0


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def attention_scores(qh: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
    """q [B, Tq, H, d] · k [B, Tk, H, d] → scores [B, H, Tq, Tk] in their
    dtype, divided by √d rounded to that dtype (bfloat16 rounds √72 to
    8.5): a division, not a product by the reciprocal."""
    scale = rounded(float(torch.sqrt(torch.tensor(float(qh.shape[-1])))), qh.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", qh, kh) / scale


def _mha(q: torch.Tensor, kv: torch.Tensor, p: Params, n_heads: int, dtype) -> torch.Tensor:
    """Multi-head attention with packed qkv params; ``q`` [B, Tq, W] may
    differ from ``kv`` [B, Tk, W] (the MAP head's probe). fp32 softmax."""
    b, tq, w = q.shape
    tk = kv.shape[1]
    d = w // n_heads
    if q is kv:  # self-attention: one packed projection
        qp, kp, vp = linear(q.to(dtype), p["qkv"]).split(w, dim=-1)
    else:  # cross-attention (the MAP probe): project each side, slice the outputs
        qp = linear(q.to(dtype), p["qkv"])[..., :w]
        kvp = linear(kv.to(dtype), p["qkv"])
        kp, vp = kvp[..., w:2 * w], kvp[..., 2 * w:]
    qh = qp.reshape(b, tq, n_heads, d)
    kh = kp.reshape(b, tk, n_heads, d)
    vh = vp.reshape(b, tk, n_heads, d)
    attn = torch.softmax(attention_scores(qh, kh).float(), dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, tq, w)
    return linear(out, p["out"])


def _block(x: torch.Tensor, p: Params, n_heads: int, dtype) -> torch.Tensor:
    h = layer_norm(x, p["ln_1"], eps=LN_EPS_SIGLIP)
    x = x + _mha(h, h, p["attn"], n_heads, dtype)
    h = layer_norm(x, p["ln_2"], eps=LN_EPS_SIGLIP)
    h = _gelu_tanh(linear(h.to(dtype), p["mlp"]["fc"]))
    return x + linear(h, p["mlp"]["proj"])


def _dense(x: torch.Tensor, p: Params, dtype) -> torch.Tensor:
    """``x @ kernel + bias`` in ``dtype``: the heads' raw products, which
    stay in floating point under int8 params."""
    return x @ p["kernel"].to(dtype) + p["bias"].to(dtype)


def encode_image(params: Params, cfg: SiglipConfig, pixels: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] preprocessed pixels → [B, width] pooled features in
    float32 (HF ``SiglipVisionModel`` with the MAP pooling head)."""
    v = cfg.vision
    p = params["visual"]
    x = pixels.to(dtype).permute(0, 3, 1, 2)
    kernel = p["patch_embed"]["kernel"].to(dtype).permute(3, 2, 0, 1)  # HWIO → OIHW
    # VALID, stride P (so400m drops 384 − 27·14 = 6 edge pixels); the bias
    # is added in the dtype after the product, as the JAX package adds it
    x = F.conv2d(x, kernel, stride=v.patch_size).permute(0, 2, 3, 1)
    x = x + p["patch_embed"]["bias"].to(dtype)
    b = x.shape[0]
    x = x.reshape(b, v.grid * v.grid, v.width) + p["pos_embedding"].to(dtype)
    for blk in p["blocks"]:
        x = _block(x, blk, v.heads, dtype)
    x = layer_norm(x, p["ln_post"], eps=LN_EPS_SIGLIP)

    h = p["head"]
    probe = h["probe"].to(dtype).expand(b, 1, v.width)
    pooled = _mha(probe, x, h["attn"], v.heads, dtype)
    res = pooled
    pooled = layer_norm(pooled, h["ln"], eps=LN_EPS_SIGLIP)
    pooled = _gelu_tanh(_dense(pooled, h["mlp"]["fc"], dtype))
    pooled = _dense(pooled, h["mlp"]["proj"], dtype)
    return (res + pooled)[:, 0].float()


def encode_text(params: Params, cfg: SiglipConfig, tokens: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, T] token ids → [B, width] features in float32 (bidirectional
    attention, last-position pooling, the learned head)."""
    t = cfg.text
    p = params["text"]
    tokens = torch.as_tensor(tokens).long().to(p["token_embedding"].device)
    x = p["token_embedding"][tokens].to(dtype)
    x = x + p["pos_embedding"][: x.shape[1]].to(dtype)
    for blk in p["blocks"]:
        x = _block(x, blk, t.heads, dtype)
    x = layer_norm(x, p["ln_final"], eps=LN_EPS_SIGLIP)
    return _dense(x[:, -1], p["head"], dtype).float()


def siglip_forward(params: Params, cfg: SiglipConfig, pixels: torch.Tensor, tokens: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    img = encode_image(params, cfg, pixels, dtype)
    txt = encode_text(params, cfg, tokens, dtype)
    img_n = img / img.norm(dim=-1, keepdim=True)
    txt_n = txt / txt.norm(dim=-1, keepdim=True)
    logits = img_n @ txt_n.T * params["logit_scale"].float().exp() + params["logit_bias"].float()
    return {
        "image_features": img_n,
        "text_features": txt_n,
        "logits_per_image": logits,
        "logits_per_text": logits.T,
    }


# -- HF converter -----------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _lin(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}


def _hf_block(sd, prefix):
    att = f"{prefix}.self_attn"
    return {
        "ln_1": _ln(sd, f"{prefix}.layer_norm1"),
        "attn": {
            "qkv": {
                "kernel": np.concatenate([_np(sd[f"{att}.{n}_proj.weight"]).T for n in "qkv"], axis=1),
                "bias": np.concatenate([_np(sd[f"{att}.{n}_proj.bias"]) for n in "qkv"]),
            },
            "out": _lin(sd, f"{att}.out_proj"),
        },
        "ln_2": _ln(sd, f"{prefix}.layer_norm2"),
        "mlp": {"fc": _lin(sd, f"{prefix}.mlp.fc1"), "proj": _lin(sd, f"{prefix}.mlp.fc2")},
    }


def from_hf_siglip_state_dict(sd: Mapping[str, Any], cfg: SiglipConfig) -> dict:
    """``transformers.SiglipModel.state_dict()`` → params tree of numpy
    arrays (``params_from_numpy`` moves it to a device)."""
    vm, tm = "vision_model", "text_model"
    visual = {
        "patch_embed": {
            "kernel": _np(sd[f"{vm}.embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{vm}.embeddings.patch_embedding.bias"]),
        },
        "pos_embedding": _np(sd[f"{vm}.embeddings.position_embedding.weight"]),
        "blocks": [_hf_block(sd, f"{vm}.encoder.layers.{i}") for i in range(cfg.vision.layers)],
        "ln_post": _ln(sd, f"{vm}.post_layernorm"),
        "head": {
            "probe": _np(sd[f"{vm}.head.probe"]).reshape(1, -1),
            "attn": {
                # torch nn.MultiheadAttention packs qkv as in_proj
                "qkv": {"kernel": _np(sd[f"{vm}.head.attention.in_proj_weight"]).T,
                        "bias": _np(sd[f"{vm}.head.attention.in_proj_bias"])},
                "out": _lin(sd, f"{vm}.head.attention.out_proj"),
            },
            "ln": _ln(sd, f"{vm}.head.layernorm"),
            "mlp": {"fc": _lin(sd, f"{vm}.head.mlp.fc1"), "proj": _lin(sd, f"{vm}.head.mlp.fc2")},
        },
    }
    text = {
        "token_embedding": _np(sd[f"{tm}.embeddings.token_embedding.weight"]),
        "pos_embedding": _np(sd[f"{tm}.embeddings.position_embedding.weight"]),
        "blocks": [_hf_block(sd, f"{tm}.encoder.layers.{i}") for i in range(cfg.text.layers)],
        "ln_final": _ln(sd, f"{tm}.final_layer_norm"),
        "head": _lin(sd, f"{tm}.head"),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
        "logit_bias": _np(sd["logit_bias"]).reshape(()),
    }


# Published SigLIP geometries (HF model-card configs; the weights are
# deployment assets, these are the shapes).
SIGLIP_REGISTRY: dict[str, SiglipConfig] = {
    "siglip-base-patch16-224": SiglipConfig(),
    "siglip-base-patch16-256": SiglipConfig(vision=SiglipVisionConfig(image_size=256)),
    "siglip-base-patch16-384": SiglipConfig(vision=SiglipVisionConfig(image_size=384)),
    "siglip-large-patch16-256": SiglipConfig(
        vision=SiglipVisionConfig(image_size=256, width=1024, layers=24, heads=16, mlp_dim=4096),
        text=SiglipTextConfig(width=1024, layers=24, heads=16, mlp_dim=4096),
    ),
    "siglip-so400m-patch14-384": SiglipConfig(
        vision=SiglipVisionConfig(image_size=384, patch_size=14, width=1152, layers=27, heads=16,
                                  mlp_dim=4304),
        text=SiglipTextConfig(width=1152, layers=27, heads=16, mlp_dim=4304),
    ),
}


def get_siglip_config(name: str) -> SiglipConfig:
    try:
        return SIGLIP_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown SigLIP model {name!r}; known: {sorted(SIGLIP_REGISTRY)}") from None


def siglip_config_from_hf(hf_cfg) -> SiglipConfig:
    """``transformers.SiglipConfig`` → :class:`SiglipConfig`."""
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    return SiglipConfig(
        vision=SiglipVisionConfig(
            image_size=v.image_size, patch_size=v.patch_size, width=v.hidden_size,
            layers=v.num_hidden_layers, heads=v.num_attention_heads, mlp_dim=v.intermediate_size,
        ),
        text=SiglipTextConfig(
            context_length=t.max_position_embeddings, vocab_size=t.vocab_size, width=t.hidden_size,
            layers=t.num_hidden_layers, heads=t.num_attention_heads, mlp_dim=t.intermediate_size,
        ),
    )
