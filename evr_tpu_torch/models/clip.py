"""CLIP dual-encoder in PyTorch.

Counterpart of ``evr_tpu/models/clip.py``: the same configuration dataclasses,
the same params layout, and the same forward functions as functions of a
params dict of tensors:

- vision tower: bias-free patch-embedding conv (HWIO kernel), class token,
  learned positional embeddings, pre-LN blocks, ``ln_post`` and the
  projection of the class token;
- text tower: token plus positional embeddings (77 positions), causal blocks,
  ``ln_final`` and the projection at the EOT position (argmax token id).

The compute dtype is an argument (bfloat16 on the card, float32 on the CPU
and for parity tests). ``init_clip_params`` draws random weights from a
numpy ``Generator``: the JAX package's random streams cannot be reproduced,
so tests carry its params across with ``models.convert.params_from_numpy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.utils.checkpoint

from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, cubic_weight_mat

from .layers import Params, block_apply, final_block_cls, final_block_eot, layer_norm


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


@dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    # "auto" | "auto_grad" | "xla" | "flash" | "plain" | "plain_grad" | "flash_plain"
    # — see layers.block_apply; "flash" runs every full block's attention
    # through kernel K6 (ops.attention), the pooled-row final blocks stay plain
    attn_impl: str = "auto"
    # "quick_gelu" (OpenAI CLIP) | "gelu" (OpenCLIP laion towers)
    activation: str = "quick_gelu"
    # rematerialise each transformer block in the backward pass (memory ↔
    # FLOPs trade for training): ``torch.utils.checkpoint`` under grad mode
    remat: bool = False


# -- init -----------------------------------------------------------------


def _init_block(rng: np.random.Generator, width: int, n_layers: int) -> dict:
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    normal = lambda shape, std: (rng.standard_normal(shape, dtype=np.float32) * std)  # noqa: E731
    zeros = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    ln = lambda: {"scale": np.ones((width,), np.float32), "bias": zeros(width)}  # noqa: E731
    return {
        "ln_1": ln(),
        "attn": {
            "qkv": {"kernel": normal((width, 3 * width), width ** -0.5), "bias": zeros(3 * width)},
            "out": {"kernel": normal((width, width), proj_std), "bias": zeros(width)},
        },
        "ln_2": ln(),
        "mlp": {
            "fc": {"kernel": normal((width, 4 * width), (2 * width) ** -0.5), "bias": zeros(4 * width)},
            "proj": {"kernel": normal((4 * width, width), proj_std), "bias": zeros(width)},
        },
    }


def init_clip_params(rng: np.random.Generator | int, cfg: CLIPConfig) -> dict:
    """Random CLIP weights at CLIP's init scales, as a nested dict of numpy
    float32 arrays in the JAX package's layout (``params_from_numpy`` moves
    them to a device)."""
    rng = np.random.default_rng(rng)
    v, t = cfg.vision, cfg.text
    normal = lambda shape, std: rng.standard_normal(shape, dtype=np.float32) * std  # noqa: E731
    ln = lambda w: {"scale": np.ones((w,), np.float32), "bias": np.zeros((w,), np.float32)}  # noqa: E731
    scale = v.width ** -0.5
    visual = {
        "patch_embed": {"kernel": normal((v.patch_size, v.patch_size, 3, v.width), scale)},
        "class_embedding": normal((v.width,), scale),
        "pos_embedding": normal((v.seq_len, v.width), scale),
        "ln_pre": ln(v.width),
        "blocks": [_init_block(rng, v.width, v.layers) for _ in range(v.layers)],
        "ln_post": ln(v.width),
        "proj": normal((v.width, cfg.embed_dim), scale),
    }
    text = {
        "token_embedding": normal((t.vocab_size, t.width), 0.02),
        "pos_embedding": normal((t.context_length, t.width), 0.01),
        "blocks": [_init_block(rng, t.width, t.layers) for _ in range(t.layers)],
        "ln_final": ln(t.width),
        "text_projection": normal((t.width, cfg.embed_dim), t.width ** -0.5),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": np.asarray(math.log(1.0 / 0.07), np.float32),
    }


# -- positional-embedding interpolation (ViT-L/14@336px and friends) ------


def interpolate_pos_embedding(pos, new_grid: int) -> torch.Tensor:
    """Resample the patch-position grid of a vision ``pos_embedding``
    [1 + g², W] to ``new_grid``² positions (the class position kept), by the
    JAX package's cubic resize: one weight matrix per axis, applied as two
    products in float64. Loads 224px checkpoints into higher-resolution
    towers such as ViT-L/14@336px."""
    pos = torch.as_tensor(pos)
    cls_tok, grid_tok = pos[:1], pos[1:]
    old_grid = int(math.sqrt(grid_tok.shape[0]))
    w = torch.from_numpy(cubic_weight_mat(old_grid, new_grid)).to(pos.device)
    grid = grid_tok.reshape(old_grid, old_grid, -1).double()
    resized = torch.einsum("ai,bj,abc->ijc", w, w, grid).to(pos.dtype)
    return torch.cat([cls_tok, resized.reshape(new_grid * new_grid, -1)], dim=0)


# -- forward --------------------------------------------------------------


def _run_blocks(x, blocks, heads, causal, cfg: CLIPConfig):
    """The block stack. With ``cfg.remat`` under grad mode each block runs
    in ``torch.utils.checkpoint`` (non-reentrant, as ``jax.checkpoint``):
    its activations are recomputed in the backward instead of stored, so a
    block on the fused route runs its forward kernels twice a step."""
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                block_apply, x, bp, heads, causal, cfg.attn_impl, cfg.activation, use_reentrant=False
            )
        else:
            x = block_apply(x, bp, heads, causal, cfg.attn_impl, cfg.activation)
    return x


def _vision_prefix(p, cfg: CLIPConfig, x, dtype, patch_keep=None) -> torch.Tensor:
    """[B, grid², width] patch tokens → cls/pos (→ the kept patches) →
    ln_pre: the block stack's input. ``patch_keep`` [B, K] int: the patch
    tokens kept (FLIP masking), gathered after the positional add in the
    order given, the class token first."""
    v = cfg.vision
    B = x.shape[0]
    cls = p["class_embedding"].to(dtype).expand(B, 1, v.width)
    x = torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dtype)
    if patch_keep is not None:
        idx = torch.as_tensor(patch_keep, device=x.device).long()
        kept = torch.gather(x[:, 1:], 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
        x = torch.cat([x[:, :1], kept], dim=1)
    return layer_norm(x, p["ln_pre"])


def _vision_transform(p, cfg: CLIPConfig, x, dtype, cls_fast_final=False, patch_keep=None) -> torch.Tensor:
    """[B, grid², width] patch tokens → ``_vision_prefix`` → blocks →
    pooled projection [B, embed_dim] in float32. ``cls_fast_final`` runs the
    last block for the CLS row only (``layers.final_block_cls``), never
    under ``cfg.remat``."""
    v = cfg.vision
    x = _vision_prefix(p, cfg, x, dtype, patch_keep)
    if cls_fast_final and not cfg.remat:
        x = _run_blocks(x, p["blocks"][:-1], v.heads, False, cfg)
        pooled = final_block_cls(x, p["blocks"][-1], v.heads, cfg.activation)
    else:
        x = _run_blocks(x, p["blocks"], v.heads, False, cfg)
        pooled = x[:, 0]
    pooled = layer_norm(pooled, p["ln_post"])
    return (pooled @ p["proj"].to(dtype)).float()


def _patch_tokens(p, cfg: CLIPConfig, pixels: torch.Tensor, dtype) -> torch.Tensor:
    """pixels [B, H, W, 3] → [B, grid², width] by the bias-free patch conv."""
    v = cfg.vision
    x = pixels.to(dtype).permute(0, 3, 1, 2)
    kernel = p["patch_embed"]["kernel"].to(dtype).permute(3, 2, 0, 1)  # HWIO → OIHW
    x = torch.nn.functional.conv2d(x, kernel, stride=v.patch_size)
    B = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(B, v.grid * v.grid, v.width)


def encode_image(
    params: Params,
    cfg: CLIPConfig,
    pixels: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    patch_keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """pixels [B, H, W, 3] (preprocessed, NHWC) → [B, embed_dim], unnormalised.
    ``patch_keep`` [B, K] int: the indices of the patch tokens to keep (FLIP
    masking, training only): the blocks run on K + 1 tokens. None: every
    token."""
    p = params["visual"]
    return _vision_transform(p, cfg, _patch_tokens(p, cfg, pixels, dtype), dtype, patch_keep=patch_keep)


def vision_tokens(params: Params, cfg: CLIPConfig, pixels: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The vision stem alone: pixels [B, H, W, 3] → [B, T, width], the block
    stack's input (patch conv, cls/pos, ln_pre). With ``vision_pool`` it
    splits ``encode_image`` into stem → blocks → pool, the split that
    ``parallel.pp`` pipelines over stages and ``parallel.sp`` shards by
    token."""
    p = params["visual"]
    return _vision_prefix(p, cfg, _patch_tokens(p, cfg, pixels, dtype), dtype)


def vision_pool(params: Params, cfg: CLIPConfig, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The block stack's output [B, T, width] → [B, embed_dim] float32: the
    CLS row, ln_post, the projection."""
    p = params["visual"]
    pooled = layer_norm(x[:, 0], p["ln_post"])
    return (pooled @ p["proj"].to(dtype)).float()


def encode_staged_u8(
    params: Params,
    cfg: CLIPConfig,
    staged_u8: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    mean=None,
    std=None,
    cls_fast_final: bool = True,
) -> torch.Tensor:
    """uint8 staged frames [B, S, S, 3] → [B, embed_dim], the serving path.

    The patches are unfolded in uint8 and the normalisation is folded into
    the patch GEMM, ``(x/255 − m)/s · K = x · K/(255 s) − Σ (m/s) K``,
    exactly as the JAX package does it (same casts, same order). ``mean``
    and ``std`` (per channel) default to CLIP's."""
    v = cfg.vision
    p = params["visual"]
    B, S = staged_u8.shape[0], staged_u8.shape[1]
    if S != v.image_size or staged_u8.shape[2] != v.image_size:
        raise ValueError(
            f"staged batch is {staged_u8.shape[1]}x{staged_u8.shape[2]}, "
            f"model wants {v.image_size}^2"
        )
    g, P = v.grid, v.patch_size
    dev = staged_u8.device
    mean = torch.as_tensor(CLIP_MEAN if mean is None else mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(CLIP_STD if std is None else std, dtype=torch.float32, device=dev)

    # unfold in uint8: [B,S,S,3] → [B,g,P,g,P,3] → [B,g,g,P,P,3] → [B,g²,P²·3]
    patches = staged_u8.reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, g * g, P * P * 3).to(dtype)  # 0..255 exact in bf16

    k = p["patch_embed"]["kernel"].float()  # [P, P, 3, W]
    scale = (1.0 / (255.0 * std))[None, None, :, None]
    k_scaled = (k * scale).reshape(P * P * 3, v.width).to(dtype)
    bias = -torch.einsum("hwco,c->o", k, mean / std).to(dtype)

    x = patches @ k_scaled + bias
    return _vision_transform(p, cfg, x, dtype, cls_fast_final=cls_fast_final)


def text_tokens(params: Params, cfg: CLIPConfig, tokens: torch.Tensor, dtype=torch.float32):
    """tokens [B, 77] → [B, 77, width] token plus positional embeddings."""
    p = params["text"]
    return p["token_embedding"].to(dtype)[tokens] + p["pos_embedding"].to(dtype)


def text_pool(params: Params, cfg: CLIPConfig, x: torch.Tensor, tokens: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The causal block stack's output [B, 77, width] → [B, embed_dim]
    float32: the row at the EOT position (argmax token id), ln_final, the
    projection."""
    p = params["text"]
    eot_pos = tokens.long().argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos.to(x.device)]
    pooled = layer_norm(pooled, p["ln_final"])
    return (pooled @ p["text_projection"].to(dtype)).float()


def encode_text(
    params: Params,
    cfg: CLIPConfig,
    tokens: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    eot_fast_final: bool = False,
) -> torch.Tensor:
    """tokens [B, 77] int → [B, embed_dim] (unnormalised), pooled at the EOT
    position (argmax token id). ``eot_fast_final`` runs the last block for
    the EOT row only (``layers.final_block_eot``), the serving path; never
    under ``cfg.remat``."""
    t = cfg.text
    p = params["text"]
    tokens = tokens.long()
    eot_pos = tokens.argmax(dim=-1)
    x = text_tokens(params, cfg, tokens, dtype)
    if eot_fast_final and not cfg.remat:
        x = _run_blocks(x, p["blocks"][:-1], t.heads, True, cfg)
        pooled = final_block_eot(x, p["blocks"][-1], t.heads, eot_pos, cfg.activation)
    else:
        x = _run_blocks(x, p["blocks"], t.heads, True, cfg)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
    pooled = layer_norm(pooled, p["ln_final"])
    return (pooled @ p["text_projection"].to(dtype)).float()


def clip_forward(
    params: Params,
    cfg: CLIPConfig,
    pixels: torch.Tensor,
    tokens: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Joint forward: L2-normalised features and similarity logits scaled by
    exp(logit_scale), both directions."""
    img = encode_image(params, cfg, pixels, dtype)
    txt = encode_text(params, cfg, tokens, dtype)
    img_n = img / img.norm(dim=-1, keepdim=True)
    txt_n = txt / txt.norm(dim=-1, keepdim=True)
    logits_per_image = params["logit_scale"].float().exp() * img_n @ txt_n.T
    return {
        "image_features": img_n,
        "text_features": txt_n,
        "logits_per_image": logits_per_image,
        "logits_per_text": logits_per_image.T,
    }
