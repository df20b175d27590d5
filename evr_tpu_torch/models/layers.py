"""Transformer building blocks for the CLIP towers (PyTorch).

Counterpart of ``evr_tpu/models/layers.py``: functions of a params dict
(``evr_tpu``'s layout, kernels ``[in, out]``) and a tensor. Numerics follow
OpenAI CLIP: pre-LN residual blocks, quickGELU, LayerNorm eps 1e-5 with the
statistics always in fp32 whatever the compute dtype.

``block_apply(attn_impl="auto")`` routes CUDA tensors of towers up to width
1280 through the hand-written kernels K1 and K2, or K3 on int8 params
(``ops.block_fused``); a block the fused route does not take runs the
composition below, whose attention follows ``attention(impl=...)`` as in the
JAX package (``layers.py:78-122, 317-365``): "xla" (the plain math), "flash"
(kernel K6, ``ops.attention.flash_attention``, at any width) or "auto"
("flash" on a CUDA tensor at T >= 256, "xla" otherwise; so a tower wider than
1280 reaches K6 under "auto"). Under grad mode the fused route goes through
``ops.block_fused.FusedBlockFunction``, whose backward is K5b then K5a, and
K6 through ``ops.attention.FlashAttentionFunction``, whose backward is the
plain recompute. ``attn_impl="auto_grad"`` is the training resolution of the
JAX package (``layers.py:338-344``): "auto" when T >= 512, "xla" otherwise.
``attn_impl="plain"`` runs K1's and K2's plain PyTorch versions (forward and
backward) on any device: the reference the fused route is held to on the
card; ``"plain_grad"`` is that reference for a training step (the plain
versions where "auto_grad" runs kernels), and ``"flash_plain"`` the
reference of "flash" (K6's plain version). An ``attn_impl`` outside
``ATTN_IMPLS`` raises ``ValueError``. ``linear`` dispatches on the int8
layout of ``models.quant`` (``kernel_q``) to ``quantized_linear``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from evr_tpu_torch.ops.attention import flash_attention, xla_attention
from evr_tpu_torch.ops.block_fused import (
    fused_block_apply,
    fused_quant_block_apply,
    plain_block_apply,
)

from .quant import quantized_linear

Params = dict[str, Any]

LN_EPS = 1e-5
ATTN_IMPLS = ("auto", "auto_grad", "xla", "flash", "plain", "plain_grad", "flash_plain")
FUSED_MAX_WIDTH = 1280  # the widest tower the fused block route takes, as in the JAX package


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — OpenCLIP's laion-trained towers."""
    return torch.nn.functional.gelu(x, approximate="none")


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu}


def layer_norm(x: torch.Tensor, p: Params, eps: float = LN_EPS) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "kernel_q" in p:  # int8 weights (models.quant)
        return quantized_linear(x, p)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def attention(
    x: torch.Tensor, p: Params, n_heads: int, causal: bool = False, impl: str = "xla"
) -> torch.Tensor:
    """Multi-head self-attention over [B, T, W]. ``impl``: "xla" (the
    XLA-path math of the JAX package: fp32 scores and softmax, causal fill
    -1e9), "flash" (K6 on a CUDA tensor, its plain version on a CPU one),
    "auto" ("flash" on a CUDA tensor at T >= 256, else "xla") or
    "flash_plain" (K6's plain version on any device)."""
    B, T, W = x.shape
    d = W // n_heads
    if impl == "auto":
        impl = "flash" if T >= 256 and x.is_cuda else "xla"
    q, k, v = (
        t.reshape(B, T, n_heads, d).transpose(1, 2)
        for t in linear(x, p["qkv"]).split(W, dim=-1)
    )
    if impl in ("flash", "flash_plain"):
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                            impl="kernel" if impl == "flash" else "plain")
    elif impl == "xla":
        o = xla_attention(q, k, v, causal)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return linear(o.transpose(1, 2).reshape(B, T, W), p["out"])


def final_block_cls(
    x: torch.Tensor, p: Params, n_heads: int, activation: str = "quick_gelu"
) -> torch.Tensor:
    """Final vision block computed for the CLS row only → [B, W]: K/V over
    every token, Q, the scores, out-proj and MLP on row 0 (pooling reads
    nothing else). Plain PyTorch on every device, as in the JAX package."""
    return _final_block_row(x, p, n_heads, None, activation)


def final_block_eot(
    x: torch.Tensor, p: Params, n_heads: int, eot_pos: torch.Tensor,
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """Final causal text block computed for the EOT row only → [B, W]; the
    row attends to positions ≤ eot_pos (mask fill -1e9)."""
    return _final_block_row(x, p, n_heads, eot_pos, activation)


def _final_block_row(x, p, n_heads, row_idx, activation):
    B, T, W = x.shape
    d = W // n_heads
    ap = p["attn"]
    y = layer_norm(x, p["ln_1"])

    def pick(a):
        if row_idx is None:
            return a[:, 0]
        return a[torch.arange(B, device=a.device), row_idx]

    if "kernel_q" in ap["qkv"]:
        # int8 weights: the full QKV through the quantized linear, then the
        # pooled row's Q sliced out (rounds unlike the float branch below)
        qkv = linear(y, ap["qkv"])
        q = pick(qkv[..., :W])
        k, v = qkv[..., W : 2 * W], qkv[..., 2 * W :]
    else:
        # project Q on the pooled row only, K/V on every row
        kern = ap["qkv"]["kernel"].to(y.dtype)
        bias = ap["qkv"]["bias"].to(y.dtype)
        kv = y @ kern[:, W:] + bias[W:]
        k, v = kv[..., :W], kv[..., W:]
        q = pick(y) @ kern[:, :W] + bias[:W]
    q = q.reshape(B, n_heads, d)
    k = k.reshape(B, T, n_heads, d)
    v = v.reshape(B, T, n_heads, d)
    logits = torch.einsum("bhd,bthd->bht", q, k).float() * (1.0 / math.sqrt(d))
    if row_idx is not None:
        valid = torch.arange(T, device=x.device)[None, :] <= row_idx[:, None]
        logits = torch.where(valid[:, None, :], logits, torch.tensor(-1e9, device=x.device))
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bht,bthd->bhd", w, v).reshape(B, W)
    xc = pick(x) + linear(o, ap["out"])
    h = ACTIVATIONS[activation](linear(layer_norm(xc, p["ln_2"]), p["mlp"]["fc"]))
    return xc + linear(h, p["mlp"]["proj"])


def block_apply_cached(
    x_new: torch.Tensor,
    p: Params,
    n_heads: int,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    activation: str = "quick_gelu",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One causal block over new rows with a KV cache (JAX
    ``layers.block_apply_cached``): ``x_new`` [B, S, W] holds absolute
    positions ``pos .. pos+S-1``; their K/V are written into rows ``pos ..
    pos+S-1`` of ``k_cache``/``v_cache`` [B, T_max, heads, head_dim] (new
    tensors are returned; the caller's are not written), key t is visible
    to new row s iff t ≤ pos + s (later rows masked with −1e9, so stale rows
    are inert). Row for row the math of ``block_apply(causal=True)``'s plain
    composition: fp32 scores and softmax, the weights rounded to x's dtype.
    Plain PyTorch on every device, as in the JAX package. Returns ``(y_new,
    k_cache, v_cache)``."""
    B, S, W = x_new.shape
    d = W // n_heads
    ap = p["attn"]
    T_max = k_cache.shape[1]
    q, k, v = linear(layer_norm(x_new, p["ln_1"]), ap["qkv"]).split(W, dim=-1)
    q = q.reshape(B, S, n_heads, d)
    k_cache = torch.cat([k_cache[:, :pos], k.reshape(B, S, n_heads, d).to(k_cache.dtype),
                         k_cache[:, pos + S:]], dim=1)
    v_cache = torch.cat([v_cache[:, :pos], v.reshape(B, S, n_heads, d).to(v_cache.dtype),
                         v_cache[:, pos + S:]], dim=1)
    logits = torch.einsum("bshd,bthd->bhst", q, k_cache).float() * (1.0 / math.sqrt(d))
    dev = x_new.device
    valid = torch.arange(T_max, device=dev)[None, :] <= pos + torch.arange(S, device=dev)[:, None]
    logits = torch.where(valid[None, None], logits, torch.tensor(-1e9, device=dev))
    w = torch.softmax(logits, dim=-1).to(x_new.dtype)
    o = torch.einsum("bhst,bthd->bshd", w, v_cache.to(x_new.dtype))
    xc = x_new + linear(o.reshape(B, S, W), ap["out"])
    h = ACTIVATIONS[activation](linear(layer_norm(xc, p["ln_2"]), p["mlp"]["fc"]))
    return xc + linear(h, p["mlp"]["proj"]), k_cache, v_cache


def block_apply(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    causal: bool = False,
    attn_impl: str = "xla",
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """One pre-LN residual block. ``attn_impl`` (default "xla", as in the JAX
    package; the towers pass ``CLIPConfig.attn_impl``, "auto" by default):
    "auto" (kernels K1 → K2, or K3a → K3b on int8 params, for a CUDA tensor
    of width ≤ 1280; otherwise the composition with
    ``attention(impl="auto")``), "auto_grad" ("auto" at
    T ≥ 512, else "xla"), "xla" (the plain composition), "flash" (the
    composition with K6 at any width), "plain" (K1's and K2's plain
    versions, the reference of the fused route), "plain_grad" ("plain" at
    T ≥ 512, else "xla": a training step with each kernel of "auto_grad"
    replaced by its plain version) or "flash_plain" ("flash" with K6's plain
    version).
    A differentiable call on the fused route runs K5b → K5a backward
    (``FusedBlockFunction``), on K6 the plain recompute
    (``FlashAttentionFunction``); int8 params are inference only and their
    kernels refuse inputs that require grad."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} (supported: {ATTN_IMPLS})")
    if attn_impl in ("auto_grad", "plain_grad"):
        # the fused backward only where the JAX trainer takes it (T ≥ 512)
        attn_impl = attn_impl.removesuffix("_grad") if x.shape[1] >= 512 else "xla"
    if attn_impl == "auto" and x.shape[2] <= FUSED_MAX_WIDTH and x.is_cuda:
        if "kernel_q" in p["attn"]["qkv"]:
            return fused_quant_block_apply(x, p, n_heads, activation, causal)
        return fused_block_apply(x, p, n_heads, activation, causal)
    if attn_impl == "plain":
        return plain_block_apply(x, p, n_heads, activation, causal)
    x = x + attention(layer_norm(x, p["ln_1"]), p["attn"], n_heads, causal, attn_impl)
    h = ACTIVATIONS[activation](linear(layer_norm(x, p["ln_2"]), p["mlp"]["fc"]))
    return x + linear(h, p["mlp"]["proj"])
