"""Multi-head attention over [B, H, T, d]: hand-written CUDA kernel K6.

Counterpart of ``evr_tpu/ops/attention.py`` (``flash_attention``), the
attention of every full block under ``CLIPConfig.attn_impl="flash"`` (and
of ``"auto"`` towers wider than 1280 at T ≥ 256). The JAX package runs it as
two Pallas kernels, which the port keeps as two routes of one CUDA kernel
(``csrc/flash_attn.cu``), picked by the JAX rule:

- K6a ``flash_attention_full``, the whole-sequence route: not causal, no
  ``block_q`` given and T·T·4 ≤ 4 MiB (the TPU kernel packs up to four
  sequences into one tile when T < 128);
- K6b ``flash_attention_blocked``, otherwise: the TPU kernel pads T to a
  multiple of 128 with a −1e30 bias on the padded keys, applies the causal
  fill −1e30 and tiles the queries by ``block_q``.

Every masked score of either TPU kernel gives exp(s − m) = 0 exactly in
fp32, so the kernel leaves keys past T and past the diagonal out of the row
and packs and pads nothing; ``block_q`` selects the route and changes no
value. Rounding points (both routes): q times 1/√d in q's dtype, the scale
rounded to that dtype first (for d = 80 in bf16, 0.11181640625); scores
and softmax in fp32 with the row max over the whole row; p rounded for p·v;
the fp32 sum of the unrounded p divides after p·v; the output rounded.
``flash_attention_plain`` is that function in plain PyTorch (the attention
core of K1's plain version, ``block_fused.attend_heads``).

``flash_attention`` is differentiable, as the JAX custom VJP is: the forward
is K6 and saves q, k and v; the backward differentiates ``xla_attention``
(the XLA-path einsum attention, ``_xla_attention``) recomputed from them. K6
has no backward kernel in the JAX package and none here.

The kernel takes head dims 16, 64 and 80, bfloat16 or float32, contiguous
16-byte-aligned inputs of one shape on one device. A CUDA tensor launches
the kernel or raises, with no fallback; a CPU tensor takes the plain
version. Every launch adds one to its route's ``launches`` count.
"""

from __future__ import annotations

import math

import torch

from . import build
from .block_fused import _DTYPE_CODES, _raise_rc, attend_heads

HEAD_DIMS = (16, 64, 80)
WHOLE_SEQUENCE_SCORE_BYTES = 4 * 1024 * 1024  # the JAX route rule: T·T·4 ≤ 4 MiB
IMPLS = ("kernel", "plain")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """K6's function in plain PyTorch over [B, H, T, d], in q's dtype."""
    return attend_heads(q, k, v, causal)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False) -> torch.Tensor:
    """The XLA-path attention of the JAX package (``_xla_attention``): q·kᵀ
    rounded to the element type, then times 1/√d in fp32, the causal fill
    −1e9, fp32 softmax, weights cast back for the product with v."""
    T, d = q.shape[-2:]
    logits = (q @ k.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, torch.tensor(-1e9, device=q.device))
    return torch.softmax(logits, dim=-1).to(q.dtype) @ v


def whole_sequence_route(T: int, causal: bool, block_q: int | None) -> bool:
    """True where the JAX wrapper takes K6a (``attention.py:168``)."""
    return not causal and block_q is None and T * T * 4 <= WHOLE_SEQUENCE_SCORE_BYTES


def _check_kernel_inputs(q, k, v, what: str) -> None:
    """What the kernel reads through raw pointers."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q of shape {tuple(q.shape)}, expected [B, H, T, d]")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported (float32 or bfloat16)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} not supported (the kernel takes {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{what}: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; q is "
                f"{q.dtype} {tuple(q.shape)} on {q.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _launch(q, k, v, causal: bool, what: str) -> torch.Tensor:
    _check_kernel_inputs(q, k, v, what)
    B, H, T, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype).item()  # rounded to q's dtype
    o = torch.empty_like(q)
    rc = build.load("flash_attn").evr_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, T, d,
        int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_rc(rc, what, q.shape)
    return o


def flash_attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K6a: non-causal attention over whole sequences [B, H, T, d]."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, False)
    o = _launch(q, k, v, False, "flash_attention_full")
    flash_attention_full.launches += 1
    return o


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = False) -> torch.Tensor:
    """K6b: attention over [B, H, T, d], causal or not, the TPU's padded
    blocked route."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    o = _launch(q, k, v, causal, "flash_attention_blocked")
    flash_attention_blocked.launches += 1
    return o


flash_attention_full.launches = 0
flash_attention_blocked.launches = 0


def _forward(q, k, v, causal: bool, block_q: int | None, impl: str) -> torch.Tensor:
    if impl == "plain":
        return flash_attention_plain(q, k, v, causal)
    if whole_sequence_route(q.shape[2], causal, block_q):
        return flash_attention_full(q, k, v)
    return flash_attention_blocked(q, k, v, causal)


class FlashAttentionFunction(torch.autograd.Function):
    """K6 with the backward of the JAX custom VJP (``_flash_fwd`` /
    ``_flash_bwd``): the forward saves the unscaled q, k and v; the backward
    is autograd through ``xla_attention`` recomputed from them.

    ``apply(q, k, v, causal, block_q, impl)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, impl):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal, block_q, impl)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = xla_attention(*leaves, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, T, d]
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int | None = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Attention over [B, H, T, d], same shape and dtype as q: K6a or K6b
    (``impl="kernel"``; the plain version on a CPU tensor) or the plain
    version on any device (``impl="plain"``, the reference the kernel is held
    to on the card). Differentiable (``FlashAttentionFunction``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (supported: {IMPLS})")
    return FlashAttentionFunction.apply(q, k, v, causal, block_q, impl)
