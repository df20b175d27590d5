"""Per-token int8 quantisation and the exact int8 product, in plain PyTorch.

Shared by ``models.quant.quantized_linear`` and the plain versions of the
fused kernels K3 (``ops.block_fused``), as ``_quant_rows``/``_quant_dot`` of
``evr_tpu/ops/block_fused.py`` are shared there.

The exact integer product: ``int8 @ int8`` on the CPU returns int8 and wraps
around, and ``torch.matmul`` refuses integer tensors on CUDA. Both int8
operands are therefore multiplied in float64, which is exact on either device
(the largest sum, K · 127² with K = 3072, is about 4.95e7, far below 2⁵³;
float32 would be exact only up to K = 1040).
"""

from __future__ import annotations

import torch

SCALE_FLOOR = 1e-12  # scale of an all-zero row or column


def quantize_rows(y32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 [..., C] → (int8 [..., C], fp32 [..., 1] scale): symmetric absmax
    per row, rounding half to even, no clipping (|y / scale| ≤ 127)."""
    scale = torch.clamp_min(y32.abs().amax(dim=-1, keepdim=True) / 127.0, SCALE_FLOOR)
    return torch.round(y32 / scale).to(torch.int8), scale


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 [..., K] @ int8 [K, N] → float32, through float64."""
    return (a_q.double() @ b_q.double()).float()


def dequant_dot(y32: torch.Tensor, kernel_q, kernel_scale, bias=None) -> torch.Tensor:
    """fp32 activations × int8 weights → fp32: per-token quantisation, exact
    integer product, ``acc · x_scale · kernel_scale (+ bias)``."""
    x_q, x_scale = quantize_rows(y32)
    y = int8_matmul(x_q, kernel_q) * x_scale * kernel_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y
