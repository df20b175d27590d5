"""Fused LayerNorm with an optional quickGELU tail: hand-written CUDA kernel K8.

Counterpart of ``evr_tpu/ops/layernorm.py``: ``fused_layer_norm`` normalises
the last axis of an x of any rank with fp32 statistics and casts once at the
end, source ``csrc/layernorm.cu``. As in the JAX package, it is an exported
op that no tower calls: the towers normalise with ``models.layers.layer_norm``
and in the prologues of the block kernels.

A CUDA tensor of float32 or bfloat16 launches the kernel (or raises); a CPU
tensor takes the plain PyTorch version beside it, which has the same
rounding points and is the comparison the chip smoke run holds the kernel
to. Every kernel launch adds one to ``fused_layer_norm.launches``.
"""

from __future__ import annotations

import torch

from . import build
from .block_fused import _DTYPE_CODES, LN_EPS, _raise_rc, refuse_grad


def fused_layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, activation: str = "none"
) -> torch.Tensor:
    """K8's function in plain PyTorch (``_ln_kernel``): x in fp32, the mean,
    then the mean of the squared deviations, rsqrt(var + 1e-5), scale and
    bias in fp32, quickGELU only for ``activation="quick_gelu"`` (any other
    value is no tail, as in the JAX kernel), one cast to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    y = y * scale.float() + bias.float()
    if activation == "quick_gelu":
        y = y * torch.sigmoid(1.702 * y)
    return y.to(x.dtype)


def fused_layer_norm(
    x: torch.Tensor,  # [..., D]
    scale: torch.Tensor,  # [D]
    bias: torch.Tensor,  # [D]
    activation: str = "none",
) -> torch.Tensor:
    """Row LayerNorm in fp32 with an optional fused quickGELU tail, kernel K8
    on a CUDA tensor (float32 or bfloat16, any D, any number of rows)."""
    refuse_grad("fused_layer_norm", x, scale, bias)
    if not x.is_cuda:
        return fused_layer_norm_plain(x, scale, bias, activation)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_layer_norm: dtype {x.dtype} not supported (float32 or bfloat16)")
    D = x.shape[-1]
    params = [t.float().contiguous() for t in (scale, bias)]
    for t in params:
        if t.device != x.device or tuple(t.shape) != (D,):
            raise ValueError(
                f"fused_layer_norm: scale and bias must be [{D}] on {x.device}; "
                f"got {tuple(t.shape)} on {t.device}"
            )
    if x.numel() == 0:  # zero rows: nothing to launch
        return torch.empty_like(x)
    rows = x.numel() // D
    if rows >= 2**31:
        raise ValueError(f"fused_layer_norm: the CUDA kernel does not take shape {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = build.load("layernorm")
    rc = lib.evr_fused_layer_norm(
        _DTYPE_CODES[x.dtype], x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(), out.data_ptr(),
        rows, D, int(activation == "quick_gelu"), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_rc(rc, "fused_layer_norm", x.shape)
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
