"""Int8 quantized inference for the CLIP towers (PyTorch).

Counterpart of ``evr_tpu/models/quant.py``: every residual-block linear of
both towers (attn qkv/out, mlp fc/proj) gets int8 weights with one symmetric
scale per output channel; activations are quantised per token by absmax on
the fly; the product is int8 × int8 summed exactly and dequantised as
``acc · x_scale · kernel_scale + bias`` in fp32. LayerNorms, the patch stem,
the embeddings and the output projections stay in floating point.

The per-token quantisation and the exact integer product are in
``ops.int8``, shared with the plain versions of the fused kernels K3
(``ops.block_fused.fused_quant_block_apply``), which do the product on the
int8 tensor cores.

Quantized params are inference-only.
"""

from __future__ import annotations

from typing import Any

import torch

from evr_tpu_torch.ops.int8 import SCALE_FLOOR, dequant_dot

Params = dict[str, Any]


def quantize_linear_params(p: Params) -> Params:
    """fp linear params {kernel[, bias]} → int8 {kernel_q, kernel_scale[, bias]}.

    Symmetric per-output-channel quantisation: scale[j] = max_i |W[i,j]| / 127,
    floored at 1e-12; ``kernel_q = clip(round(W / scale), -127, 127)`` with
    rounding half to even. The bias is kept as given."""
    kernel = p["kernel"].float()
    scale = torch.clamp_min(kernel.abs().amax(dim=0) / 127.0, SCALE_FLOOR)
    kernel_q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    out: Params = {"kernel_q": kernel_q, "kernel_scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantized_linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = x @ W + b with W int8 and x quantised per token on the fly; the
    output has x's dtype."""
    return dequant_dot(x.float(), p["kernel_q"], p["kernel_scale"], p.get("bias")).to(x.dtype)


def is_quantized_linear(p: Params) -> bool:
    return isinstance(p, dict) and "kernel_q" in p


def _quantize_block(block: Params) -> Params:
    if is_quantized_linear(block["attn"]["qkv"]):  # idempotent
        return block
    out = dict(block)
    out["attn"] = {
        "qkv": quantize_linear_params(block["attn"]["qkv"]),
        "out": quantize_linear_params(block["attn"]["out"]),
    }
    out["mlp"] = {
        "fc": quantize_linear_params(block["mlp"]["fc"]),
        "proj": quantize_linear_params(block["mlp"]["proj"]),
    }
    return out


def quantize_clip_params(params: Params) -> Params:
    """Quantize every transformer-block linear of both towers to int8.

    Everything outside the blocks (patch embed, positional/token embeddings,
    LayerNorms, output projections, logit_scale) is left untouched."""
    out = dict(params)
    for tower in ("visual", "text"):
        if tower in params:
            tp = dict(params[tower])
            tp["blocks"] = [_quantize_block(b) for b in tp["blocks"]]
            out[tower] = tp
    return out


# SigLIP towers keep the block layout ({attn: {qkv, out}, mlp: {fc, proj}}
# under visual/text.blocks), so the same quantiser applies; the MAP head, the
# patch stem, the embeddings and the text head stay in floating point
# (models/siglip.py routes block linears through layers.linear).
quantize_siglip_params = quantize_clip_params
