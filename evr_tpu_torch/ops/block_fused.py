"""Fused pre-LN transformer-block halves: hand-written CUDA kernels K1–K3, K5, K9.

Counterpart of ``evr_tpu/ops/block_fused.py``: each residual block runs as two
fused halves,

- K1 ``fused_attn_block``: x + out(MHA(LN1 x)), source ``csrc/block_attn.cu``;
- K2 ``fused_mlp_block``: x + proj(act(fc(LN2 x))), source ``csrc/block_mlp.cu``;
- K3 ``fused_quant_block_apply``, the same two halves over int8 weights
  (``models.quant`` layout: ``kernel_q``/``kernel_scale``): K3a
  ``fused_attn_block_q`` and K3b ``fused_mlp_block_q``, source
  ``csrc/block_quant.cu``; inference only, as in the JAX package;
- K5, the backward of the two float halves: K5a ``fused_attn_block_bwd``
  (``csrc/block_attn_bwd.cu``) and K5b ``fused_mlp_block_bwd``
  (``csrc/block_mlp_bwd.cu``), each recomputing its half from x and giving
  dx and the fp32 parameter gradients; ``FusedBlockFunction`` composes them
  as the JAX custom VJP ``fused_block_apply`` does;
- K9 ``fused_block_merged``, a whole block (K1's math, then K2's) from one
  C call, bit-equal to ``fused_block_apply``, source ``csrc/block_merged.cu``;
  forward only, and, as in the JAX package, exported but routed nowhere.

K1, K2 and K9 normalise in a row pass first (``ln_rows_plain`` is its plain
version: K8's device code, writing the rounded LN output into a scratch) and
then multiply on one GEMM: in bf16 the warp-specialised wgmma + TMA kernel
of ``csrc/gemm_sm90.cuh``, which takes the shapes ``gemm_takes`` accepts
(the wrappers check before loading a library), in fp32 the CUDA-core GEMM of
``csrc/common.cuh``. In bf16, K5's ten products run on the same kernel in
the backward's transposed layouts (``attn_bwd_gemms``, ``mlp_bwd_gemms``),
in fp32 on the CUDA-core ``gemm_t`` of ``csrc/grad_common.cuh``.
``gemm_bf16`` runs the bf16 GEMM alone in each of those layouts,
``attn_forward`` the attention core of K1, K3a and K9 alone and
``attn_backward`` K5a's attention backward alone.

K1, K3a, K5a and K9 take head dim 64 or 80 (ViT-H-14's vision tower) and any
T; other head dims raise on a CUDA tensor. Their bf16 attention forward runs
on the warp-specialised TMA + wgmma kernel of ``csrc/attn_sm90.cuh``, which
K6 (``ops.attention``) shares; ``attn_takes``, ``attn_boxes``,
``attn_smem_bytes`` and ``attn_k_slots`` mirror its shape rule and
shared-memory plan. fp32 keeps the CUDA-core kernels of ``csrc/flash.cuh``.

Each wrapper takes x's dtype (bfloat16 or float32) as the compute dtype and
casts the LayerNorm parameters (and, for K1/K2/K5, the kernels and biases) to
it, as the reference wrapper does; K3 keeps its int8 kernels and reads its
scales and biases in fp32. A CUDA tensor launches the kernel (or raises); a
CPU tensor takes the plain PyTorch version beside it, which has the same
rounding points and is also the comparison the chip smoke run holds each
kernel to. Every kernel launch adds one to the wrapper's ``launches`` count.
The forward wrappers return tensors outside autograd, so under grad mode
they refuse inputs that require grad: differentiable blocks go through
``FusedBlockFunction`` (``fused_block_apply``).
"""

from __future__ import annotations

import math

import torch

from . import build
from .int8 import dequant_dot

LN_EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"quick_gelu": 0, "gelu": 1}


# -- plain versions --------------------------------------------------------


def _ln_fwd_stats(x32: torch.Tensor, scale, bias):
    """LN in fp32 over the last dim, as the kernels compute it: (xhat, inv,
    y32) with inv = rsqrt(var + eps)."""
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    inv = torch.rsqrt(xc.square().mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * inv
    return xhat, inv, xhat * scale.float() + bias.float()


def _ln32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return _ln_fwd_stats(x32, scale, bias)[2]


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7), the formula the
    kernels use for exact GELU."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if activation == "gelu":
        return 0.5 * h * (1.0 + erf_as(h * 0.7071067811865476))
    raise ValueError(f"unknown activation {activation!r}")


def attend_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Multi-head attention over q, k, v [B, H, T, d] at the fused kernels'
    rounding points: q scaled in its dtype (the scale rounded to it first),
    fp32 scores and softmax (causal fill −1e30), P rounded for P·V, the fp32
    sum divided after P·V and the output rounded. Returns [B, H, T, d] in
    q's dtype."""
    dt = q.dtype
    T, d = q.shape[-2:]
    q = q * torch.tensor(1.0 / math.sqrt(d), dtype=dt, device=q.device)
    s = q.float() @ k.float().transpose(-1, -2)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    return ((p.to(dt).float() @ v.float()) / denom).to(dt)


def attn_forward_plain(qkv: torch.Tensor, n_heads: int, causal: bool = False) -> torch.Tensor:
    """The attention core of K1, K3a and K9 in plain PyTorch: ``attend_heads``
    over the rounded qkv [B, T, 3W] of the fused kernels (head h's q, k, v at
    columns h·d, W + h·d, 2W + h·d). Returns o [B, T, W] in qkv's dtype."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    d = W // n_heads
    q, k, v = (
        t.reshape(B, T, n_heads, d).transpose(1, 2) for t in qkv.split(W, dim=-1)
    )
    return attend_heads(q, k, v, causal).transpose(1, 2).reshape(B, T, W)


def ln_rows_plain(x: torch.Tensor, ln_scale, ln_bias) -> torch.Tensor:
    """The LayerNorm row pass of K1, K2 and K9 in plain PyTorch: y =
    round_T(LN(x)·s + b) in x's dtype T, the statistics and the affine step
    in fp32 on the parameters' values (already in T), one rounding. It is the
    y the plain halves multiply with, and K8's function
    (``layernorm.fused_layer_norm_plain``) on the fp32 values of s and b."""
    return _ln32(x.float(), ln_scale, ln_bias).to(x.dtype)


def gemm_bf16_plain(
    a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *, a_t: bool = False,
    w_t: bool = False, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``gemm_bf16``'s function in plain PyTorch: op(a)·op(w) in fp32, with
    op(a) = aᵀ when ``a_t`` (a stored [K, M]) and op(w) = wᵀ when ``w_t`` (w
    stored [N, K]), plus the bias if one is given, then cast once to
    ``out_dtype`` (bfloat16: rounded once; float32: the sum as it is)."""
    out = (a.T if a_t else a).float() @ (w.T if w_t else w).float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def gemm_slices_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A weight gradient aᵀ·w (a [K, M], w [K, N], summing over K rows) as
    the wgmma GEMM forms it when ``gemm_k_slice`` splits it: the fp32 sum of
    each slice of rows, then the partials added in slice order (its second
    pass). Unsplit, one fp32 product."""
    (K, M), N = a.shape, w.shape[1]
    step = gemm_k_slice(M, N, K, a_t=True)
    parts = [a[k:k + step].T.float() @ w[k:k + step].float() for k in range(0, K, step)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def fused_attn_block_plain(
    x, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, n_heads: int,
    causal: bool = False,
) -> torch.Tensor:
    """K1's function in plain PyTorch, parameters already in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    y = ln_rows_plain(x, ln_scale, ln_bias)
    qkv = (y.float() @ qkv_kernel.float() + qkv_bias.float()).to(dt)
    o = attn_forward_plain(qkv, n_heads, causal)
    proj = o.float() @ out_kernel.float() + out_bias.float()
    return (x32 + proj).to(dt)


def fused_mlp_block_plain(
    x, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias,
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """K2's function in plain PyTorch, parameters already in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    y = ln_rows_plain(x, ln_scale, ln_bias)
    h = _activate(y.float() @ fc_kernel.float() + fc_bias.float(), activation).to(dt)
    o = h.float() @ proj_kernel.float() + proj_bias.float()
    return x32.to(dt) + o.to(dt)


def fused_attn_block_q_plain(
    x, ln_scale, ln_bias, qkv_kq, qkv_ks, qkv_bias, out_kq, out_ks, out_bias,
    n_heads: int, causal: bool = False,
) -> torch.Tensor:
    """K3a's function in plain PyTorch, LN parameters already in x's dtype.

    The TPU kernel's rounding points (``_attn_block_kernel_q``): the fp32 LN
    output is quantised as it is, not rounded first; qkv is dequantised in
    fp32 and rounded to x's dtype; the head outputs, rounded, are quantised
    per token across all heads for the out-projection; one fp32 residual
    rounding."""
    dt = x.dtype
    x32 = x.float()
    y = _ln32(x32, ln_scale, ln_bias)
    qkv = dequant_dot(y, qkv_kq, qkv_ks, qkv_bias).to(dt)
    o = attn_forward_plain(qkv, n_heads, causal)
    proj = dequant_dot(o.float(), out_kq, out_ks, out_bias)
    return (x32 + proj).to(dt)


def fused_mlp_block_q_plain(
    x, ln_scale, ln_bias, fc_kq, fc_ks, fc_bias, proj_kq, proj_ks, proj_bias,
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """K3b's function in plain PyTorch (``_mlp_block_kernel_q``): the hidden
    activation stays fp32 and is quantised per token over all 4W columns;
    one fp32 residual rounding."""
    x32 = x.float()
    y = _ln32(x32, ln_scale, ln_bias)
    h = _activate(dequant_dot(y, fc_kq, fc_ks, fc_bias), activation)
    o = dequant_dot(h, proj_kq, proj_ks, proj_bias)
    return (x32 + o).to(x.dtype)


def _ln_bwd(dy, xhat, inv, scale, g32):
    """LN's backward in fp32 over rows [R, W]: (dx_total fp32, dscale,
    dbias), dx_total = g + dx_ln."""
    dxhat = dy * scale.float()
    dx_ln = inv * (
        dxhat
        - dxhat.mean(-1, keepdim=True)
        - xhat * (dxhat * xhat).mean(-1, keepdim=True)
    )
    return g32 + dx_ln, (dy * xhat).sum(0), dy.sum(0)


def attn_backward_plain(qkv: torch.Tensor, dout: torch.Tensor, n_heads: int, causal: bool = False):
    """K5a's attention backward in plain PyTorch, from the rounded qkv
    [B, T, 3W] and do [B, T, W] in the element type: (o [B*T, W] in that
    type, dqkv [B*T, 3W] in fp32), at the rounding points listed in
    ``fused_attn_block_bwd_plain``, whose middle part it is."""
    dt = qkv.dtype
    B, T, W3 = qkv.shape
    W = W3 // 3
    d = W // n_heads
    scale = 1.0 / math.sqrt(d)

    def heads(t):  # [B, T, W] -> [B, H, T, d]
        return t.reshape(B, T, n_heads, d).transpose(1, 2)

    def rows(t):  # [B, H, T, d] -> [B*T, W]
        return t.transpose(1, 2).reshape(B * T, W)

    q, k, v = (heads(t) for t in qkv.split(W, dim=-1))
    q = (q * torch.tensor(scale, dtype=dt, device=qkv.device)).float()
    k, v = k.float(), v.float()
    s = q @ k.transpose(-1, -2)
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=qkv.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=qkv.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pn = e / e.sum(-1, keepdim=True)
    pn_dt = pn.to(dt).float()
    o = (pn_dt @ v).to(dt)
    do_h = heads(dout).float()
    dv = pn_dt.transpose(-1, -2) @ do_h
    dpn = do_h @ v.transpose(-1, -2)
    ds = pn * (dpn - (dpn * pn).sum(-1, keepdim=True))
    ds_dt = ds.to(dt).float()
    dq = (ds_dt @ k) * scale
    dk = ds_dt.transpose(-1, -2) @ q
    return rows(o), torch.cat([rows(dq), rows(dk), rows(dv)], dim=-1)


def fused_attn_block_bwd_plain(
    x, g, ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias, n_heads: int,
    causal: bool = False,
):
    """K5a's function in plain PyTorch, parameters already in x's dtype.

    The rounding points of ``_attn_block_bwd_kernel``: LN1, qkv and the
    per-head softmax are recomputed from x (pn normalised in fp32, rounded
    for o and dv); do = g·W_outᵀ in fp32, rounded per head; o = round(
    round(pn)·v) feeds dW_out; ds = pn ∘ (dpn − rowsum(dpn ∘ pn)); dq =
    round(ds)·k·scale and dk = round(ds)ᵀ·(scaled q) in fp32; the qkv bias
    gradient sums the fp32 dqkv, dW_qkv and dy use it rounded; dx = g +
    dx_ln rounded once. Returns (dx, dln_scale, dln_bias, dqkv_kernel,
    dqkv_bias, dout_kernel, dout_bias), the gradients in fp32."""
    dt = x.dtype
    B, T, W = x.shape
    x32 = x.reshape(-1, W).float()
    g32 = g.reshape(-1, W).float()
    gd = g32.to(dt).float()
    xhat, inv, y32 = _ln_fwd_stats(x32, ln_scale, ln_bias)
    y = y32.to(dt).float()
    qkv = (y @ qkv_kernel.float() + qkv_bias.float()).to(dt)
    dout = (gd @ out_kernel.float().T).to(dt)
    o, dqkv = attn_backward_plain(
        qkv.reshape(B, T, 3 * W), dout.reshape(B, T, W), n_heads, causal
    )
    o = o.float()
    dqkv_dt = dqkv.to(dt).float()
    dy = dqkv_dt @ qkv_kernel.float().T
    dx, dls, dlb = _ln_bwd(dy, xhat, inv, ln_scale, g32)
    return (
        dx.to(dt).reshape(x.shape), dls, dlb, y.T @ dqkv_dt, dqkv.sum(0),
        o.T @ gd, g32.sum(0),
    )


def _activate_grad(h_pre: torch.Tensor, activation: str):
    """(act(h_pre), act'(h_pre)) in fp32, as ``_mlp_block_bwd_kernel``."""
    if activation == "quick_gelu":
        sig = torch.sigmoid(1.702 * h_pre)
        return h_pre * sig, sig * (1.0 + 1.702 * h_pre * (1.0 - sig))
    if activation == "gelu":
        erf_v = erf_as(h_pre * 0.7071067811865476)
        pdf = 0.3989422804014327 * torch.exp(-0.5 * h_pre * h_pre)
        return 0.5 * h_pre * (1.0 + erf_v), 0.5 * (1.0 + erf_v) + h_pre * pdf
    raise ValueError(f"unknown activation {activation!r}")


def fused_mlp_block_bwd_plain(
    x, g, ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias,
    activation: str = "quick_gelu",
):
    """K5b's function in plain PyTorch, parameters already in x's dtype.

    The rounding points of ``_mlp_block_bwd_kernel``: LN2 and fc recomputed
    from x, h_pre and the activation and its derivative in fp32; h rounded
    for dW_proj; dh_pre = (g·W_projᵀ) ∘ act' in fp32, rounded for dW_fc and
    dy, summed in fp32 for b_fc; dx = g + dx_ln rounded once. Returns (dx,
    dln_scale, dln_bias, dfc_kernel, dfc_bias, dproj_kernel, dproj_bias)."""
    dt = x.dtype
    W = x.shape[-1]
    x32 = x.reshape(-1, W).float()
    g32 = g.reshape(-1, W).float()
    gd = g32.to(dt).float()
    xhat, inv, y32 = _ln_fwd_stats(x32, ln_scale, ln_bias)
    y = y32.to(dt).float()
    h_act, dact = _activate_grad(y @ fc_kernel.float() + fc_bias.float(), activation)
    h = h_act.to(dt).float()
    dh_pre = (gd @ proj_kernel.float().T) * dact
    dhp = dh_pre.to(dt).float()
    dy = dhp @ fc_kernel.float().T
    dx, dls, dlb = _ln_bwd(dy, xhat, inv, ln_scale, g32)
    return (
        dx.to(dt).reshape(x.shape), dls, dlb, y.T @ dhp, dh_pre.sum(0), h.T @ gd, g32.sum(0),
    )


# -- wrappers --------------------------------------------------------------


def _check_cuda(x: torch.Tensor, params, shapes, what: str, dtypes=None) -> None:
    """Everything the kernel reads through a raw pointer: x's dtype and
    layout, and each parameter's device, exact shape and (where ``dtypes``
    is given) dtype."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if p.device != x.device:
            raise ValueError(f"{what}: parameter on {p.device}, x on {x.device}")
        if tuple(p.shape) != shape:
            raise ValueError(f"{what}: parameter of shape {tuple(p.shape)}, expected {shape}")
        if dtypes is not None and p.dtype != dtypes[i]:
            raise ValueError(f"{what}: parameter of dtype {p.dtype}, expected {dtypes[i]}")


def _raise_rc(rc: int, what: str, shape) -> None:
    if rc == -1:
        raise ValueError(f"{what}: the CUDA kernel does not take shape {tuple(shape)}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")


def _ptr(t: torch.Tensor | None):
    """A tensor's address for ctypes, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 128, 256, 64
# up to 4 K slices of at least 16 steps each, below half an H100's 132 SMs
GEMM_SPLIT_MAX, GEMM_SPLIT_BELOW_TILES, GEMM_SPLIT_MIN_STEPS = 4, 66, 16


def gemm_takes(M: int, N: int, K: int, a_t: bool = False, w_t: bool = False) -> bool:
    """Whether the bf16 GEMM of K1, K2, K9 and K5 (``csrc/gemm_sm90.cuh``,
    whose ``gemm_takes`` this mirrors) computes out[M, N] = op(A)·op(W) in a
    layout: A stored [M, K], or [K, M] read transposed (``a_t``, a weight
    gradient's sum over rows); W stored [K, N], or [N, K] read transposed
    (``w_t``, an input gradient). N a multiple of its 256-wide output tile; K
    of its 64-wide step where K is an operand's contiguous dimension (A not
    transposed, or ``w_t``), else any K (TMA zero-fills the ragged rows); M
    any row count from 1 up to 65,535 row tiles of 128, and with ``a_t`` a
    multiple of 8 (16-byte rows of the [K, M] array)."""
    k_contiguous = not a_t or w_t
    return (
        M >= 1 and N >= GEMM_TILE_N and N % GEMM_TILE_N == 0 and K >= 1
        and (not k_contiguous or K % GEMM_TILE_K == 0) and (not a_t or M % 8 == 0)
        and -(-M // GEMM_TILE_M) <= 65535
    )


def gemm_k_slice(M: int, N: int, K: int, a_t: bool = False, w_t: bool = False) -> int:
    """Rows of K each slice of the bf16 GEMM walks (``csrc/gemm_sm90.cuh``'s
    ``gemm_k_slice``): all K, or, for a weight gradient (``a_t`` and not
    ``w_t``, fp32 out) with fewer output tiles than half the SMs, whole
    64-row steps cut into at most four slices of at least 16 steps each,
    summed in slice order by a second pass."""
    tiles = -(-M // GEMM_TILE_M) * (N // GEMM_TILE_N)
    steps = -(-K // GEMM_TILE_K)
    slices = min(GEMM_SPLIT_MAX, steps // GEMM_SPLIT_MIN_STEPS)
    if not a_t or w_t or tiles >= GEMM_SPLIT_BELOW_TILES or slices < 2:
        return K
    return -(-steps // slices) * GEMM_TILE_K


def gemm_split_floats(gemms) -> int:
    """fp32 scratch for the split partials of the weight gradients among
    ``gemms`` ((M, N, K, a_t, w_t) tuples): the most of slices x M x N over
    those that split, 0 where none does."""
    most = 0
    for M, N, K, a_t, w_t in gemms:
        splits = -(-K // gemm_k_slice(M, N, K, a_t, w_t))
        if splits > 1:
            most = max(most, splits * M * N)
    return most


def attn_bwd_gemms(M: int, W: int) -> list[tuple[int, int, int, bool, bool]]:
    """K5a's five products (M, N, K, a_t, w_t) over M rows of width W, in
    their order (``csrc/block_attn_bwd.cu``'s ``attn_bwd_gemms_take``): qkv
    = y·W_qkv + b, do = g·W_outᵀ, dW_qkv = yᵀ·round(dqkv), dy =
    round(dqkv)·W_qkvᵀ, dW_out = oᵀ·g."""
    return [(M, 3 * W, W, False, False), (M, W, W, False, True), (W, 3 * W, M, True, False),
            (M, W, 3 * W, False, True), (W, W, M, True, False)]


def mlp_bwd_gemms(M: int, W: int, hid: int) -> list[tuple[int, int, int, bool, bool]]:
    """K5b's five products (M, N, K, a_t, w_t), in their order
    (``csrc/block_mlp_bwd.cu``'s ``mlp_bwd_gemms_take``): h_pre = y·W_fc +
    b, dW_proj = hᵀ·g, dh = g·W_projᵀ, dW_fc = yᵀ·round(dh_pre), dy =
    round(dh_pre)·W_fcᵀ."""
    return [(M, hid, W, False, False), (hid, W, M, True, False), (M, hid, W, False, True),
            (W, hid, M, True, False), (M, W, hid, False, True)]


def _check_gemms(what: str, x: torch.Tensor, gemms, tensors, biases) -> None:
    """A bf16 call, before any library is loaded: every GEMM, (M, N, K) in
    the forward layout or (M, N, K, a_t, w_t), must be one the wgmma GEMM
    takes, and what TMA and its 16-byte epilogue read (x, and ``tensors``:
    the kernels, the cotangent) must start on a 16-byte boundary, the biases
    (read in pairs) on a 4-byte one. fp32 calls run on the CUDA-core GEMMs,
    whose C side returns -1 for a shape it does not take."""
    if x.dtype != torch.bfloat16:
        return
    for gemm in gemms:
        M, N, K, a_t, w_t = (*gemm, False, False)[:5]
        if not gemm_takes(M, N, K, a_t, w_t):
            k_rule = (f"K a multiple of {GEMM_TILE_K}" if not a_t or w_t
                      else "any K, M a multiple of 8")
            layout = f"{'Aᵀ' if a_t else 'A'}·{'Wᵀ' if w_t else 'W'}"
            raise ValueError(
                f"{what}: the CUDA kernel does not take shape {tuple(x.shape)} "
                f"(its GEMM takes N a multiple of {GEMM_TILE_N} and, for {layout}, {k_rule}; "
                f"got {M} x {N} x {K})"
            )
    if any(t.data_ptr() % 16 for t in (x, *tensors)) or any(b.data_ptr() % 4 for b in biases):
        raise ValueError(
            f"{what}: x, the cotangent and the kernels must start on 16-byte boundaries, "
            "the biases on 4-byte ones"
        )


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's result is written through raw pointers and has no
    autograd history: under grad mode, an input that requires grad would
    silently get none. Raise instead."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{what}: an input requires grad, but the kernel's result carries no "
            "autograd history; run the block through FusedBlockFunction "
            "(ops.block_fused.fused_block_apply, or models.layers.block_apply) or "
            "under torch.no_grad()"
        )


def fused_attn_block(
    x: torch.Tensor,  # [B, T, W]
    ln_scale, ln_bias,
    qkv_kernel,  # [W, 3W]
    qkv_bias,
    out_kernel,  # [W, W]
    out_bias,
    n_heads: int,
    causal: bool = False,
) -> torch.Tensor:
    """x + out(attention(LN(x))), kernel K1 on a CUDA tensor (head dim 64 or
    80, any T)."""
    raw = (ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias)
    refuse_grad("fused_attn_block", x, *raw)
    dt = x.dtype
    params = [p.to(dt).contiguous() for p in raw]
    if not x.is_cuda:
        return fused_attn_block_plain(x, *params, n_heads=n_heads, causal=causal)
    if x.dim() != 3 or x.shape[2] % n_heads:
        raise ValueError(f"fused_attn_block: x of shape {tuple(x.shape)} with {n_heads} heads")
    B, T, W = x.shape
    _check_cuda(x, params, [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,)], "fused_attn_block")
    M = B * T
    _check_gemms("fused_attn_block", x, [(M, 3 * W, W), (M, W, W)], params[2::2], params[3::2])
    lib = build.load("block_attn")
    ln32 = [p.float() for p in params[:2]]  # the element-type values, as the row pass reads them
    y, o, out = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    qkv = torch.empty((M, 3 * W), dtype=dt, device=x.device)
    d = W // n_heads
    rc = lib.evr_fused_attn_block(
        _DTYPE_CODES[dt], x.data_ptr(), *(p.data_ptr() for p in (*ln32, *params[2:])),
        y.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(), B, T, W, n_heads, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_rc(rc, "fused_attn_block", x.shape)
    fused_attn_block.launches += 1
    return out


def fused_mlp_block(
    x: torch.Tensor,  # [..., W]
    ln_scale, ln_bias,
    fc_kernel,  # [W, 4W]
    fc_bias,
    proj_kernel,  # [4W, W]
    proj_bias,
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """x + proj(act(fc(LN(x)))), kernel K2 on a CUDA tensor."""
    raw = (ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias)
    refuse_grad("fused_mlp_block", x, *raw)
    dt = x.dtype
    params = [p.to(dt).contiguous() for p in raw]
    if not x.is_cuda:
        return fused_mlp_block_plain(x, *params, activation=activation)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    W, hid = x.shape[-1], params[2].shape[-1]
    _check_cuda(x, params, [(W,), (W,), (W, hid), (hid,), (hid, W), (W,)], "fused_mlp_block")
    rows = x.numel() // W
    _check_gemms("fused_mlp_block", x, [(rows, hid, W), (rows, W, hid)], params[2::2], params[3::2])
    lib = build.load("block_mlp")
    ln32 = [p.float() for p in params[:2]]  # the element-type values, as the row pass reads them
    y = torch.empty((rows, W), dtype=dt, device=x.device)
    h = torch.empty((rows, hid), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    rc = lib.evr_fused_mlp_block(
        _DTYPE_CODES[dt], x.data_ptr(), *(p.data_ptr() for p in (*ln32, *params[2:])),
        y.data_ptr(), h.data_ptr(), out.data_ptr(), rows, W, hid, _ACT_CODES[activation],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_rc(rc, "fused_mlp_block", x.shape)
    fused_mlp_block.launches += 1
    return out


def cast_quant_args(dt, args) -> list:
    """A K3 half's arguments (LN scale, LN bias, then kernel_q, kernel_scale
    and bias of two linears) as its kernel and plain version read them: LN
    parameters cast to x's dtype, int8 kernels as they are, scales and
    biases in fp32 (``evr_tpu/ops/block_fused.py:882-884``)."""
    ln_scale, ln_bias, *lins = args
    out = [ln_scale.to(dt).contiguous(), ln_bias.to(dt).contiguous()]
    for kq, ks, b in (lins[:3], lins[3:]):
        out += [kq.contiguous(), ks.float().contiguous(), b.float().contiguous()]
    return out


_I8, _F32 = torch.int8, torch.float32


def fused_attn_block_q(
    x: torch.Tensor,  # [B, T, W]
    ln_scale, ln_bias,
    qkv_kq, qkv_ks, qkv_bias,  # int8 [W, 3W], fp32 [3W], [3W]
    out_kq, out_ks, out_bias,  # int8 [W, W], fp32 [W], [W]
    n_heads: int,
    causal: bool = False,
) -> torch.Tensor:
    """x + out(attention(LN(x))) over int8 weights, kernel K3a on a CUDA
    tensor (head dim 64 or 80, any T)."""
    refuse_grad("fused_attn_block_q", x, ln_scale, ln_bias, qkv_kq, qkv_ks, qkv_bias,
                out_kq, out_ks, out_bias)
    dt = x.dtype
    params = cast_quant_args(
        dt, (ln_scale, ln_bias, qkv_kq, qkv_ks, qkv_bias, out_kq, out_ks, out_bias)
    )
    if not x.is_cuda:
        return fused_attn_block_q_plain(x, *params, n_heads=n_heads, causal=causal)
    if x.dim() != 3 or x.shape[2] % n_heads:
        raise ValueError(f"fused_attn_block_q: x of shape {tuple(x.shape)} with {n_heads} heads")
    B, T, W = x.shape
    _check_cuda(
        x, params, [(W,), (W,), (W, 3 * W), (3 * W,), (3 * W,), (W, W), (W,), (W,)],
        "fused_attn_block_q", [dt, dt, _I8, _F32, _F32, _I8, _F32, _F32],
    )
    rows = B * T
    lib = build.load("block_quant")
    a_q = torch.empty((rows, W), dtype=torch.int8, device=x.device)
    a_scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    qkv = torch.empty((rows, 3 * W), dtype=dt, device=x.device)
    o = torch.empty_like(x)
    out = torch.empty_like(x)
    rc = lib.evr_fused_attn_block_q(
        _DTYPE_CODES[dt], x.data_ptr(), *(p.data_ptr() for p in params),
        a_q.data_ptr(), a_scale.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
        B, T, W, n_heads, int(causal), 1.0 / math.sqrt(W // n_heads),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_rc(rc, "fused_attn_block_q", x.shape)
    fused_attn_block_q.launches += 1
    return out


def fused_mlp_block_q(
    x: torch.Tensor,  # [..., W]
    ln_scale, ln_bias,
    fc_kq, fc_ks, fc_bias,  # int8 [W, 4W], fp32 [4W], [4W]
    proj_kq, proj_ks, proj_bias,  # int8 [4W, W], fp32 [W], [W]
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """x + proj(act(fc(LN(x)))) over int8 weights, kernel K3b on a CUDA
    tensor."""
    refuse_grad("fused_mlp_block_q", x, ln_scale, ln_bias, fc_kq, fc_ks, fc_bias,
                proj_kq, proj_ks, proj_bias)
    dt = x.dtype
    params = cast_quant_args(
        dt, (ln_scale, ln_bias, fc_kq, fc_ks, fc_bias, proj_kq, proj_ks, proj_bias)
    )
    if not x.is_cuda:
        return fused_mlp_block_q_plain(x, *params, activation=activation)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    W, hid = x.shape[-1], params[2].shape[-1]
    _check_cuda(
        x, params, [(W,), (W,), (W, hid), (hid,), (hid,), (hid, W), (W,), (W,)],
        "fused_mlp_block_q", [dt, dt, _I8, _F32, _F32, _I8, _F32, _F32],
    )
    rows = x.numel() // W
    lib = build.load("block_quant")
    dev = x.device
    y_q = torch.empty((rows, W), dtype=torch.int8, device=dev)
    h = torch.empty((rows, hid), dtype=torch.float32, device=dev)
    h_q = torch.empty((rows, hid), dtype=torch.int8, device=dev)
    scales = torch.empty((2, rows), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    rc = lib.evr_fused_mlp_block_q(
        _DTYPE_CODES[dt], x.data_ptr(), *(p.data_ptr() for p in params),
        y_q.data_ptr(), scales[0].data_ptr(), h.data_ptr(), h_q.data_ptr(),
        scales[1].data_ptr(), out.data_ptr(), rows, W, hid, _ACT_CODES[activation],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_rc(rc, "fused_mlp_block_q", x.shape)
    fused_mlp_block_q.launches += 1
    return out


def _check_bwd(x, g, what: str) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError(
            f"{what}: the cotangent must be a contiguous {x.dtype} tensor of x's shape "
            f"{tuple(x.shape)} on {x.device}; got {g.dtype} {tuple(g.shape)} on {g.device}"
        )


def fused_attn_block_bwd(
    x: torch.Tensor,  # [B, T, W] the forward input
    g: torch.Tensor,  # [B, T, W] the output's cotangent
    ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias,
    n_heads: int,
    causal: bool = False,
):
    """Backward of x + out(attention(LN(x))), kernel K5a on a CUDA tensor.
    Returns (dx, dln_scale, dln_bias, dqkv_kernel, dqkv_bias, dout_kernel,
    dout_bias): dx in x's dtype, the gradients in fp32."""
    dt = x.dtype
    params = [
        p.to(dt).contiguous()
        for p in (ln_scale, ln_bias, qkv_kernel, qkv_bias, out_kernel, out_bias)
    ]
    if not x.is_cuda:
        return fused_attn_block_bwd_plain(x, g, *params, n_heads=n_heads, causal=causal)
    if x.dim() != 3 or x.shape[2] % n_heads:
        raise ValueError(f"fused_attn_block_bwd: x of shape {tuple(x.shape)} with {n_heads} heads")
    B, T, W = x.shape
    _check_cuda(x, params, [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,)], "fused_attn_block_bwd")
    _check_bwd(x, g, "fused_attn_block_bwd")
    dev, M = x.device, B * T
    gemms = attn_bwd_gemms(M, W)
    _check_gemms("fused_attn_block_bwd", x, gemms, [g, params[2], params[4]], [params[3]])
    lib = build.load("block_attn_bwd")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def elt(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    dx = torch.empty_like(x)
    grads = [f32(W), f32(W), f32(W, 3 * W), f32(3 * W), f32(W, W), f32(W)]
    # bf16: round(dqkv), the operand of dW_qkv and dy, and the split partials
    bf16 = dt == torch.bfloat16
    split = gemm_split_floats(gemms) if bf16 else 0
    scratch = [elt(M, W), f32(M), f32(M), elt(M, 3 * W), elt(M, W), elt(M, W),
               f32(3, B, n_heads, T), f32(M, 3 * W), elt(M, 3 * W) if bf16 else None, f32(M, W),
               f32(-(-M // 128) * 3 * W), f32(split) if split else None]
    rc = lib.evr_fused_attn_block_bwd(
        _DTYPE_CODES[dt], x.data_ptr(), g.data_ptr(), *(p.data_ptr() for p in params[:5]),
        dx.data_ptr(), *(t.data_ptr() for t in grads), *(_ptr(t) for t in scratch),
        B, T, W, n_heads, int(causal), 1.0 / math.sqrt(W // n_heads),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_rc(rc, "fused_attn_block_bwd", x.shape)
    fused_attn_block_bwd.launches += 1
    return (dx, *grads)


def fused_mlp_block_bwd(
    x: torch.Tensor,  # [..., W] the forward input
    g: torch.Tensor,  # [..., W] the output's cotangent
    ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias,
    activation: str = "quick_gelu",
):
    """Backward of x + proj(act(fc(LN(x)))), kernel K5b on a CUDA tensor.
    Returns (dx, dln_scale, dln_bias, dfc_kernel, dfc_bias, dproj_kernel,
    dproj_bias): dx in x's dtype, the gradients in fp32."""
    dt = x.dtype
    params = [
        p.to(dt).contiguous()
        for p in (ln_scale, ln_bias, fc_kernel, fc_bias, proj_kernel, proj_bias)
    ]
    if not x.is_cuda:
        return fused_mlp_block_bwd_plain(x, g, *params, activation=activation)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    W, hid = x.shape[-1], params[2].shape[-1]
    _check_cuda(x, params, [(W,), (W,), (W, hid), (hid,), (hid, W), (W,)], "fused_mlp_block_bwd")
    _check_bwd(x, g, "fused_mlp_block_bwd")
    dev, M = x.device, x.numel() // W
    gemms = mlp_bwd_gemms(M, W, hid)
    _check_gemms("fused_mlp_block_bwd", x, gemms, [g, params[2], params[4]], [params[3]])
    lib = build.load("block_mlp_bwd")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x)
    grads = [f32(W), f32(W), f32(W, hid), f32(hid), f32(hid, W), f32(W)]
    # bf16: round(dh_pre), the operand of dW_fc and dy, and the split partials
    bf16 = dt == torch.bfloat16
    split = gemm_split_floats(gemms) if bf16 else 0
    scratch = [torch.empty((M, W), dtype=dt, device=dev), f32(M), f32(M), f32(M, hid),
               torch.empty((M, hid), dtype=dt, device=dev),
               torch.empty((M, hid), dtype=dt, device=dev) if bf16 else None, f32(M, W),
               f32(-(-M // 128) * hid), f32(split) if split else None]
    rc = lib.evr_fused_mlp_block_bwd(
        _DTYPE_CODES[dt], x.data_ptr(), g.data_ptr(), *(p.data_ptr() for p in params[:5]),
        dx.data_ptr(), *(t.data_ptr() for t in grads), *(_ptr(t) for t in scratch),
        M, W, hid, _ACT_CODES[activation], torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_rc(rc, "fused_mlp_block_bwd", x.shape)
    fused_mlp_block_bwd.launches += 1
    return (dx, *grads)


# (a_t, w_t, out_dtype) of the products gemm_bf16 runs: K1, K2, K9 and K5's
# recomputed forwards; K5a's do; the weight gradients; the input gradients dy
GEMM_BF16_LAYOUTS = (
    (False, False, torch.bfloat16), (False, True, torch.bfloat16),
    (True, False, torch.float32), (False, True, torch.float32),
)


def gemm_bf16(
    a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *, a_t: bool = False,
    w_t: bool = False, out_dtype: torch.dtype = torch.bfloat16, k_slice: int | None = None,
) -> torch.Tensor:
    """out = op(a)·op(w) (+ bias) on bfloat16 operands: the wgmma GEMM under
    K1, K2, K9 and K5 on its own, for checking and timing it alone. op(a) =
    a [M, K], or aᵀ for a stored [K, M] (``a_t``); op(w) = w [K, N], or wᵀ
    for w stored [N, K] (``w_t``); out in ``out_dtype``: bfloat16, the fp32
    sum plus the bias rounded once, or float32 as it is (no bias; a weight
    gradient split into slices as K5 splits it, or, given ``k_slice``, into
    slices of that many rows: K for one pass, to time the split against).
    The layouts taken are ``GEMM_BF16_LAYOUTS``: the first through the entry
    ``evr_gemm_bf16`` of ``csrc/block_mlp.cu``, the others through
    ``evr_gemm_bf16_t`` of ``csrc/block_attn_bwd.cu``. Nothing on the
    serving or training path calls it. A CPU tensor takes
    ``gemm_bf16_plain``."""
    refuse_grad("gemm_bf16", a, w, *(() if bias is None else (bias,)))
    if (a_t, w_t, out_dtype) not in GEMM_BF16_LAYOUTS:
        raise ValueError(f"gemm_bf16: layout a_t={a_t}, w_t={w_t}, out_dtype={out_dtype} not taken")
    if out_dtype == torch.float32 and bias is not None:
        raise ValueError("gemm_bf16: a float32 output takes no bias")
    if k_slice is not None and (out_dtype != torch.float32 or k_slice < 1):
        raise ValueError(f"gemm_bf16: k_slice={k_slice} (a positive row count, float32 outputs only)")
    if not a.is_cuda:
        return gemm_bf16_plain(a, w, bias, a_t=a_t, w_t=w_t, out_dtype=out_dtype)
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"gemm_bf16: a {tuple(a.shape)}, w {tuple(w.shape)}")
    M, K = (a.shape[1], a.shape[0]) if a_t else a.shape
    Kw, N = (w.shape[1], w.shape[0]) if w_t else w.shape
    if K != Kw or (bias is not None and tuple(bias.shape) != (N,)):
        raise ValueError(f"gemm_bf16: a {tuple(a.shape)} (a_t={a_t}), w {tuple(w.shape)} (w_t={w_t}), "
                         f"bias {None if bias is None else tuple(bias.shape)}")
    for t in (a, w) + (() if bias is None else (bias,)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != a.device:
            raise ValueError("gemm_bf16: a, w and bias must be contiguous bfloat16 tensors on one device")
    gemm = (M, N, K, a_t, w_t)
    _check_gemms("gemm_bf16", a, [gemm], [w], [] if bias is None else [bias])
    if k_slice is not None and k_slice < K and k_slice % GEMM_TILE_K:
        raise ValueError(f"gemm_bf16: k_slice={k_slice} is neither K nor a multiple of {GEMM_TILE_K}")
    dev = a.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not a_t and not w_t:
        rc = build.load("block_mlp").evr_gemm_bf16(a.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(),
                                                   M, N, K, stream)
    else:
        slices = -(-K // (k_slice or gemm_k_slice(*gemm)))
        part = torch.empty(slices * M * N, dtype=torch.float32, device=dev) if slices > 1 else None
        rc = build.load("block_attn_bwd").evr_gemm_bf16_t(
            a.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(), _ptr(part), M, N, K, int(a_t),
            int(w_t), int(out_dtype == torch.float32), k_slice or 0, stream)
    _raise_rc(rc, "gemm_bf16", (M, N, K))
    gemm_bf16.launches += 1
    return out


ATTN_HEAD_DIMS = (64, 80)
ATTN_TILE = 64  # query rows per consumer warpgroup, keys per block
ATTN_CONSUMERS = 2  # consumer warpgroups (query tiles) per block
ATTN_V_SLOTS = 4  # the v ring
SMEM_PER_SM = 233472  # an H100 SM's 228 KB
ATTN_SMEM_PER_BLOCK = SMEM_PER_SM // 2 - 1024  # two blocks an SM, 1 KB each kept by the runtime
_SWIZZLE_LINE = 128  # bytes: the widest swizzled TMA box row


def attn_boxes(d: int) -> list[tuple[int, int, int]]:
    """The TMA boxes a row of a q, k or v tile of head dim ``d`` is loaded
    in by the bf16 attention forward (``csrc/attn_sm90.cuh``), as (first
    column, width, swizzle bytes): as many 64-column boxes under the 128-byte
    swizzle as fit, the rest in one box under the swizzle of its own width
    (at d 80: columns [0, 64) and [64, 80) under the 32-byte swizzle)."""
    wide = _SWIZZLE_LINE // 2
    boxes = [(c, wide, _SWIZZLE_LINE) for c in range(0, d - d % wide, wide)]
    if d % wide:
        boxes.append((d - d % wide, d % wide, 2 * (d % wide)))
    return boxes


def attn_smem_bytes(d: int, k_slots: int) -> int:
    """Shared memory of one block of the bf16 attention forward at head dim
    ``d`` holding ``k_slots`` k tiles (``attn_sm90.cuh``'s ``Plan::smem``):
    the 1,024-byte alignment slack, the consumers' q tiles, the k slots and
    ``ATTN_V_SLOTS`` v slots (64 rows of d bf16 each), and one 8-byte
    mbarrier for q and two for each slot."""
    tile = ATTN_TILE * d * 2
    return 1024 + (ATTN_CONSUMERS + k_slots + ATTN_V_SLOTS) * tile + 8 * (1 + 2 * k_slots + 2 * ATTN_V_SLOTS)


def attn_k_slots(T: int, d: int) -> int:
    """k slots of a block over rows of T keys (``Plan::k_slots``): the whole
    key row, resident in shared memory for both walks, where that fits two
    blocks on an SM; else as many as fit, the row streamed through them
    once a walk."""
    n = -(-T // ATTN_TILE)
    if attn_smem_bytes(d, n) <= ATTN_SMEM_PER_BLOCK:
        return n
    slots = 2
    while attn_smem_bytes(d, slots + 1) <= ATTN_SMEM_PER_BLOCK:
        slots += 1
    return slots


def attn_takes(seqs: int, T: int, n_heads: int, d: int) -> bool:
    """Whether the bf16 attention forward (``csrc/attn_sm90.cuh``'s
    ``takes``, which this mirrors) runs ``seqs`` sequences of T tokens and
    ``n_heads`` heads of dim ``d``: head dim 64 or 80, any T, and a grid of
    one block per pair of 64-row query tiles, head and sequence within 2³¹ −
    1 blocks."""
    if d not in ATTN_HEAD_DIMS or min(seqs, T, n_heads) < 1:
        return False
    pairs = -(-(-(-T // ATTN_TILE)) // ATTN_CONSUMERS)
    return pairs * n_heads * seqs <= 2 ** 31 - 1


def attn_forward(qkv: torch.Tensor, n_heads: int, causal: bool = False) -> torch.Tensor:
    """The attention core of K1, K3a and K9 alone (``csrc/flash.cuh``'s
    ``launch_flash_fwd``, through the entry ``evr_flash_forward`` of
    ``csrc/block_attn.cu``): o [B, T, W] from the rounded qkv [B, T, 3W], as
    the block halves compute it between their GEMMs. In bfloat16 the TMA +
    wgmma kernel of ``csrc/attn_sm90.cuh``, in float32 ``flash_fwd_kernel``.
    For checking and timing it apart from them; no path calls it. A CPU
    tensor takes ``attn_forward_plain``."""
    refuse_grad("attn_forward", qkv)
    if not qkv.is_cuda:
        return attn_forward_plain(qkv, n_heads, causal)
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % n_heads:
        raise ValueError(f"attn_forward: qkv of shape {tuple(qkv.shape)} with {n_heads} heads")
    B, T, W3 = qkv.shape
    W = W3 // 3
    d = W // n_heads
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"attn_forward: dtype {qkv.dtype} not supported (float32 or bfloat16)")
    if not attn_takes(B, T, n_heads, d):
        raise ValueError(f"attn_forward: the CUDA kernel does not take {B} x {T} tokens of "
                         f"{n_heads} heads of dim {d} (head dims {ATTN_HEAD_DIMS})")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attn_forward: qkv must be contiguous and 16-byte aligned")
    o = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    rc = build.load("block_attn").evr_flash_forward(
        _DTYPE_CODES[qkv.dtype], qkv.data_ptr(), o.data_ptr(), B, T, W, n_heads, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _raise_rc(rc, "attn_forward", qkv.shape)
    attn_forward.launches += 1
    return o


def attn_backward(qkv: torch.Tensor, dout: torch.Tensor, n_heads: int, causal: bool = False):
    """K5a's attention backward alone (``csrc/flash.cuh``, through the entry
    ``evr_flash_backward`` of ``csrc/block_attn_bwd.cu``): from the rounded
    qkv [B, T, 3W] and do [B, T, W], (o [B*T, W], dqkv [B*T, 3W] in fp32, and
    in bfloat16 round(dqkv), else None), as K5a computes them between its
    GEMMs. For checking and timing it apart from them; no path calls it. A
    CPU tensor takes ``attn_backward_plain``."""
    dt = qkv.dtype
    bf16 = dt == torch.bfloat16
    if not qkv.is_cuda:
        o, dqkv = attn_backward_plain(qkv, dout, n_heads, causal)
        return o, dqkv, dqkv.to(dt) if bf16 else None
    B, T, W3 = qkv.shape
    W = W3 // 3
    if dt not in _DTYPE_CODES or dout.dtype != dt or tuple(dout.shape) != (B, T, W) or W % n_heads:
        raise ValueError(f"attn_backward: qkv {dt} {tuple(qkv.shape)}, do {dout.dtype} "
                         f"{tuple(dout.shape)}, {n_heads} heads")
    if not (qkv.is_contiguous() and dout.is_contiguous()) or dout.device != qkv.device:
        raise ValueError("attn_backward: qkv and do must be contiguous and on one device")
    dev, M = qkv.device, B * T
    lib = build.load("block_attn_bwd")
    o = torch.empty((M, W), dtype=dt, device=dev)
    st = torch.empty((3, B, n_heads, T), dtype=torch.float32, device=dev)
    dqkv = torch.empty((M, W3), dtype=torch.float32, device=dev)
    dqkv_r = torch.empty((M, W3), dtype=dt, device=dev) if bf16 else None
    rc = lib.evr_flash_backward(
        _DTYPE_CODES[dt], qkv.data_ptr(), dout.data_ptr(), o.data_ptr(), st.data_ptr(), dqkv.data_ptr(),
        _ptr(dqkv_r), B, T, W, n_heads, int(causal), 1.0 / math.sqrt(W // n_heads),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_rc(rc, "attn_backward", qkv.shape)
    attn_backward.launches += 1
    return o, dqkv, dqkv_r


fused_attn_block.launches = 0
fused_mlp_block.launches = 0
gemm_bf16.launches = 0
attn_forward.launches = 0
attn_backward.launches = 0
fused_attn_block_q.launches = 0
fused_mlp_block_q.launches = 0
fused_attn_block_bwd.launches = 0
fused_mlp_block_bwd.launches = 0


def block_half_params(p) -> tuple[tuple, tuple]:
    """A block's params (``layers.init_block`` layout) as the argument
    tuples of the attention half and the MLP half."""
    a, m = p["attn"], p["mlp"]
    return (
        (p["ln_1"]["scale"], p["ln_1"]["bias"], a["qkv"]["kernel"], a["qkv"]["bias"],
         a["out"]["kernel"], a["out"]["bias"]),
        (p["ln_2"]["scale"], p["ln_2"]["bias"], m["fc"]["kernel"], m["fc"]["bias"],
         m["proj"]["kernel"], m["proj"]["bias"]),
    )


def quant_block_half_params(p) -> tuple[tuple, tuple]:
    """An int8 block's params (``models.quant`` layout) as the argument
    tuples of K3's attention half and MLP half."""
    a, m = p["attn"], p["mlp"]

    def lin(q):
        return q["kernel_q"], q["kernel_scale"], q["bias"]

    return (
        (p["ln_1"]["scale"], p["ln_1"]["bias"], *lin(a["qkv"]), *lin(a["out"])),
        (p["ln_2"]["scale"], p["ln_2"]["bias"], *lin(m["fc"]), *lin(m["proj"])),
    )


def _block_forward(x, attn, mlp, n_heads, activation, causal, impl):
    """(x_mid, out) of one block: K1 then K2 (``impl="kernel"``) or their
    plain versions (``impl="plain"``)."""
    if impl == "kernel":
        x_mid = fused_attn_block(x, *attn, n_heads=n_heads, causal=causal)
        return x_mid, fused_mlp_block(x_mid, *mlp, activation=activation)
    if impl != "plain":
        raise ValueError(f"unknown impl {impl!r}")
    dt = x.dtype
    x_mid = fused_attn_block_plain(x, *(t.to(dt) for t in attn), n_heads=n_heads, causal=causal)
    return x_mid, fused_mlp_block_plain(x_mid, *(t.to(dt) for t in mlp), activation=activation)


def _block_backward(x, x_mid, g, attn, mlp, n_heads, activation, causal, impl):
    """(dx, attention-half grads, MLP-half grads): K5b from x_mid, then K5a
    from x (``impl="kernel"``), or their plain versions."""
    if impl == "kernel":
        dmid, *dmlp = fused_mlp_block_bwd(x_mid, g, *mlp, activation=activation)
        dx, *dattn = fused_attn_block_bwd(x, dmid, *attn, n_heads=n_heads, causal=causal)
        return dx, dattn, dmlp
    dt = x.dtype
    dmid, *dmlp = fused_mlp_block_bwd_plain(x_mid, g, *(t.to(dt) for t in mlp), activation=activation)
    dx, *dattn = fused_attn_block_bwd_plain(
        x, dmid, *(t.to(dt) for t in attn), n_heads=n_heads, causal=causal
    )
    return dx, dattn, dmlp


class FusedBlockFunction(torch.autograd.Function):
    """One residual block with the backward of the JAX custom VJP
    ``fused_block_apply`` (``_fused_block_fwd``/``_fused_block_bwd``).

    Forward: the attention half, then the MLP half; only x and the mid-block
    residual x_mid are saved (with the parameters). Backward: the MLP half's
    backward from x_mid, then the attention half's from x, each recomputing
    its half's internals; the fp32 gradients are cast to the parameters'
    dtypes. ``impl="kernel"`` runs K1, K2, K5b and K5a (their plain versions
    on a CPU tensor); ``impl="plain"`` runs the plain versions on any device,
    the reference the kernel path is held to on the card. There is no
    fallback between the two.

    ``apply(x, n_heads, activation, causal, impl, *params)`` with the twelve
    parameters in ``block_half_params`` order."""

    @staticmethod
    def forward(ctx, x, n_heads, activation, causal, impl, *params):
        x_mid, out = _block_forward(x, params[:6], params[6:], n_heads, activation, causal, impl)
        ctx.save_for_backward(x, x_mid, *params)
        ctx.block = (n_heads, activation, causal, impl)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x_mid, *params = ctx.saved_tensors
        dx, dattn, dmlp = _block_backward(
            x, x_mid, g.to(x.dtype).contiguous(), params[:6], params[6:], *ctx.block
        )
        grads = [gr.to(p.dtype) for gr, p in zip((*dattn, *dmlp), params)]
        return (dx, None, None, None, None, *grads)


def fused_block_apply(
    x, p, n_heads: int, activation: str = "quick_gelu", causal: bool = False,
    impl: str = "kernel",
):
    """One whole residual block as K1 then K2 (``impl="kernel"``) or their
    plain versions (``impl="plain"``). Under grad mode, when x or a parameter
    requires grad, through ``FusedBlockFunction`` (backward K5b then K5a, or
    their plain versions); otherwise forward only, as the JAX package runs
    a frozen prefix."""
    attn, mlp = block_half_params(p)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in (*attn, *mlp))):
        return FusedBlockFunction.apply(x, n_heads, activation, causal, impl, *attn, *mlp)
    return _block_forward(x, attn, mlp, n_heads, activation, causal, impl)[1]


def fused_quant_block_apply(
    x, p, n_heads: int, activation: str = "quick_gelu", causal: bool = False
):
    """One whole residual block over int8 weights as K3a then K3b."""
    attn, mlp = quant_block_half_params(p)
    x = fused_attn_block_q(x, *attn, n_heads=n_heads, causal=causal)
    return fused_mlp_block_q(x, *mlp, activation=activation)


def plain_block_apply(x, p, n_heads: int, activation: str = "quick_gelu", causal: bool = False):
    """``fused_block_apply`` (or, on int8 params, ``fused_quant_block_apply``)
    through the plain versions, on any device; differentiable on float
    params (``FusedBlockFunction`` with the plain backward)."""
    if "kernel_q" in p["attn"]["qkv"]:
        dt = x.dtype
        attn, mlp = quant_block_half_params(p)
        x = fused_attn_block_q_plain(
            x, *cast_quant_args(dt, attn), n_heads=n_heads, causal=causal
        )
        return fused_mlp_block_q_plain(x, *cast_quant_args(dt, mlp), activation=activation)
    return fused_block_apply(x, p, n_heads, activation, causal, impl="plain")


def fused_block_merged_plain(x, p, n_heads: int, activation: str = "quick_gelu", causal: bool = False):
    """K9's function in plain PyTorch: K1's plain version, then K2's, with
    the mid-block residual in x's dtype between them."""
    return _block_forward(x, *block_half_params(p), n_heads, activation, causal, "plain")[1]


def fused_block_merged(
    x: torch.Tensor,  # [B, T, W]
    p,  # one residual block's params (layers.init_block layout)
    n_heads: int,
    activation: str = "quick_gelu",
    causal: bool = False,
) -> torch.Tensor:
    """One whole residual block, kernel K9 on a CUDA tensor (head dim 64 or
    80, any T): K1's math then K2's from one C call, bit-equal to
    ``fused_block_apply``. Forward only, as in the JAX package."""
    attn, mlp = block_half_params(p)
    refuse_grad("fused_block_merged", x, *attn, *mlp)
    if not x.is_cuda:
        return fused_block_merged_plain(x, p, n_heads, activation, causal)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 3 or x.shape[2] % n_heads:
        raise ValueError(f"fused_block_merged: x of shape {tuple(x.shape)} with {n_heads} heads")
    dt = x.dtype
    params = [t.to(dt).contiguous() for t in (*attn, *mlp)]
    B, T, W = x.shape
    hid = params[8].shape[-1]
    _check_cuda(
        x, params,
        [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, hid), (hid,), (hid, W), (W,)],
        "fused_block_merged",
    )
    rows = B * T
    _check_gemms(
        "fused_block_merged", x, [(rows, 3 * W, W), (rows, W, W), (rows, hid, W), (rows, W, hid)],
        [params[i] for i in (2, 4, 8, 10)], [params[i] for i in (3, 5, 9, 11)],
    )
    lib = build.load("block_merged")
    # the LN parameters as the row pass reads them: their element-type values in fp32
    params = [t.float() if i in (0, 1, 6, 7) else t for i, t in enumerate(params)]
    qkv = torch.empty((rows, 3 * W), dtype=dt, device=x.device)
    y, o, xc, out = (torch.empty_like(x) for _ in range(4))
    h = torch.empty((rows, hid), dtype=dt, device=x.device)
    rc = lib.evr_fused_block_merged(
        _DTYPE_CODES[dt], x.data_ptr(), *(t.data_ptr() for t in params),
        y.data_ptr(), qkv.data_ptr(), o.data_ptr(), xc.data_ptr(), h.data_ptr(), out.data_ptr(),
        B, T, W, n_heads, hid, _ACT_CODES[activation], int(causal), 1.0 / math.sqrt(W // n_heads),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_rc(rc, "fused_block_merged", x.shape)
    fused_block_merged.launches += 1
    return out


fused_block_merged.launches = 0
