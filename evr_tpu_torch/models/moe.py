"""Mixture-of-Experts CLIP towers: LIMoE-style sparse MLPs (PyTorch).

Counterpart of ``evr_tpu/models/moe.py``: the same configuration, params
layout and arithmetic. Each MoE layer stores its experts as stacked tensors
with a leading expert dimension (``fc.kernel [E, W, 4W]``, ``proj.kernel
[E, 4W, W]``), so expert parallelism splits dimension 0 over a mesh axis
(``parallel.ep``). Routing is the GShard einsum dispatch: tokens regrouped
``[G, S, W]``, the router in fp32, renormalised top-k gates, slot-major
cumsum priority, overflow past the per-group capacity dropped (the residual
carries those tokens), one-hot dispatch and combine contractions around the
batched per-expert products. The batched products stay ``torch.einsum``,
as the JAX package computes them in XLA outside any Pallas kernel.

An MoE block's attention half follows ``layers.block_apply``'s routing:
under ``"auto"`` a CUDA tensor of width ≤ 1280 runs kernel K1
(``ops.block_fused.fused_attn_block``), ``"fused"`` forces it (its plain
version on a CPU tensor), ``"auto_grad"`` resolves to the plain composition
as in the JAX package, ``"plain"`` runs K1's plain version; dense blocks stay
on ``block_apply`` (K1 then K2 on the card). The final block runs in full:
the towers pool after the whole stack, as the JAX MoE towers do.

Random weights come from an explicit ``torch.Generator`` (the JAX package's
streams cannot be reproduced; tests carry its params across).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.utils.checkpoint

from evr_tpu_torch.ops.block_fused import fused_attn_block, fused_attn_block_plain

from .layers import ACTIVATIONS, FUSED_MAX_WIDTH, Params, attention, block_apply, layer_norm


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    # top-k routing: 1 = Switch, 2 = GShard/LIMoE (renormalised gates)
    router_k: int = 1
    # per-expert slots = ceil(capacity_factor * k * group_size / n_experts)
    capacity_factor: float = 1.25
    # every Nth block from the tower's end carries an MoE MLP
    moe_every: int = 2
    # Switch load-balance aux loss weight
    aux_weight: float = 1e-2
    # GShard token grouping: the group is the largest divisor of the token
    # count that is ≤ this
    group_size: int = 256


def moe_block_indices(n_layers: int, moe_every: int) -> tuple[int, ...]:
    """Block indices carrying MoE MLPs: every ``moe_every``-th from the end
    (the last block always included)."""
    return tuple(range(n_layers - 1, -1, -moe_every))[::-1]


def moe_group(n_tokens: int, group_size: int) -> int:
    """S: the largest divisor of ``n_tokens`` that is ≤ ``group_size``."""
    for s in range(min(group_size, n_tokens), 0, -1):
        if n_tokens % s == 0:
            return s
    return 1


def _generator(rng) -> torch.Generator:
    return rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))


# -- the MoE MLP layer --------------------------------------------------------


def init_moe_mlp(generator: torch.Generator, width: int, n_layers: int, n_experts: int) -> Params:
    """Experts as stacked fp32 tensors on the CPU: fc std (2W)^-1/2, proj std
    W^-1/2 (2L)^-1/2 (the dense block's scales), router std 0.02; drawn
    from ``generator`` in the order router, fc, proj."""
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    fc_std = (2 * width) ** -0.5

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    return {
        "router": {"kernel": normal((width, n_experts), 0.02)},
        "fc": {"kernel": normal((n_experts, width, 4 * width), fc_std),
               "bias": torch.zeros((n_experts, 4 * width))},
        "proj": {"kernel": normal((n_experts, 4 * width, width), proj_std),
                 "bias": torch.zeros((n_experts, width))},
    }


def upcycle_moe_mlp(generator: torch.Generator, mlp: Params, n_experts: int) -> Params:
    """Sparse Upcycling: every expert a copy of the dense MLP (fp32), the
    router drawn from ``generator``. With renormalised top-k ≥ 2 routing the
    layer computes what the dense MLP did, up to the tokens dropped at
    capacity."""

    def stack(a):
        t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype=np.float32))
        return t.float().unsqueeze(0).expand((n_experts,) + tuple(t.shape)).clone()

    width = int(mlp["fc"]["kernel"].shape[0])
    return {
        "router": {"kernel": torch.randn((width, n_experts), generator=generator) * 0.02},
        "fc": {"kernel": stack(mlp["fc"]["kernel"]), "bias": stack(mlp["fc"]["bias"])},
        "proj": {"kernel": stack(mlp["proj"]["kernel"]), "bias": stack(mlp["proj"]["bias"])},
    }


def _experts(xin: torch.Tensor, p: Params, activation: str) -> torch.Tensor:
    """[G, E, C, W] → [G, E, C, W]: each expert's MLP over its slots, the
    batched products in x's dtype."""
    dt = xin.dtype
    h = torch.einsum("gecw,ewh->gech", xin, p["fc"]["kernel"].to(dt)) + p["fc"]["bias"].to(dt)[None, :, None]
    h = ACTIVATIONS[activation](h)
    return torch.einsum("gech,ehw->gecw", h, p["proj"]["kernel"].to(dt)) + p["proj"]["bias"].to(dt)[None, :, None]


def expert_mlp(xin: torch.Tensor, p: Params, activation: str) -> torch.Tensor:
    """The expert half of an MoE layer. Where the expert leaves are split
    over slots (``parallel.ep.ExpertShards``) the dispatched tokens go to the
    slots that hold their experts and come back (``exchange``)."""
    kernel = p["fc"]["kernel"]
    if hasattr(kernel, "exchange"):
        return kernel.exchange(xin, p, lambda x, q: _experts(x, q, activation))
    return _experts(xin, p, activation)


def moe_mlp_apply(
    x: torch.Tensor, p: Params, moe: MoEConfig, activation: str = "quick_gelu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, W] → ([B, T, W], the Switch aux loss, an fp32 scalar).

    Tokens regrouped [G, S, W] (S = ``moe_group(B·T, moe.group_size)``),
    capacity C = min(⌈cf·k·S/E⌉, S) per expert and group; the router's
    logits and softmax in fp32; the top-k gates (ties to the lower expert,
    as ``lax.top_k``) renormalised when k > 1; positions by a cumsum over
    the slot-major (choice, token) order, so every first choice outranks any
    second; overflow dropped. Aux = E · Σ_e f_e·P_e over first choices, per
    group, averaged."""
    B, T, W = x.shape
    E, k = moe.n_experts, moe.router_k
    N = B * T
    S = moe_group(N, moe.group_size)
    G = N // S
    C = min(max(1, math.ceil(moe.capacity_factor * k * S / E)), S)
    xg = x.reshape(G, S, W)

    logits = torch.einsum("gsw,we->gse", xg.float(), p["router"]["kernel"].float())
    probs = torch.softmax(logits, dim=-1)  # [G, S, E] fp32
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    mask = torch.nn.functional.one_hot(gate_idx, E).float()  # [G, S, k, E]

    mask_sm = mask.permute(0, 2, 1, 3).reshape(G, k * S, E)
    pos_sm = (torch.cumsum(mask_sm, dim=1) - 1.0) * mask_sm
    pos = pos_sm.reshape(G, k, S, E).permute(0, 2, 1, 3)  # [G, S, k, E]
    keep = mask * (pos < C)
    # a position past the capacity is kept nowhere: its one-hot is zero
    slot_oh = torch.nn.functional.one_hot(pos.long().clamp(0, C - 1), C).float()
    ce = slot_oh * keep[..., None]  # [G, S, k, E, C]
    combine = torch.einsum("gsk,gskec->gsec", gate_vals, ce)
    dispatch = (combine > 0).to(x.dtype)

    xin = torch.einsum("gsec,gsw->gecw", dispatch, xg)  # [G, E, C, W]
    ye = expert_mlp(xin, p, activation)
    y = torch.einsum("gsec,gecw->gsw", combine.to(x.dtype), ye)

    f = mask[:, :, 0, :].mean(dim=1)  # [G, E] fraction routed (first choices)
    P = probs.mean(dim=1)  # [G, E] mean router probability
    aux = (E * (f * P).sum(dim=-1)).mean()
    return y.reshape(B, T, W), aux


# -- the MoE residual block ---------------------------------------------------


def init_moe_block(generator: torch.Generator, width: int, n_layers: int, n_experts: int) -> Params:
    """A pre-LN block whose MLP half is an MoE layer; the attention half at
    ``layers.init_block``'s scales. fp32 CPU tensors from ``generator``."""
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    def ln():
        return {"scale": torch.ones(width), "bias": torch.zeros(width)}

    return {
        "ln_1": ln(),
        "attn": {
            "qkv": {"kernel": normal((width, 3 * width), width ** -0.5), "bias": torch.zeros(3 * width)},
            "out": {"kernel": normal((width, width), proj_std), "bias": torch.zeros(width)},
        },
        "ln_2": ln(),
        "moe": init_moe_mlp(generator, width, n_layers, n_experts),
    }


def _attention_half(x, p, n_heads: int, causal: bool, attn_impl: str) -> torch.Tensor:
    """x + attention(LN(x)) by ``moe_block_apply``'s routing."""
    if attn_impl in ("auto_grad", "plain_grad"):
        attn_impl = "xla"
    a = p["attn"]
    attn_args = (p["ln_1"]["scale"], p["ln_1"]["bias"], a["qkv"]["kernel"], a["qkv"]["bias"],
                 a["out"]["kernel"], a["out"]["bias"])
    if attn_impl == "fused" or (attn_impl == "auto" and x.shape[2] <= FUSED_MAX_WIDTH and x.is_cuda):
        return fused_attn_block(x, *attn_args, n_heads=n_heads, causal=causal)
    if attn_impl == "plain":
        return fused_attn_block_plain(x, *(t.to(x.dtype) for t in attn_args), n_heads=n_heads, causal=causal)
    return x + attention(layer_norm(x, p["ln_1"]), a, n_heads, causal, attn_impl)


def moe_block_apply(
    x: torch.Tensor,
    p: Params,
    n_heads: int,
    moe: MoEConfig,
    causal: bool = False,
    attn_impl: str = "xla",
    activation: str = "quick_gelu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + MoE(LN(x')), aux) with x' = x + attention(LN(x)). The attention
    half: K1 under ``"auto"`` (a CUDA tensor of width ≤ 1280) or ``"fused"``
    (its plain version on a CPU tensor), K1's plain version under
    ``"plain"``, otherwise ``layers.attention`` (``"auto_grad"`` and
    ``"plain_grad"`` resolve to ``"xla"``, as the JAX package's MoE block
    takes XLA under gradients)."""
    x = _attention_half(x, p, n_heads, causal, attn_impl)
    y, aux = moe_mlp_apply(layer_norm(x, p["ln_2"]), p["moe"], moe, activation)
    return x + y, aux


def _tokens(pieces: list, lo: int, hi: int, device) -> torch.Tensor:
    """Global tokens [lo, hi) on ``device``, from ``pieces`` ((start of a
    slot's tokens, its [n, W] rows) each)."""
    parts = [rows[max(lo, a) - a:min(hi, a + rows.shape[0]) - a].to(device)
             for a, rows in pieces if a < hi and lo < a + rows.shape[0]]
    if sum(t.shape[0] for t in parts) != hi - lo:
        raise ValueError(f"MoE token group [{lo}, {hi}) reaches rows of another process: give each "
                         "process whole token groups (batch × tokens a multiple of the group size)")
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def moe_mlp_slots(hs: list, ps: list, moe: MoEConfig, activation: str, starts: list, n_tokens: int
                  ) -> tuple[list, list]:
    """``moe_mlp_apply`` over data slots exactly as over the global batch
    of ``n_tokens`` tokens: slot i holds ``hs[i]`` [b, T, W] (global tokens
    from ``starts[i]``) and its aliases ``ps[i]`` of the layer's params.
    The token groups are the one-device layer's (S = ``moe_group(n_tokens,
    group_size)`` consecutive tokens, so the same capacity and drops); each
    group runs on the slot that holds its first token, a group that crosses
    into the next slot taking those rows over and handing their outputs
    back. Returns (each slot's [b, T, W] output, each slot's share of the
    aux loss: its groups' mean aux × its groups / all groups)."""
    S = moe_group(n_tokens, moe.group_size)
    whole = dataclasses.replace(moe, group_size=S)  # S divides every run of whole groups
    pieces = [(a, h.reshape(-1, h.shape[-1])) for a, h in zip(starts, hs)]
    outs, shares = [], []
    for (a, rows), h, p in zip(pieces, hs, ps):
        lo, hi = -(-a // S) * S, -(-(a + rows.shape[0]) // S) * S  # the groups that start here
        if lo == hi:
            shares.append(torch.zeros((), dtype=torch.float32, device=h.device))
            continue
        y, aux = moe_mlp_apply(_tokens(pieces, lo, hi, h.device)[None], p, whole, activation)
        outs.append((lo, y[0]))
        shares.append(aux if hi - lo == n_tokens else aux * ((hi - lo) / n_tokens))
    ys = [_tokens(outs, a, a + rows.shape[0], h.device).reshape(h.shape) for (a, rows), h in zip(pieces, hs)]
    return ys, shares


def _moe_block_slots(xs, ps, n_heads, moe, causal, attn_impl, activation, starts, n_tokens):
    xs = [_attention_half(x, p, n_heads, causal, attn_impl) for x, p in zip(xs, ps)]
    ys, shares = moe_mlp_slots([layer_norm(x, p["ln_2"]) for x, p in zip(xs, ps)], [p["moe"] for p in ps],
                               moe, activation, starts, n_tokens)
    return [x + y for x, y in zip(xs, ys)], shares


def run_blocks_moe_slots(xs: list, blocks: list, n_heads: int, moe: MoEConfig, causal: bool, cfg,
                         row0s: list, n_rows: int) -> tuple[list, list]:
    """The mixed block stack over data slots: slot i's activations ``xs[i]``
    (rows ``row0s[i]`` on of a global batch of ``n_rows``) through its
    aliases ``blocks[i]`` of the blocks. Blocks holding ``"moe"`` run in
    step over the slots, their MoE layers on the global batch's token
    groups (``moe_mlp_slots``); the rest through ``layers.block_apply``
    slot by slot; with ``cfg.remat`` under grad mode each block in
    non-reentrant ``torch.utils.checkpoint``. Returns (xs, each slot's share
    of the summed aux loss)."""
    remat = getattr(cfg, "remat", False) and torch.is_grad_enabled()
    T = xs[0].shape[1]
    starts, n_tokens = [r * T for r in row0s], n_rows * T
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for li in range(len(blocks[0])):
        bps = [b[li] for b in blocks]
        if "moe" in bps[0]:
            args = (xs, bps, n_heads, moe, causal, cfg.attn_impl, cfg.activation, starts, n_tokens)
            xs, shares = (torch.utils.checkpoint.checkpoint(_moe_block_slots, *args, use_reentrant=False)
                          if remat else _moe_block_slots(*args))
            aux = [a + s for a, s in zip(aux, shares)]
        else:
            xs = [torch.utils.checkpoint.checkpoint(block_apply, x, bp, n_heads, causal, cfg.attn_impl,
                                                    cfg.activation, use_reentrant=False)
                  if remat else block_apply(x, bp, n_heads, causal, cfg.attn_impl, cfg.activation)
                  for x, bp in zip(xs, bps)]
    return xs, aux


def run_blocks_moe(x, blocks, n_heads: int, moe: MoEConfig, causal: bool, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixed block stack on one device: blocks holding ``"moe"``
    through ``moe_block_apply``'s arithmetic, the rest through
    ``layers.block_apply``. Returns (x, the summed aux loss)."""
    (x,), (aux,) = run_blocks_moe_slots([x], [blocks], n_heads, moe, causal, cfg, [0], x.shape[0])
    return x, aux


# -- the MoE-CLIP dual encoder --------------------------------------------------


def _towers(cfg):
    return (("visual", cfg.vision.layers), ("text", cfg.text.layers))


def init_moe_clip_params(rng, cfg, moe: MoEConfig) -> Params:
    """Fresh MoE-CLIP weights: ``models.clip.init_clip_params(seed)`` with
    every ``moe_every``-th block of both towers (from the end) carrying an
    MoE MLP in place of its dense one, drawn from a ``torch.Generator``
    (``rng``, or seeded with it) tower by tower, block by block."""
    from .clip import init_clip_params

    gen = _generator(rng)
    seed = int(rng) if not isinstance(rng, torch.Generator) else int(torch.randint(
        0, 2**31 - 1, (), generator=gen))
    params = init_clip_params(seed, cfg)
    for tower, layers in _towers(cfg):
        width = params[tower]["blocks"][0]["mlp"]["fc"]["kernel"].shape[0]
        for i in moe_block_indices(layers, moe.moe_every):
            block = dict(params[tower]["blocks"][i])
            block["moe"] = init_moe_mlp(gen, width, layers, moe.n_experts)
            del block["mlp"]
            params[tower]["blocks"][i] = block
    return params


def upcycle_clip_params(rng, params: Params, cfg, moe: MoEConfig) -> Params:
    """Sparse-Upcycle a dense CLIP tree: the selected blocks' dense MLPs
    become ``moe.n_experts`` identical experts, each router drawn from
    ``rng`` (a ``torch.Generator`` or a seed) tower by tower, block by
    block. The other leaves are the caller's."""
    gen = _generator(rng)
    out = dict(params)
    for tower, layers in _towers(cfg):
        blocks = list(out[tower]["blocks"])
        for i in moe_block_indices(layers, moe.moe_every):
            block = dict(blocks[i])
            block["moe"] = upcycle_moe_mlp(gen, block["mlp"], moe.n_experts)
            del block["mlp"]
            blocks[i] = block
        out[tower] = {**out[tower], "blocks": blocks}
    return out


def has_moe(params: Params) -> bool:
    """Whether a CLIP tree's vision tower holds MoE blocks."""
    return any("moe" in b for b in params.get("visual", {}).get("blocks", ()))


def _zero_aux(xs: list) -> list:
    return [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]


def encode_image_slots(
    params: list, cfg, moe: MoEConfig | None, pixels: list, dtype: torch.dtype = torch.float32,
    patch_keep: list | None = None, row0s: list | None = None, n_rows: int | None = None,
) -> tuple[list, list]:
    """The image tower over data slots: slot i's pixels ``pixels[i]`` (rows
    ``row0s[i]`` on of a global batch of ``n_rows``) through its params
    ``params[i]`` → (each slot's [b, embed_dim] unnormalised fp32
    features, each slot's share of the aux loss). ``moe`` None: the dense
    tower (``clip.encode_image``) slot by slot, aux zero; otherwise the MoE
    tower, its MoE layers on the global batch's token groups as on one
    device (``run_blocks_moe_slots``). ``patch_keep`` as in
    ``clip.encode_image``, one a slot."""
    from .clip import _patch_tokens, _vision_prefix, encode_image, vision_pool

    keeps = patch_keep or [None] * len(params)
    if moe is None:
        feats = [encode_image(p, cfg, x, dtype=dtype, patch_keep=k) for p, x, k in zip(params, pixels, keeps)]
        return feats, _zero_aux(feats)
    xs = [_vision_prefix(p["visual"], cfg, _patch_tokens(p["visual"], cfg, x, dtype), dtype, k)
          for p, x, k in zip(params, pixels, keeps)]
    xs, aux = run_blocks_moe_slots(xs, [p["visual"]["blocks"] for p in params], cfg.vision.heads, moe, False,
                                   cfg, row0s or [0], n_rows or pixels[0].shape[0])
    return [vision_pool(p, cfg, x, dtype) for p, x in zip(params, xs)], aux


def encode_text_slots(
    params: list, cfg, moe: MoEConfig | None, tokens: list, dtype: torch.dtype = torch.float32,
    row0s: list | None = None, n_rows: int | None = None,
) -> tuple[list, list]:
    """The text tower over data slots, as ``encode_image_slots``."""
    from .clip import encode_text, text_pool, text_tokens

    tokens = [t.long() for t in tokens]
    if moe is None:
        feats = [encode_text(p, cfg, t, dtype=dtype) for p, t in zip(params, tokens)]
        return feats, _zero_aux(feats)
    xs = [text_tokens(p, cfg, t, dtype) for p, t in zip(params, tokens)]
    xs, aux = run_blocks_moe_slots(xs, [p["text"]["blocks"] for p in params], cfg.text.heads, moe, True, cfg,
                                   row0s or [0], n_rows or tokens[0].shape[0])
    return [text_pool(p, cfg, x, t, dtype) for p, x, t in zip(params, xs, tokens)], aux


def image_features(params: Params, cfg, moe: MoEConfig | None, pixels: torch.Tensor,
                   dtype: torch.dtype = torch.float32, patch_keep: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """pixels [B, H, W, 3] (preprocessed) → ([B, embed_dim] unnormalised
    fp32, aux) on one device: the MoE tower under ``moe``, else the dense
    one (aux zero)."""
    (feats,), (aux,) = encode_image_slots([params], cfg, moe, [pixels], dtype, [patch_keep])
    return feats, aux


def text_features(params: Params, cfg, moe: MoEConfig | None, tokens: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, ctx] → ([B, embed_dim] unnormalised fp32, aux), as
    ``image_features``."""
    (feats,), (aux,) = encode_text_slots([params], cfg, moe, [tokens], dtype)
    return feats, aux


def encode_image_moe(
    params: Params, cfg, moe: MoEConfig, pixels: torch.Tensor, dtype: torch.dtype = torch.float32,
    patch_keep: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """pixels [B, H, W, 3] (preprocessed) → ([B, embed_dim] unnormalised
    fp32, aux). ``patch_keep`` as in ``clip.encode_image``."""
    return image_features(params, cfg, moe, pixels, dtype, patch_keep)


def encode_text_moe(
    params: Params, cfg, moe: MoEConfig, tokens: torch.Tensor, dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, ctx] → ([B, embed_dim] unnormalised fp32, aux)."""
    return text_features(params, cfg, moe, tokens, dtype)


def moe_clip_forward(
    params: Params, cfg, moe: MoEConfig, pixels: torch.Tensor, tokens: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """``clip.clip_forward``'s outputs plus ``aux_loss`` (the two towers'
    summed load-balance terms)."""
    img, aux_i = encode_image_moe(params, cfg, moe, pixels, dtype)
    txt, aux_t = encode_text_moe(params, cfg, moe, tokens, dtype)
    img_n = img / img.norm(dim=-1, keepdim=True)
    txt_n = txt / txt.norm(dim=-1, keepdim=True)
    logits_per_image = params["logit_scale"].float().exp() * img_n @ txt_n.T
    return {
        "image_features": img_n,
        "text_features": txt_n,
        "logits_per_image": logits_per_image,
        "logits_per_text": logits_per_image.T,
        "aux_loss": aux_i + aux_t.to(aux_i.device),
    }
