"""Sequence parallelism for the CLIP towers: the token axis split over a
``seq`` mesh axis (PyTorch).

Counterpart of ``evr_tpu/parallel/sp.py``: token-parallel blocks with
all-gathered K and V, exact, not approximate.

- Activations live as token shards ``[B, T/S, W]``, one a ``seq`` slot.
  LayerNorm, the qkv and out projections and the whole MLP act per token,
  on each shard alone; the weights are replicated.
- Attention gathers K and V from every shard (``[B, T, h, d]`` on each
  slot) and keeps its own Q rows, so a slot's score tensor is ``[B, h, T/S,
  T]``. The softmax is fp32, cast back to the activation dtype, masked with
  −1e9, as the JAX module computes it.
- A T that does not divide by S is right-padded: padded key columns are
  masked out of every softmax, and padded query rows are dropped after the
  final gather. The causal mask compares global row ids (shard offset +
  local index), so the text tower is exact too.
- One controller runs every slot: the all-gather is each slot's copy of the
  other shards' K and V onto its device. The JAX module runs no kernel here
  (plain einsums), and the port's products are ``torch`` products.
- With ``data_axis`` the batch splits over the data groups
  (``Mesh.leaders``), each group's tokens over its ``seq`` slots.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from evr_tpu_torch.models.clip import CLIPConfig, text_pool, text_tokens, vision_pool, vision_tokens
from evr_tpu_torch.models.layers import ACTIVATIONS, layer_norm, linear
from evr_tpu_torch.utils.tree import to_device

from .mesh import Mesh

Params = Any


def _sp_attention(ys: list[torch.Tensor], aps: list[Params], n_heads: int, causal: bool,
                  T_total: int) -> list[torch.Tensor]:
    """Token-sharded attention: ``ys[j]`` [B, t, W] is slot j's LN'd token
    shard and ``aps[j]`` its attention params; returns each slot's rows of
    the attention output (after the out projection)."""
    B, t, W = ys[0].shape
    d = W // n_heads
    qs, ks, vs = [], [], []
    for y, ap in zip(ys, aps):
        qkv = linear(y, ap["qkv"])
        qs.append(qkv[..., :W].reshape(B, t, n_heads, d))
        ks.append(qkv[..., W:2 * W].reshape(B, t, n_heads, d))
        vs.append(qkv[..., 2 * W:].reshape(B, t, n_heads, d))
    scale = 1.0 / math.sqrt(d)
    out = []
    for j, (q, ap) in enumerate(zip(qs, aps)):
        dev = q.device
        k_full = torch.cat([k.to(dev) for k in ks], dim=1)  # JAX's all_gather
        v_full = torch.cat([v.to(dev) for v in vs], dim=1)
        T_pad = k_full.shape[1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_full).float() * scale
        col = torch.arange(T_pad, device=dev)
        valid = col < T_total  # padded key columns never win softmax mass
        if causal:
            row_global = j * t + torch.arange(t, device=dev)
            mask = (valid[None, :] & (col[None, :] <= row_global[:, None]))[None, None]
        else:
            mask = valid[None, None, None, :]
        logits = torch.where(mask, logits, torch.tensor(-1e9, dtype=torch.float32, device=dev))
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v_full).reshape(B, t, W)
        out.append(linear(o, ap["out"]))
    return out


def sp_block_apply(xs: list[torch.Tensor], ps: list[Params], n_heads: int, causal: bool, T_total: int,
                   activation: str = "quick_gelu") -> list[torch.Tensor]:
    """One pre-LN residual block over the token shards ``xs`` (slot order),
    ``ps[j]`` the block's params on shard j's device: the contractions of
    ``layers.block_apply(attn_impl="xla")`` with the token rows
    distributed."""
    att = _sp_attention([layer_norm(x, p["ln_1"]) for x, p in zip(xs, ps)], [p["attn"] for p in ps],
                        n_heads, causal, T_total)
    out = []
    for x, a, p in zip(xs, att, ps):
        x = x + a
        h = ACTIVATIONS[activation](linear(layer_norm(x, p["ln_2"]), p["mlp"]["fc"]))
        out.append(x + linear(h, p["mlp"]["proj"]))
    return out


def _pad_tokens(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    T = x.shape[1]
    T_pad = -(-T // n_shards) * n_shards
    if T_pad != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, T_pad - T))
    return x


def _make_encode(mesh: Mesh, cfg: CLIPConfig, dtype, seq_axis: str, data_axis: str | None, tower: str):
    S = mesh.shape[seq_axis]
    leaders = mesh.leaders(data_axis) if data_axis else [mesh.local_slots[0]]
    groups = [mesh.group(g, seq_axis) for g in leaders]
    if tower == "visual":
        tcfg, causal = cfg.vision, False
        T_total = cfg.vision.grid * cfg.vision.grid + 1
    else:
        tcfg, causal = cfg.text, True
        T_total = cfg.text.context_length

    def encode(params, x):
        if x.shape[0] % len(groups):
            raise ValueError(f"{x.shape[0]} rows do not split over {len(groups)} data groups")
        b = x.shape[0] // len(groups)
        outs = []
        for gi, slots in enumerate(groups):
            devices = [mesh.slot_devices[s] for s in slots]
            on = {d: to_device(params, d) for d in dict.fromkeys(devices)}
            rows = x[gi * b:(gi + 1) * b].to(devices[0])
            if tower == "visual":
                h = vision_tokens(on[devices[0]], cfg, rows, dtype)
            else:
                h = text_tokens(on[devices[0]], cfg, rows.long(), dtype)
            h = _pad_tokens(h, S)
            t = h.shape[1] // S
            xs = [h[:, j * t:(j + 1) * t].to(devices[j]) for j in range(S)]
            for i in range(tcfg.layers):
                ps = [on[dev][tower]["blocks"][i] for dev in devices]
                xs = sp_block_apply(xs, ps, tcfg.heads, causal, T_total, cfg.activation)
            y = torch.cat([xj.to(devices[0]) for xj in xs], dim=1)[:, :T_total]
            if tower == "visual":
                outs.append(vision_pool(on[devices[0]], cfg, y, dtype))
            else:
                outs.append(text_pool(on[devices[0]], cfg, y, rows, dtype))
        return torch.cat([o.to(outs[0].device) for o in outs])

    return encode


def make_sp_image_encode(mesh: Mesh, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                         seq_axis: str = "seq", data_axis: str | None = None):
    """``(params, pixels) -> [B, embed_dim]`` with the vision block stack
    split by token over ``seq_axis`` (the batch over ``data_axis`` where
    given); equal to ``encode_image`` on the plain route."""
    return _make_encode(mesh, cfg, dtype, seq_axis, data_axis, "visual")


def make_sp_text_encode(mesh: Mesh, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                        seq_axis: str = "seq", data_axis: str | None = None):
    """``(params, tokens) -> [B, embed_dim]`` with the causal text block
    stack split by token over ``seq_axis``; equal to ``encode_text``."""
    return _make_encode(mesh, cfg, dtype, seq_axis, data_axis, "text")
