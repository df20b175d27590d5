"""GPipe pipeline parallelism for the CLIP towers (PyTorch).

Counterpart of ``evr_tpu/parallel/pp.py``. The block stack is split into S
contiguous stages over a ``stage`` mesh axis; microbatches stream through the
stages in the GPipe schedule of M + S − 1 steps (M microbatches): at step t
stage i applies its L/S blocks to microbatch t − i.

- Block params are stacked along a leading layer axis (``stack_blocks``) and
  split over ``stage`` (``stage_shardings``, ``stage_params``): each stage's
  slot holds its L/S blocks. The stem and pool params stay whole.
- One controller runs every slot: where the JAX runner shifts activations
  with ``ppermute``, the port hands stage i's output to stage i + 1's device
  in schedule order; where it zero-masks the other stages' outputs and
  ``psum``s them, the port takes the last stage's outputs, which is exact.
- Stage i applies its blocks through ``layers.block_apply(...,
  cfg.attn_impl)``, so ``"auto"`` reaches the fused kernels K1/K2 on bf16 and
  fp32 params and K3a/K3b on int8 params, as the JAX runner's blocks do.
- Autograd runs through the schedule: the gradient of a stage's blocks
  reaches the params it was stacked from.
- With ``data_axis`` the batch splits over the data groups
  (``Mesh.leaders``); each group runs its own pipeline over its stage slots.
"""

from __future__ import annotations

from typing import Any

import torch

from evr_tpu_torch.models.clip import CLIPConfig, text_pool, text_tokens, vision_pool, vision_tokens
from evr_tpu_torch.models.layers import block_apply
from evr_tpu_torch.utils.tree import to_device, tree_map

from .fsdp import ShardedTensor, shard_tree
from .mesh import Mesh, Sharding

Params = Any


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def stack_blocks(blocks: list[Params]) -> Params:
    """Per-block param trees → one tree with a leading [L] axis (every CLIP
    block has the same shapes)."""
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def unstack_blocks(stacked: Params) -> list[Params]:
    """The inverse of ``stack_blocks``: views into the stacked leaves."""
    n = _first_leaf(stacked).shape[0]
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def stage_shardings(mesh: Mesh, stacked: Params, stage_axis: str = "stage") -> Params:
    """Each stacked leaf's layer axis split over ``stage_axis``."""
    return tree_map(lambda _: Sharding(mesh, (stage_axis,)), stacked)


def _check_stages(n_layers: int, n_stages: int) -> None:
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} blocks do not split evenly over {n_stages} stages")


def _microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    B = x.shape[0]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])


def pipeline_blocks(
    x_mb: torch.Tensor,
    stage_blocks: list[list[Params]],
    stage_devices: list[torch.device],
    heads: int,
    causal: bool = False,
    attn_impl: str = "xla",
    activation: str = "quick_gelu",
) -> torch.Tensor:
    """Microbatches [M, mb, T, W] through the staged block stack: stage i's
    blocks ``stage_blocks[i]`` on ``stage_devices[i]``. The GPipe schedule:
    at step t (of M + S − 1) every stage with a microbatch applies its
    blocks, then hands its output to the next stage's device; the last
    stage's outputs are the result [M, mb, T, W] on its device."""
    S, M = len(stage_blocks), x_mb.shape[0]
    inbox: list = [None] * S
    out: list = [None] * M
    for t in range(M + S - 1):
        handed: list = [None] * S
        for i in range(S):
            m = t - i
            if not 0 <= m < M:
                continue
            y = x_mb[m].to(stage_devices[0]) if i == 0 else inbox[i]
            for bp in stage_blocks[i]:
                y = block_apply(y, bp, heads, causal, attn_impl, activation)
            if i == S - 1:
                out[m] = y
            else:
                handed[i + 1] = y.to(stage_devices[i + 1])  # JAX's ppermute
        inbox = handed
    return torch.stack(out)


def split_vision_params(params: Params) -> tuple[Params, Params]:
    """(the params with the vision blocks emptied, the stacked vision
    blocks)."""
    rest = dict(params)
    visual = dict(params["visual"])
    stacked = stack_blocks(visual["blocks"])
    visual["blocks"] = ()
    rest["visual"] = visual
    return rest, stacked


def split_text_params(params: Params) -> tuple[Params, Params]:
    rest = dict(params)
    text = dict(params["text"])
    stacked = stack_blocks(text["blocks"])
    text["blocks"] = ()
    rest["text"] = text
    return rest, stacked


def stage_params(mesh: Mesh, params: Params, stage_axis: str = "stage"):
    """A CLIP params tree placed for pipelined runs: both towers' blocks
    stacked and split over ``stage_axis`` (``ShardedTensor`` leaves, each
    stage slot holding its L/S blocks), everything else as it is. Returns
    (rest, vision_stacked, text_stacked) for the ``presplit`` encoders."""
    rest, v_stacked = split_vision_params(params)
    rest, t_stacked = split_text_params(rest)
    v_stacked = shard_tree(v_stacked, stage_shardings(mesh, v_stacked, stage_axis))
    t_stacked = shard_tree(t_stacked, stage_shardings(mesh, t_stacked, stage_axis))
    return rest, v_stacked, t_stacked


class _StageRunner:
    """The slots a pipelined encode runs on and each stage slot's unstacked
    blocks (kept while the stacked shards are the same tensors, so a block's
    weights stay the same tensor objects across calls and the int8 kernels'
    K-major copies are made once)."""

    def __init__(self, mesh: Mesh, stage_axis: str, data_axis: str | None):
        self.mesh, self.stage_axis, self.data_axis = mesh, stage_axis, data_axis
        leaders = mesh.leaders(data_axis) if data_axis else [mesh.local_slots[0]]
        self.groups = [mesh.group(g, stage_axis) for g in leaders]
        self._cache: dict[int, tuple] = {}

    def blocks(self, stacked: Params, slot: int, cache: bool) -> list[Params]:
        pos = self.mesh.local_slots.index(slot)
        local = tree_map(lambda st: st.shards[pos] if isinstance(st, ShardedTensor) else st, stacked)
        key = _first_leaf(local)
        hit = self._cache.get(slot)
        if cache and hit is not None and hit[0] is key:
            return hit[1]
        blocks = unstack_blocks(local)
        if cache:
            self._cache[slot] = (key, blocks)
        return blocks

    def run(self, rest, stacked, x, stem, pool, heads: int, causal: bool, cfg: CLIPConfig,
            n_micro: int, cache: bool) -> torch.Tensor:
        if x.shape[0] % len(self.groups):
            raise ValueError(f"{x.shape[0]} rows do not split over {len(self.groups)} data groups")
        b = x.shape[0] // len(self.groups)
        outs = []
        for gi, slots in enumerate(self.groups):
            devices = [self.mesh.slot_devices[s] for s in slots]
            rows = x[gi * b:(gi + 1) * b]
            h = stem(to_device(rest, devices[0]), rows.to(devices[0]))
            y = pipeline_blocks(_microbatch(h, n_micro), [self.blocks(stacked, s, cache) for s in slots],
                                devices, heads, causal, cfg.attn_impl, cfg.activation)
            outs.append(pool(to_device(rest, devices[-1]), y.reshape(h.shape), rows))
        return torch.cat([o.to(outs[0].device) for o in outs])


def _make_encode(mesh, cfg, n_micro, dtype, stage_axis, data_axis, presplit, tower: str):
    tcfg = cfg.vision if tower == "visual" else cfg.text
    _check_stages(tcfg.layers, mesh.shape[stage_axis])
    runner = _StageRunner(mesh, stage_axis, data_axis)
    if tower == "visual":
        stem = lambda rest, px: vision_tokens(rest, cfg, px, dtype)  # noqa: E731
        pool = lambda rest, y, px: vision_pool(rest, cfg, y, dtype)  # noqa: E731
        split = split_vision_params
    else:
        stem = lambda rest, tok: text_tokens(rest, cfg, tok.long(), dtype)  # noqa: E731
        pool = lambda rest, y, tok: text_pool(rest, cfg, y, tok.to(y.device), dtype)  # noqa: E731
        split = split_text_params

    def mapped(rest, stacked, x, cache):
        return runner.run(rest, stacked, x, stem, pool, tcfg.heads, tower == "text", cfg, n_micro, cache)

    if presplit:
        return lambda rest, stacked, x: mapped(rest, stacked, x, True)

    def encode(params, x):
        rest, stacked = split(params)
        return mapped(rest, shard_tree(stacked, stage_shardings(mesh, stacked, stage_axis)), x, False)

    return encode


def make_pipelined_image_encode(
    mesh: Mesh,
    cfg: CLIPConfig,
    n_micro: int,
    dtype: torch.dtype = torch.float32,
    stage_axis: str = "stage",
    data_axis: str | None = None,
    presplit: bool = False,
):
    """The pipelined vision encode over ``stage_axis`` (the batch split over
    ``data_axis`` where given). ``presplit=False``: ``(params, pixels) ->
    [B, embed_dim]`` from the usual CLIP tree, the blocks stacked and placed
    on every call (one-shots and gradients). ``presplit=True``: ``(rest,
    stacked, pixels) -> ...`` from ``stage_params`` / ``split_vision_params``
    placed once (the serving shape)."""
    return _make_encode(mesh, cfg, n_micro, dtype, stage_axis, data_axis, presplit, "visual")


def make_pipelined_text_encode(
    mesh: Mesh,
    cfg: CLIPConfig,
    n_micro: int,
    dtype: torch.dtype = torch.float32,
    stage_axis: str = "stage",
    data_axis: str | None = None,
    presplit: bool = False,
):
    """The pipelined causal text encode; ``(params, tokens) -> [B,
    embed_dim]``, or with ``presplit`` ``(rest, stacked, tokens) -> ...``
    (see ``make_pipelined_image_encode``)."""
    return _make_encode(mesh, cfg, n_micro, dtype, stage_axis, data_axis, presplit, "text")
