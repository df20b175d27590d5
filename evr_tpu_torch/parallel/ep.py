"""Expert parallelism for the MoE-CLIP towers (PyTorch).

Counterpart of ``evr_tpu/parallel/ep.py``. An MoE layer stores its experts
stacked on a leading dimension (``models.moe``), so the layout is a rule
over paths: every leaf of an ``fc`` or ``proj`` node under ``"moe"`` is
split on dimension 0 over the ``expert`` axis, and every other leaf (the
routers, the dense blocks, the embeddings) is replicated. Each slot stores
its shard (``parallel.fsdp.ShardedTensor``); under training the AdamW
moments and the EMA shard as their params.

Where the JAX package lets GSPMD insert the all-to-alls around the dispatch
and combine contractions, the port makes the exchange explicit: in a
step, a data slot's MoE layer hands each expert slot of its group the
dispatched tokens of that slot's experts, the slot runs its experts' MLPs
on its own shard of the weights, and the results come back to be combined
(``ExpertShards.exchange``). The gradient of each shard stays on the slot
that holds it until the step gathers the whole gradient for the update.
"""

from __future__ import annotations

from typing import Any

import torch

from evr_tpu_torch.utils.tree import iter_paths, map_with_paths

from .mesh import Mesh, Sharding

EXPERT_AXIS = "expert"


def is_expert_leaf(path) -> bool:
    """A leaf of an ``fc``/``proj`` node under ``"moe"``: the tensors
    ``models.moe.init_moe_mlp`` stacks on a leading expert dimension."""
    path = tuple(path)
    return "moe" in path and len(path) >= 2 and path[-2] in ("fc", "proj")


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()) or ())


def expert_spec(path, leaf, expert_axis: str = EXPERT_AXIS) -> tuple:
    if is_expert_leaf(path) and _ndim(leaf) >= 1:
        return (expert_axis,) + (None,) * (_ndim(leaf) - 1)
    return ()


def moe_param_shardings(mesh: Mesh, params: Any, expert_axis: str = EXPERT_AXIS) -> Any:
    """A tree of ``Sharding``s: expert-stacked leaves split on dimension 0
    over ``expert_axis``, everything else replicated."""
    return map_with_paths(params, lambda path, leaf: Sharding(mesh, expert_spec(path, leaf, expert_axis)))


def shard_moe_params(mesh: Mesh, params: Any, expert_axis: str = EXPERT_AXIS) -> Any:
    """``params`` placed on the mesh under the expert layout."""
    from .fsdp import shard_tree

    return shard_tree(params, moe_param_shardings(mesh, params, expert_axis))


def ep_state_shardings(params: Any, optimizer, mesh: Mesh, expert_axis: str = EXPERT_AXIS,
                       ema: bool = False):
    """The shardings of a whole ``TrainState`` under expert parallelism: the
    params' (``moe_param_shardings``), the optimizer state's (a moment or
    accumulated gradient keyed by an expert leaf's path splits as that leaf;
    counts and flags are replicated; planned over meta tensors) and the
    EMA's (as the params)."""
    from evr_tpu_torch.training.finetune import TrainState

    param_sh = moe_param_shardings(mesh, params, expert_axis)
    by_key = {"/".join(p): sh for p, sh in iter_paths(param_sh)}
    meta = map_with_paths(params, lambda _, t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"))
    rep = Sharding(mesh, ())

    def opt_sharding(path, leaf):
        sh = by_key.get(path[-1]) if path else None
        return sh if sh is not None and _ndim(leaf) else rep

    opt_sh = map_with_paths(optimizer.init(meta), opt_sharding)
    return TrainState(params=param_sh, opt_state=opt_sh, step=rep, ema_params=param_sh if ema else None)


class ExpertShards:
    """One expert leaf as a step reads it on a data slot: the shards of the
    slots of its expert group (``Mesh.group(slot, "expert")``), each a
    detached alias on its slot's device, in expert order."""

    def __init__(self, shards: list[torch.Tensor]):
        self.shards = shards

    @staticmethod
    def exchange(xin: torch.Tensor, p: dict, fn) -> torch.Tensor:
        """The expert half of an MoE layer over the slots: ``xin`` [G, E, C,
        W] (the dispatched tokens, on the data slot) is cut by expert into
        the groups each slot holds, each group sent to its slot, ``fn(part,
        slot's params)`` run there, and the results brought back and joined
        in expert order (the combine's input). Differentiable: the
        gradients of each shard land on its slot."""
        leaves = {(a, b): p[a][b] for a in ("fc", "proj") for b in ("kernel", "bias")}
        outs, lo = [], 0
        for j, kernel in enumerate(p["fc"]["kernel"].shards):
            per = kernel.shape[0]
            part = xin[:, lo:lo + per].to(kernel.device)
            q = {a: {b: leaves[(a, b)].shards[j] for b in ("kernel", "bias")} for a in ("fc", "proj")}
            outs.append(fn(part, q).to(xin.device))
            lo += per
        return torch.cat(outs, dim=1)

    def __repr__(self) -> str:
        return f"ExpertShards({[tuple(t.shape) for t in self.shards]})"


def expert_aliases(leaf, slot: int, requires_grad: bool) -> ExpertShards:
    """``leaf`` (a ``ShardedTensor`` split over the expert axis) as data slot
    ``slot`` reads it: the shards of its expert group, detached, each
    requiring grad as asked."""
    mesh = leaf.sharding.mesh
    local = mesh.local_slots
    group = mesh.group(slot, leaf.sharding.axis)
    return ExpertShards([leaf.shards[local.index(s)].detach().requires_grad_(requires_grad) for s in group])


def input_parts(leaf) -> list[torch.Tensor]:
    """The tensors a step differentiates for one leaf."""
    return list(leaf.shards) if isinstance(leaf, ExpertShards) else [leaf]


def whole_grad(leaf, grads: list, device) -> torch.Tensor:
    """The whole gradient of ``leaf`` on ``device`` from the gradients of its
    ``input_parts`` (None: zeros): an expert leaf's shards joined on
    dimension 0."""
    parts = [torch.zeros_like(t) if g is None else g for t, g in zip(input_parts(leaf), grads)]
    if isinstance(leaf, ExpertShards):
        return torch.cat([g.to(device) for g in parts], dim=0)
    return parts[0]
