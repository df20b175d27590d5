"""Tensor parallelism for the CLIP towers: weight columns and rows split over
a ``model`` mesh axis (PyTorch).

Counterpart of ``evr_tpu/parallel/tp.py``. ``clip_param_shardings`` follows
the JAX rule leaf for leaf: the ``qkv`` and ``fc`` kernels are split by
column (``(None, model)``) and their biases with them (``(model,)``), the
``out`` and ``proj`` kernels by row (``(model, None)``), and every other leaf
is replicated. Each slot of the model axis stores its shard
(``parallel.fsdp.ShardedTensor``).

The JAX package lets GSPMD partition the towers around its Pallas kernels,
and GSPMD hands a ``pallas_call`` whole operands. The port does the same
explicitly: where a block runs, its shards are gathered over the model axis
into whole weights, for that block only (``LazyBlocks``), and the block runs
as it does on one device (K1/K2 forward and K5 backward where the route
takes the kernels, the plain composition otherwise). The gradient of a
gathered weight is the whole gradient; each slot updates its own shard of it
(``training.finetune``'s sharded update, with the whole gradients' clip and
finite decisions).

The column split is of the fused ``[W, 3W]`` qkv kernel, so at two slots
slot 0 holds q and half of k: the shards do not fall on head boundaries,
and no slot can run attention on its shard alone. That is why blocks gather.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import torch

from evr_tpu_torch.utils.tree import iter_paths, map_with_paths

from .ep import EXPERT_AXIS, expert_aliases
from .fsdp import ShardedTensor
from .mesh import Mesh, Sharding

COLUMN = ("attn/qkv/kernel", "mlp/fc/kernel")
COLUMN_BIAS = ("attn/qkv/bias", "mlp/fc/bias")
ROW = ("attn/out/kernel", "mlp/proj/kernel")


def _ndim(leaf) -> int:
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return len(leaf.shape)
    return getattr(leaf, "ndim", 0)


def tp_spec(path, leaf, model_axis: str = "model") -> tuple:
    """One leaf's spec under JAX's rule (``evr_tpu/parallel/tp.py:18-40``)."""
    if _ndim(leaf) == 0:
        return ()
    joined = "/".join(path)
    if joined.endswith(COLUMN):
        return (None, model_axis)
    if joined.endswith(COLUMN_BIAS):
        return (model_axis,)
    if joined.endswith(ROW):
        return (model_axis, None)
    return ()


def clip_param_shardings(mesh: Mesh, params: Any, model_axis: str = "model") -> Any:
    """A tree of ``Sharding``s for ``params`` (a CLIP tree, or ``{"clip":
    ..., "classifier": ...}``)."""
    return map_with_paths(params, lambda path, leaf: Sharding(mesh, tp_spec(path, leaf, model_axis)))


def tp_state_shardings(params: Any, optimizer, mesh: Mesh, model_axis: str = "model", ema: bool = False):
    """The shardings of a whole ``TrainState`` under tensor parallelism: the
    params' (``clip_param_shardings``), the optimizer state's (each moment,
    momentum or accumulated gradient keyed by a param's path takes that
    param's sharding; counts and flags are replicated) and the EMA's."""
    from evr_tpu_torch.training.finetune import TrainState

    param_sh = clip_param_shardings(mesh, params, model_axis)
    by_key = {"/".join(p): sh for p, sh in iter_paths(param_sh)}
    meta = map_with_paths(params, lambda _, t: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta"))
    rep = Sharding(mesh, ())

    def opt_sharding(path, leaf):
        sh = by_key.get(path[-1]) if path else None
        return sh if sh is not None and _ndim(leaf) else rep

    opt_sh = map_with_paths(optimizer.init(meta), opt_sharding)
    return TrainState(params=param_sh, opt_state=opt_sh, step=rep, ema_params=param_sh if ema else None)


def splits_over(tree: Any, axis) -> bool:
    """Whether any ``ShardedTensor`` leaf of ``tree`` is split over an axis
    other than ``axis`` (the model or stage axis, not the data axis)."""
    for _, leaf in iter_paths(tree):
        sh = getattr(leaf, "sharding", None)
        if isinstance(leaf, ShardedTensor) and sh.dim is not None and sh.axis != axis:
            return True
    return False


def lazy_tree(tree: Any, device, axis) -> Any:
    """``tree`` for one device's step: leaves split over ``axis`` (FSDP's)
    and replicated ones gathered whole on ``device``; leaves split over
    another axis (the model axis) left as ``ShardedTensor``s, gathered block
    by block where the block runs (``lazy_aliases``)."""

    def one(_, leaf):
        if not isinstance(leaf, ShardedTensor):
            return leaf
        sh = leaf.sharding
        if sh.dim is not None and sh.axis != axis:
            return leaf
        return leaf.full(device)

    return map_with_paths(tree, one)


class LazyBlocks(Sequence):
    """A tower's block list whose block ``i`` is built when the tower reaches
    it: its split leaves gathered whole on ``device`` (detached, requiring
    grad as ``requires_grad(key)`` says) and entered in ``registry`` under
    their path keys, so the step can differentiate them afterwards. Each
    block is built once. A leaf split over the expert axis is not gathered:
    data slot ``slot`` reads it as the shards of its expert group
    (``parallel.ep.ExpertShards``), and the MoE layer sends them tokens."""

    def __init__(self, blocks: list, prefix: str, device, requires_grad, registry: dict, slot=None):
        self._blocks = blocks
        self._prefix = prefix
        self._device = device
        self._requires_grad = requires_grad
        self._registry = registry
        self._slot = slot
        self._built: dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self._blocks)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = range(len(self))[i]
        if i not in self._built:
            def build(path, leaf):
                key = f"{self._prefix}/{i}/" + "/".join(path)
                if (isinstance(leaf, ShardedTensor) and leaf.sharding.axis == EXPERT_AXIS
                        and self._slot is not None):
                    t = expert_aliases(leaf, self._slot, self._requires_grad(key))
                    self._registry[key] = t
                    return t
                t = leaf.full(self._device) if isinstance(leaf, ShardedTensor) else leaf.to(self._device)
                t = t.detach().requires_grad_(self._requires_grad(key))
                self._registry[key] = t
                return t

            self._built[i] = map_with_paths(self._blocks[i], build)
        return self._built[i]


def lazy_aliases(tree: Any, device, requires_grad, slot=None) -> tuple[Any, dict]:
    """(the tree data slot ``slot``'s step reads, the registry of its leaves
    by path key). Whole leaves become detached aliases at once; every tower
    whose blocks hold ``ShardedTensor`` leaves gets ``LazyBlocks``, whose
    leaves enter the registry as the forward reaches them."""
    registry: dict[str, torch.Tensor] = {}

    def walk(node, prefix: tuple):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                path = prefix + (str(k),)
                if k == "blocks" and isinstance(v, (list, tuple)) and any(
                        isinstance(leaf, ShardedTensor) for _, leaf in iter_paths(v)):
                    out[k] = LazyBlocks(list(v), "/".join(path), device, requires_grad, registry, slot)
                else:
                    out[k] = walk(v, path)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, prefix + (str(i),)) for i, v in enumerate(node)]
        key = "/".join(prefix)
        t = node.full(device) if isinstance(node, ShardedTensor) else node
        t = t.detach().requires_grad_(requires_grad(key))
        registry[key] = t
        return t

    return walk(tree, ()), registry
