"""Params and optimizer state sharded over a mesh's slots (PyTorch).

Counterpart of ``evr_tpu/parallel/fsdp.py`` (ZeRO-3 style): each large leaf
is split over the ``data`` axis along its largest divisible dimension, and
leaves under ``min_size`` elements stay replicated. Where the JAX package
annotates shardings and lets XLA insert the gathers and reduce-scatters, the
port holds the shards itself: a ``ShardedTensor`` keeps one tensor a local
slot (its shard, or a full copy of a replicated leaf), and the trainer's mesh
step (``training.finetune.make_train_step(..., state_shardings=...)``)
gathers the whole tree once per distinct device for the forward, reduces the
gradients over the slots in slot order and hands each slot its shard of them,
and updates each slot's shard of the params and the AdamW moments there.

FSDP changes the layout, not the arithmetic: a step equals the data-parallel
step on the same global batch, which equals the one-device step up to the
order of the slot sums.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from . import multihost
from .mesh import Mesh, Sharding

# Leaves smaller than this many elements stay replicated: a [3] bias or a
# scalar logit_scale costs more in collective latency than it saves in memory.
DEFAULT_MIN_SIZE = 2**14


def fsdp_spec(shape: tuple[int, ...], axis: str, n_shards: int, min_size: int = DEFAULT_MIN_SIZE) -> tuple:
    """The spec of one leaf: ``axis`` on the largest dimension that divides
    by ``n_shards`` (ties: the trailing one); ``()`` (replicated) for a small
    leaf or one with no divisible dimension."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % n_shards == 0 and d > 1 and (best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    return tuple(axis if i == best else None for i in range(len(shape)))


def _is_array(leaf) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _map2(tree, other, fn):
    if isinstance(tree, dict):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(v, o, fn) for v, o in zip(tree, other)]
    return fn(tree, other)


def fsdp_shardings(tree: Any, mesh: Mesh, axis: str = "data", min_size: int = DEFAULT_MIN_SIZE) -> Any:
    """Every array leaf (tensor, numpy array or meta tensor) mapped to its
    ``Sharding``; other leaves (counts, flags) to a replicated one."""
    n = mesh.axis_size(axis)

    def to_sharding(leaf):
        shape = tuple(leaf.shape) if _is_array(leaf) else ()
        return Sharding(mesh, fsdp_spec(shape, axis, n, min_size))

    return _map(tree, to_sharding)


def fsdp_state_shardings(params: Any, optimizer, mesh: Mesh, axis: str = "data",
                         min_size: int = DEFAULT_MIN_SIZE, ema: bool = False):
    """The shardings of a whole ``TrainState``: the params', the optimizer
    state's (its leaves' shapes from ``optimizer.init`` over meta tensors, so
    planning allocates nothing: the moments shard as their params do) and
    the EMA's (as the params)."""
    from evr_tpu_torch.training.finetune import TrainState

    param_sh = fsdp_shardings(params, mesh, axis, min_size)
    meta = _map(params, lambda t: torch.empty(tuple(t.shape), dtype=_torch_dtype(t), device="meta"))
    opt_sh = fsdp_shardings(optimizer.init(meta), mesh, axis, min_size)
    return TrainState(params=param_sh, opt_state=opt_sh, step=Sharding(mesh, ()),
                      ema_params=param_sh if ema else None)


def _torch_dtype(t) -> torch.dtype:
    if isinstance(t, torch.Tensor):
        return t.dtype
    return torch.from_numpy(t.reshape(-1)[:0].copy()).dtype


class ShardedTensor:
    """A global tensor laid out over a mesh: ``shards[i]`` is local slot i's
    part (slot order), on that slot's device; a replicated leaf keeps a full
    copy in every slot."""

    def __init__(self, shards: list[torch.Tensor], sharding: Sharding, shape: tuple[int, ...]):
        self.shards = shards
        self.sharding = sharding
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's),
        gathered in shard order (across processes too): one slot of each
        shard, the first local slot that holds it."""
        device = self.shards[0].device if device is None else device
        d = self.sharding.dim
        if d is None:
            return self.shards[0].to(device)
        pick: dict[int, torch.Tensor] = {}
        for i, s in enumerate(self.sharding.mesh.local_slots):
            pick.setdefault(self.sharding.shard_index(s), self.shards[i])
        local = torch.cat([pick[j].to(device) for j in sorted(pick)], dim=d)
        return torch.cat(multihost.all_gather(local), dim=d)

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, spec={self.sharding.spec}, slots={len(self.shards)})"


def shard_of(t: torch.Tensor, sharding: Sharding, slot: int) -> torch.Tensor:
    """Global slot ``slot``'s part of the whole tensor ``t`` (a view): its
    shard along the split axis, the whole tensor where it is replicated."""
    d = sharding.dim
    if d is None:
        return t
    per = t.shape[d] // sharding.n_shards
    return t.narrow(d, sharding.shard_index(slot) * per, per)


def shard_tensor(t, sharding: Sharding) -> ShardedTensor:
    """``t`` (tensor or numpy array) placed as ``sharding`` says: each local
    slot gets a fresh copy of its part on its device."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    devices = sharding.mesh.slot_devices
    shards = [shard_of(t, sharding, s).to(devices[s]).clone() for s in sharding.mesh.local_slots]
    return ShardedTensor(shards, sharding, tuple(t.shape))


def shard_tree(tree: Any, shardings: Any) -> Any:
    """``tree`` placed on the mesh: every array leaf becomes a
    ``ShardedTensor`` (each slot gets only its slice of a large leaf); other
    leaves stay as they are."""
    return _map2(tree, shardings, lambda leaf, sh: shard_tensor(leaf, sh) if _is_array(leaf) else leaf)


def gather_tree(tree: Any, device=None) -> Any:
    """The whole tree: every ``ShardedTensor`` gathered onto ``device``."""
    return _map(tree, lambda leaf: leaf.full(device) if isinstance(leaf, ShardedTensor) else leaf)


def slot_view(tree: Any, i: int) -> Any:
    """Local slot i's tree: each ``ShardedTensor`` replaced by its shard."""
    return _map(tree, lambda leaf: leaf.shards[i] if isinstance(leaf, ShardedTensor) else leaf)


def write_back(tree: Any, view: Any, i: int) -> Any:
    """``tree`` with slot i's shards taken from ``view`` (what an update of
    ``slot_view(tree, i)`` rebound) and every other leaf from ``view``."""
    if isinstance(tree, dict):
        return {k: write_back(v, view[k], i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [write_back(v, w, i) for v, w in zip(tree, view)]
    if isinstance(tree, ShardedTensor):
        tree.shards[i] = view
        return tree
    return view


def sharded_bytes_per_device(tree: Any) -> int:
    """Bytes of ``tree`` held by the first slot: the number FSDP shrinks."""
    total = 0

    def count(leaf):
        nonlocal total
        if isinstance(leaf, ShardedTensor):
            total += leaf.shards[0].numel() * leaf.shards[0].element_size()
        return leaf

    _map(tree, count)
    return total
