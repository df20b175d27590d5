"""Checkpoints of sharded trees, written shard by shard (PyTorch).

Counterpart of ``evr_tpu/training/sharded_ckpt.py`` for every layout of
``parallel.fsdp.ShardedTensor`` leaves: data-parallel and FSDP trees,
tensor-parallel ones (``parallel.tp.clip_param_shardings``: columns or rows
split over ``model``) and stage-stacked ones (``parallel.pp.stage_params``:
the layer axis split over ``stage``). Orbax needs JAX, so the port's format
is its own: a checkpoint is a directory holding

- ``slot-<n>.pt``: a dict path → tensor of shard n of every split leaf
  (written once, by the process owning the first slot that holds it; on a
  one-axis mesh shard n is slot n's);
- ``replicated.pt``: the leaves that are whole (plain tensors and replicated
  ``ShardedTensor``s), written by the coordinator;
- ``index.json``: for every leaf its path, shape, dtype, split dimension and
  shard count, or its value for a Python scalar (counts, flags).

``restore_sharded`` rebuilds each leaf for a target of any size: a tree of
``parallel.mesh.Sharding``s (shapes and dtypes from the index) or a template
tree (a ``ShardedTensor`` leaf gives its sharding, a tensor its device). The
files are memory-mapped, so a slot reads the saved shards that overlap its
own slice. An overwrite writes ``<path>.tmp`` in full, then removes the old
checkpoint and renames; a crash in that window leaves the complete ``.tmp``,
which ``restore_sharded`` falls back to. A checkpoint is topology-free:
saved over ``model`` 2, it restores whole, replicated, or over ``model`` 4.
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any

import torch

from evr_tpu_torch.parallel import multihost
from evr_tpu_torch.parallel.fsdp import ShardedTensor
from evr_tpu_torch.parallel.mesh import Sharding

from .partition import iter_paths, map_with_paths

INDEX = "index.json"
REPLICATED = "replicated.pt"


def _key(path) -> str:
    return "/".join(path)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


def _describe(leaf) -> dict:
    if isinstance(leaf, ShardedTensor):
        sh = leaf.sharding
        return {"shape": list(leaf.shape), "dtype": str(leaf.dtype), "dim": sh.dim, "shards": sh.n_shards}
    if isinstance(leaf, torch.Tensor):
        return {"shape": list(leaf.shape), "dtype": str(leaf.dtype), "dim": None, "shards": 1}
    return {"value": leaf}


def save_sharded(path, tree: Any) -> None:
    """Write ``tree`` (``ShardedTensor``s, tensors, Python scalars in nested
    dicts and lists) without gathering it: each process writes the shards
    of its own slots. Every process calls it."""
    path = pathlib.Path(path).absolute()
    tmp = path.with_name(path.name + ".tmp")
    if multihost.is_coordinator():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    multihost.barrier("evr-sharded-save-start")
    index, replicated, per_slot = {}, {}, {}
    for p, leaf in iter_paths(tree):
        key = _key(p)
        index[key] = _describe(leaf)
        if isinstance(leaf, ShardedTensor) and leaf.sharding.dim is not None:
            sh = leaf.sharding
            first = {}  # shard → the first global slot holding it
            for t in range(sh.mesh.size):
                first.setdefault(sh.shard_index(t), t)
            for i, s in enumerate(sh.mesh.local_slots):
                j = sh.shard_index(s)
                if first[j] == s:
                    per_slot.setdefault(j, {})[key] = leaf.shards[i].detach().cpu()
        elif isinstance(leaf, ShardedTensor):
            replicated[key] = leaf.shards[0].detach().cpu()
        elif isinstance(leaf, torch.Tensor):
            replicated[key] = leaf.detach().cpu()
    for s, shards in per_slot.items():
        torch.save(shards, tmp / f"slot-{s}.pt")
    if multihost.is_coordinator():
        torch.save(replicated, tmp / REPLICATED)
        (tmp / INDEX).write_text(json.dumps(index))
    multihost.barrier("evr-sharded-save-written")
    if multihost.is_coordinator():
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
    multihost.barrier("evr-sharded-save-done")


class _Reader:
    def __init__(self, path: pathlib.Path):
        self.path = path
        self.index = json.loads((path / INDEX).read_text())
        self._files: dict[str, dict] = {}

    def _file(self, name: str) -> dict:
        if name not in self._files:
            self._files[name] = torch.load(self.path / name, mmap=True, weights_only=True)
        return self._files[name]

    def slice(self, key: str, dim: int | None, lo: int, hi: int) -> torch.Tensor:
        """Rows ``[lo, hi)`` of ``dim`` of the saved leaf (all of it for
        ``dim`` None), read from the saved shards that overlap them."""
        meta = self.index[key]
        if meta["shards"] == 1:
            whole = self._file(REPLICATED)[key]
            return whole if dim is None else whole.narrow(dim, lo, hi - lo)
        sd = meta["dim"]
        per = meta["shape"][sd] // meta["shards"]
        if dim is None:
            dim, lo, hi = sd, 0, meta["shape"][sd]
        if dim != sd:
            whole = torch.cat([self._file(f"slot-{s}.pt")[key] for s in range(meta["shards"])], dim=sd)
            return whole.narrow(dim, lo, hi - lo)
        parts = []
        for s in range(lo // per, -(-hi // per)):
            a, b = max(lo, s * per), min(hi, (s + 1) * per)
            parts.append(self._file(f"slot-{s}.pt")[key].narrow(sd, a - s * per, b - a))
        return torch.cat(parts, dim=sd)


def _resolve(path) -> pathlib.Path:
    path = pathlib.Path(path).absolute()
    if not path.exists():
        tmp = path.with_name(path.name + ".tmp")
        if (tmp / INDEX).exists():  # a crash in save_sharded's swap window
            return tmp
    return path


def restore_sharded(path, target: Any) -> Any:
    """The saved tree laid out as ``target`` says: a ``Sharding`` leaf gives
    a ``ShardedTensor`` over its mesh (this process's slots read their
    slices), a ``ShardedTensor`` leaf its own sharding, a tensor leaf a whole
    tensor on its device; any other leaf takes the saved value."""
    reader = _Reader(_resolve(path))

    def restore(p, tgt):
        key = _key(p)
        meta = reader.index[key]
        if "value" in meta:
            return meta["value"]
        sharding = tgt if isinstance(tgt, Sharding) else getattr(tgt, "sharding", None)
        dtype = _dtype(meta["dtype"])
        if sharding is None:
            device = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
            return reader.slice(key, None, 0, 0).to(device=device, dtype=dtype).clone()
        d = sharding.dim
        devices = sharding.mesh.slot_devices
        shards = []
        for s in sharding.mesh.local_slots:
            if d is None:
                part = reader.slice(key, None, 0, 0)
            else:
                per = meta["shape"][d] // sharding.n_shards
                j = sharding.shard_index(s)
                part = reader.slice(key, d, j * per, (j + 1) * per)
            shards.append(part.to(device=devices[s], dtype=dtype).clone())
        return ShardedTensor(shards, sharding, tuple(meta["shape"]))

    return map_with_paths(target, restore)


def save_train_state_sharded(path, params: Any, opt_state: Any, step) -> None:
    """params, optimizer state and step in ``params/``, ``opt/`` and
    ``step/`` under ``path``: the moments shard as their params do."""
    path = pathlib.Path(path)
    save_sharded(path / "params", params)
    save_sharded(path / "opt", opt_state)
    save_sharded(path / "step", {"step": int(step)})


def restore_train_state_sharded(path, params_target: Any, opt_target: Any) -> tuple[Any, Any, int]:
    path = pathlib.Path(path)
    params = restore_sharded(path / "params", params_target)
    opt_state = restore_sharded(path / "opt", opt_target)
    step = restore_sharded(path / "step", {"step": 0})["step"]
    return params, opt_state, step
