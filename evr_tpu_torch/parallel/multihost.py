"""Multi-process bootstrap and the collectives between processes (PyTorch).

Counterpart of ``evr_tpu/parallel/multihost.py``. One process drives its own
slots (``parallel.mesh``); several processes join through
``torch.distributed``, read from the same environment contract as the JAX
package's:

- ``EVR_TPU_COORDINATOR`` (``host:port``), ``EVR_TPU_NUM_PROCESSES`` and
  ``EVR_TPU_PROCESS_ID``, which ``tools.pod_launch`` sets for each worker;
- ``EVR_TPU_CPU_DEVICES``: the CPU slots each process's mesh takes.

The backend follows the device the process computes on (``bootstrap(device=)``):
Gloo on the CPU, NCCL when every process has a card of its own, and Gloo
when processes share a card (NCCL refuses two ranks on one device). A
process on the card takes ``cuda:(process id mod cards)``, one slot.

Sums go through ``all_reduce`` and the coordinator's tree through
``broadcast``; rows that are joined (``gather_rows``, FSDP shards, top-k
lists) through ``all_gather`` in rank order. Every process gets the same
bits. Under Gloo a CUDA tensor is staged through a host copy.
``gather_rows`` is differentiable: its backward sums the incoming gradients
over the processes and keeps this process's rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, cpu_device_count


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def default_backend(num_processes: int, device=None) -> str:
    """``gloo`` for a process on the CPU or on a card it shares, ``nccl``
    when each process has a card of its own (``device`` None = the card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to join on the CPU")
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def bootstrap(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> tuple[int, int]:
    """Join the process group. Returns ``(process_index, process_count)``.

    Explicit arguments win, then the ``EVR_TPU_*`` variables; with no
    coordinator named anywhere this is a single-process no-op. ``device``
    is what the process computes on (None = the card; ``"cpu"``), which
    picks the backend (``default_backend``). Idempotent."""
    if _initialized():
        return process_index(), process_count()
    coordinator_address = coordinator_address or os.environ.get("EVR_TPU_COORDINATOR")
    if coordinator_address is None:
        return 0, 1
    if num_processes is None:
        num_processes = int(os.environ["EVR_TPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["EVR_TPU_PROCESS_ID"])
    backend = default_backend(num_processes, device)
    if device is None or torch.device(device).type != "cpu":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return process_index(), process_count()


def backend() -> str | None:
    return dist.get_backend() if _initialized() else None


def is_coordinator() -> bool:
    return process_index() == 0


def local_slot_devices(device=None) -> list[torch.device]:
    """This process's slots: ``EVR_TPU_CPU_DEVICES`` CPU slots (or 1) with
    ``device="cpu"``, else its one card."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * cpu_device_count()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for CPU slots")
    return [torch.device("cuda", process_index() % torch.cuda.device_count())]


def global_mesh(
    axis_names: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    device=None,
) -> Mesh:
    """A mesh over every slot of every process: each process's slots
    contiguous along the leading axis, in process order, so row sharding
    over the mesh lines up with ``process_slice``. Every process has as many
    slots as this one."""
    local = local_slot_devices(device)
    n_proc = process_count()
    total = len(local) * n_proc
    if shape is None:
        shape = (total,) + (1,) * (len(axis_names) - 1)
    devices = np.empty(total, dtype=object)
    for i in range(total):
        devices[i] = local[i % len(local)]
    procs = np.repeat(np.arange(n_proc), len(local))
    return Mesh(devices.reshape(shape), axis_names, procs.reshape(shape))


def process_slice(
    global_n: int, process_id: int | None = None, process_count: int | None = None
) -> slice:
    """Rows of a size-``global_n`` global batch this process loads: disjoint
    and covering; ``global_n`` must divide evenly."""
    p = process_index() if process_id is None else process_id
    n = (dist.get_world_size() if _initialized() else 1) if process_count is None else process_count
    if global_n % n:
        raise ValueError(f"global batch {global_n} not divisible by {n} processes")
    per = global_n // n
    return slice(p * per, (p + 1) * per)


def make_global_batch(mesh: Mesh, batch, axis: str = "data"):
    """This process's rows of a global batch (its ``process_slice``) as the
    mesh step takes them: tensors, rows split evenly over this process's
    groups of ``axis``. The step itself gathers what crosses processes."""
    local = len(mesh.leaders(axis))

    def convert(x):
        x = torch.as_tensor(np.asarray(x))
        if x.shape[0] % local:
            raise ValueError(f"{x.shape[0]} rows do not split over {local} local slots")
        return x

    return {k: convert(v) for k, v in batch.items()}


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` that the backend takes (on the host
    under Gloo)."""
    if backend() == "gloo" and t.is_cuda:
        return t.detach().cpu().contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``t`` (same shape everywhere), in rank order, on
    ``t``'s device."""
    if process_count() == 1:
        return [t]
    staged = _staged(t)
    out = [torch.empty_like(staged) for _ in range(process_count())]
    dist.all_gather(out, staged)
    return [o.to(t.device) for o in out]


def sum_over_processes(t: torch.Tensor) -> torch.Tensor:
    """The sum of every process's ``t`` (``all_reduce``: the same bits on
    every process)."""
    if process_count() == 1:
        return t
    staged = _staged(t)
    dist.all_reduce(staged, op=dist.ReduceOp.SUM)
    return staged.to(t.device)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.rows = t.shape[0]
        return torch.cat(all_gather(t), dim=0)

    @staticmethod
    def backward(ctx, grad):
        r = process_index() * ctx.rows
        return sum_over_processes(grad.contiguous())[r:r + ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``t`` concatenated in rank order, with the
    gradient flowing back to each process's own rows."""
    if process_count() == 1:
        return t
    return _GatherRows.apply(t)


def broadcast_from_coordinator(tree):
    """Every process's tree replaced by process 0's (exact bytes): tensors
    and numpy arrays, nested in dicts and lists; other leaves stay."""
    if process_count() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: broadcast_from_coordinator(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_coordinator(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return broadcast_from_coordinator(torch.from_numpy(np.ascontiguousarray(tree))).numpy()
    if isinstance(tree, torch.Tensor):
        staged = _staged(tree)
        dist.broadcast(staged, src=0)
        return staged.to(tree.device)
    return tree


def barrier(name: str = "evr_tpu_barrier") -> None:
    """Block until every process reaches this point (a no-op alone)."""
    if process_count() > 1:
        dist.barrier()
