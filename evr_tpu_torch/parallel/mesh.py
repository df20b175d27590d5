"""Device meshes: a named grid of device slots (PyTorch).

Counterpart of ``evr_tpu/parallel/mesh.py``. One process drives every slot of
its mesh, as one JAX process drives its local chips: a ``Mesh`` is a grid of
``torch.device`` slots with named axes (``mesh.shape["data"]`` as in JAX).
A mesh may list one device in several slots: the CPU tests take 4 or 8 slots
of the CPU, and one card can hold a 4-slot mesh. Code that works over a mesh
keeps its params once per distinct device, not once per slot, and runs each
slot's share of the work in slot order, so a run repeats bit for bit.

Every axis holds slots. Work split over one axis (a batch over ``data``,
blocks over ``stage``, tokens over ``seq``, weight columns over ``model``)
runs once per group of that axis (``leaders``, ``group``); a leaf not split
over an axis is replicated over it.

Across processes (``parallel.multihost``) a mesh also records which process
owns each slot; a process computes on its own slots only, and the processes
meet in ``torch.distributed`` collectives (NCCL between cards, Gloo on the
CPU).

``EVR_TPU_CPU_DEVICES`` sets the number of CPU slots a mesh on the CPU takes
by default (``tools.pod_launch --cpu-devices``), as JAX's host platform
device count does.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

CPU_DEVICES_ENV = "EVR_TPU_CPU_DEVICES"


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A grid of device slots with named axes.

    ``devices``: an array (any shape) of ``torch.device``; ``processes``: an
    int array of the same shape naming each slot's process (all 0 in one
    process). Slots are numbered in row-major order."""

    def __init__(self, devices, axis_names: tuple[str, ...], processes=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (
            np.zeros(devices.shape, np.int64) if processes is None
            else np.asarray(processes, np.int64).reshape(devices.shape)
        )
        self.process_index = _process_index()

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_count(self) -> int:
        return len(set(self.processes.ravel().tolist()))

    def axis_size(self, axis) -> int:
        """Slots along ``axis``: a name, or a tuple of names taken jointly."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return math.prod(self.shape[a] for a in names)

    def axis_index(self, slot: int, axis) -> int:
        """Global slot ``slot``'s position along ``axis`` (a name, or a tuple
        of names taken jointly, row-major in the order given)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        coords = np.unravel_index(slot, self.devices.shape)
        pos = 0
        for a in names:
            i = self.axis_names.index(a)
            pos = pos * self.devices.shape[i] + int(coords[i])
        return pos

    def leaders(self, axis) -> list[int]:
        """This process's slots that lead a group of ``axis``: their position
        on every other axis is 0. Work split over ``axis`` (a batch, index
        rows) runs once per group, on its leader; the group's other slots
        hold replicas (or, for a leaf split over another axis, the other
        shards). In order of their position along ``axis``."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        others = [i for i, a in enumerate(self.axis_names) if a not in names]
        out = [s for s in self.local_slots
               if all(np.unravel_index(s, self.devices.shape)[i] == 0 for i in others)]
        return sorted(out, key=lambda s: self.axis_index(s, names))

    def group(self, slot: int, axis) -> list[int]:
        """The slots that differ from ``slot`` only along ``axis`` (``slot``
        included), in order of their position along it: the shards of a leaf
        split over ``axis`` that one slot's work gathers."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        here = np.unravel_index(slot, self.devices.shape)
        keep = [i for i, a in enumerate(self.axis_names) if a not in names]
        out = [s for s in range(self.size)
               if all(np.unravel_index(s, self.devices.shape)[i] == here[i] for i in keep)]
        return sorted(out, key=lambda s: self.axis_index(s, names))

    @property
    def slot_devices(self) -> list[torch.device]:
        return list(self.devices.ravel())

    @property
    def slot_processes(self) -> list[int]:
        return self.processes.ravel().tolist()

    @property
    def local_slots(self) -> list[int]:
        """Global slot numbers of this process's slots, in slot order."""
        return [i for i, p in enumerate(self.slot_processes) if p == self.process_index]

    @property
    def local_devices(self) -> list[torch.device]:
        """This process's distinct devices, in order of first slot."""
        out: list[torch.device] = []
        for i in self.local_slots:
            d = self.slot_devices[i]
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, processes={self.process_count})"


@dataclass(frozen=True)
class Sharding:
    """A placement over a mesh (JAX's ``NamedSharding``): ``spec`` holds, for
    each dimension, the mesh axis it is split over or None (``(None,
    "model")`` splits the columns over ``model``); ``()`` replicates. One
    dimension at most is split; every axis the spec does not name
    replicates the leaf."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def dim(self) -> int | None:
        """The dimension split over the mesh, or None (replicated)."""
        for i, a in enumerate(self.spec):
            if a is not None:
                return i
        return None

    @property
    def axis(self):
        """The mesh axis (or axes) the split dimension runs over, or None."""
        d = self.dim
        return None if d is None else self.spec[d]

    @property
    def n_shards(self) -> int:
        return 1 if self.dim is None else self.mesh.axis_size(self.axis)

    def shard_index(self, slot: int) -> int:
        """Which shard global slot ``slot`` holds (0 for a replicated leaf)."""
        return 0 if self.dim is None else self.mesh.axis_index(slot, self.axis)

    def shard_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        d = self.dim
        if d is None:
            return shape
        return shape[:d] + (shape[d] // self.n_shards,) + shape[d + 1:]


def cpu_device_count() -> int:
    return int(os.environ.get(CPU_DEVICES_ENV, "1"))


def _base_devices(device=None) -> list[torch.device]:
    """The local devices a mesh cycles over: every card, or the CPU when the
    caller asks for it. No card and no CPU request raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to build a CPU mesh")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count(device=None) -> int:
    """Local cards (or, with ``device="cpu"``, the CPU slots a mesh takes by
    default, ``EVR_TPU_CPU_DEVICES`` or 1)."""
    base = _base_devices(device)
    return cpu_device_count() if base[0].type == "cpu" else len(base)


def get_mesh(
    n_devices: int | None = None,
    axis_names: tuple[str, ...] = ("data",),
    shape: tuple[int, ...] | None = None,
    device=None,
) -> Mesh:
    """A mesh of ``n_devices`` slots (default: every local card, or the
    default CPU slot count with ``device="cpu"``), cycling over the local
    devices: slot i on device i mod count. With the default single axis every
    slot goes to data parallelism; pass ``shape``/``axis_names`` for 2-D
    layouts."""
    base = _base_devices(device)
    if n_devices is None:
        n_devices = local_device_count(device)
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} does not hold {n_devices} slots")
    slots = np.empty(n_devices, dtype=object)
    for i in range(n_devices):
        slots[i] = base[i % len(base)]
    return Mesh(slots.reshape(shape), axis_names)


def get_multislice_mesh(
    n_slices: int,
    chips_per_slice: int,
    axis_names: tuple[str, str] = ("replica", "data"),
    device=None,
) -> Mesh:
    """The multi-slice layout: an outer ``replica`` axis across slices and an
    inner ``data`` axis within one, over the local devices
    (``local_device_count``)."""
    need = n_slices * chips_per_slice
    available = local_device_count(device)
    if available < need:
        raise ValueError(f"need {need} devices, have {available}")
    return get_mesh(need, axis_names, (n_slices, chips_per_slice), device=device)


def shard_rows(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (row) dimension split over ``axis``."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
