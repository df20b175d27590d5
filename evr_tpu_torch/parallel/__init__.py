"""Meshes, data parallelism and the sharded exact search (PyTorch).

Counterpart of ``evr_tpu/parallel``'s data axis: ``mesh`` (named grids of
device slots), ``contrastive`` (the single-device and global-batch losses),
``sharded_search`` (the exact top-k over a row-sharded index), ``fsdp``
(params and optimizer state sharded over the slots) and ``multihost`` (the
process group and its collectives). The model, stage and sequence axes
(``tp``, ``pp``, ``sp``) and the sharded ANN tiers are ROADMAP item A21;
``ep`` is A17's.
"""

from . import fsdp, multihost
from .contrastive import (
    global_infonce_loss,
    global_siglip_loss,
    infonce_loss_single,
    make_sharded_infonce,
    siglip_loss_single,
)
from .mesh import Mesh, get_mesh, get_multislice_mesh, local_device_count
from .sharded_search import sharded_cosine_topk

__all__ = [
    "Mesh",
    "fsdp",
    "get_mesh",
    "get_multislice_mesh",
    "global_infonce_loss",
    "global_siglip_loss",
    "infonce_loss_single",
    "local_device_count",
    "make_sharded_infonce",
    "multihost",
    "sharded_cosine_topk",
    "siglip_loss_single",
]
