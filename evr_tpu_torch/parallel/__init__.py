"""Meshes and every parallel layout (PyTorch).

Counterpart of ``evr_tpu/parallel``: ``mesh`` (named grids of device slots,
every axis holding slots), ``contrastive`` (the single-device and
global-batch losses), ``sharded_search`` (the exact top-k over a row-sharded
index), ``sharded_ann`` (the IVF and IVF-PQ tiers a sub-index a shard),
``fsdp`` (params and optimizer state sharded over the data axis), ``tp``
(block weights split over a ``model`` axis), ``pp`` (GPipe stages over a
``stage`` axis), ``sp`` (token shards over a ``seq`` axis), ``ep`` (MoE
experts over an ``expert`` axis, tokens sent to their experts' slots) and
``multihost`` (the process group and its collectives).
"""

from . import ep, fsdp, multihost, pp, sharded_ann, sp, tp
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
    "ep",
    "fsdp",
    "get_mesh",
    "get_multislice_mesh",
    "global_infonce_loss",
    "global_siglip_loss",
    "infonce_loss_single",
    "local_device_count",
    "make_sharded_infonce",
    "multihost",
    "pp",
    "sharded_ann",
    "sp",
    "tp",
    "sharded_cosine_topk",
    "siglip_loss_single",
]
