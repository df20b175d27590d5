"""Carry weights across from the JAX package's layout.

``evr_tpu`` keeps params as nested dicts (and lists of blocks) of arrays:
linear kernels ``[in, out]``, the patch-embedding conv kernel HWIO. The port
uses the same layout, so carrying weights across is a leaf-by-leaf copy; no
transposes. Any such tree carries across: CLIP's, SigLIP's (0-d
``logit_scale``/``logit_bias`` included) and Whisper's. A JAX params tree becomes numpy with ``jax.tree.map(np.asarray,
params)`` on the caller's side.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None, shardings=None):
    """Nested dict/list of numpy arrays → the same structure of tensors on
    ``device``, row-major (a checkpoint's transposed views are copied into
    the layout the kernels read). ``dtype`` (optional) casts the
    floating-point leaves. ``shardings`` (optional, a tree of
    ``parallel.mesh.Sharding``s such as ``parallel.tp.
    clip_param_shardings``): each leaf placed on the mesh as a
    ``parallel.fsdp.ShardedTensor``, each slot holding its part."""
    if shardings is not None:
        from evr_tpu_torch.parallel.fsdp import shard_tree

        return shard_tree(params_from_numpy(tree, "cpu", dtype), shardings)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        t = torch.from_numpy(np.array(tree, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()
