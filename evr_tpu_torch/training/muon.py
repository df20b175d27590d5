"""Muon: momentum orthogonalized by Newton–Schulz iteration (Jordan et al.
2024, github.com/KellerJordan/Muon), on one device.

Counterpart of ``evr_tpu/training/muon.py``:

- ``newton_schulz_orthogonalize``: five quintic Newton–Schulz steps in bf16
  (three products each), fp32 in and out. The JAX package multiplies its
  Python-float coefficients into bf16 arrays, which rounds them to bf16
  first; the port does the same with bf16 scalar tensors (a Python float
  times a bf16 tensor would keep the float at full precision and move
  every element);
- ``muon_direction``: ``buf = μ·buf + g``, ``u = g + μ·buf`` (Nesterov) or
  ``buf``, then ``NS(u) · sqrt(max(1, m/n))``, all outside the learning
  rate (``optax.scale_by_learning_rate`` follows it in the JAX chain);
- ``muon_param_labels``: "muon" for a 2-D leaf inside a block stack
  (``blocks`` in its path, no ``embedding``), "adamw" for everything else.
  LoRA's factors sit under ``lora/<tower>/blocks/...`` and route to Muon, as
  in the JAX package.

The products are plain ``torch.matmul``: in the JAX package too they are
``jnp`` matmuls, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any

import torch

from .partition import map_with_paths

# Quintic Newton–Schulz coefficients of the reference implementation
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Approximately project a 2-D matrix onto the nearest (semi-)orthogonal
    matrix with ``steps`` quintic Newton–Schulz iterations in bf16; float32
    out. The coefficients act as their bf16 roundings (3.4375, -4.78125,
    2.03125), as in the JAX package; the norm is taken in fp32, ``eps``
    added, and cast to bf16 before the divide."""
    if g.dim() != 2:
        raise ValueError(f"newton_schulz_orthogonalize needs 2-D, got {tuple(g.shape)}")
    a, b, c = (torch.tensor(v, dtype=torch.bfloat16, device=g.device) for v in NS_COEFFS)
    x = g.to(torch.bfloat16)
    x = x / (torch.linalg.vector_norm(x.float()) + eps).to(torch.bfloat16)
    transposed = g.shape[0] > g.shape[1]
    if transposed:
        x = x.T
    for _ in range(steps):
        xxt = x @ x.T
        bx = b * xxt + c * (xxt @ xxt)
        x = a * x + bx @ x
    if transposed:
        x = x.T
    return x.float()


def muon_direction(grad: torch.Tensor, buf: torch.Tensor, momentum: float = 0.95,
                   nesterov: bool = True, ns_steps: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """(the Muon direction of one 2-D leaf, its new momentum buffer), the
    learning rate not applied."""
    buf = momentum * buf + grad
    use = grad + momentum * buf if nesterov else buf
    o = newton_schulz_orthogonalize(use, steps=ns_steps)
    return o * (max(1.0, use.shape[0] / use.shape[1]) ** 0.5), buf


def muon_param_labels(params: Any) -> Any:
    """Label tree (the params' structure): "muon" for the hidden 2-D weight
    matrices (a 2-D leaf with ``blocks`` and no ``embedding`` in its
    lower-cased path), "adamw" for everything else: embeddings, the
    contrastive projections, classifier heads, logit scale and bias, and
    every leaf that is not 2-D."""

    def label(path, leaf) -> str:
        names = "/".join(path).lower()
        ndim = leaf.dim() if isinstance(leaf, torch.Tensor) else getattr(leaf, "ndim", 0)
        if ndim != 2 or "blocks" not in names or "embedding" in names:
            return "adamw"
        return "muon"

    return map_with_paths(params, label)
