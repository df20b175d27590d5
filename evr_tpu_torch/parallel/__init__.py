"""Contrastive losses of the JAX package's ``parallel`` package
(``evr_tpu/parallel/contrastive.py``), single device so far; the global-batch
and sharded variants wait for ROADMAP item A15."""

from .contrastive import infonce_loss_single, siglip_loss_single

__all__ = ["infonce_loss_single", "siglip_loss_single"]
