"""GradCache: the exact contrastive gradient of a batch whose encoder
activations need not fit at once (arXiv 2101.06983), on one device.

Counterpart of ``evr_tpu/training/gradcache.py``. Three passes over C chunks:

1. **feature pass**: every chunk encoded under ``torch.no_grad()`` (nothing
   is kept for a backward; on the card the blocks run the forward kernels
   K1/K2 alone), the [B, D] embeddings collected;
2. **head**: the loss of the full batch and its gradient with respect to
   the *unnormalised* embeddings and to the leaves the loss reads directly
   (``logit_scale``, ``logit_bias``, the classifier);
3. **re-encode**: each chunk encoded again under grad and differentiated
   with ``torch.autograd.grad(emb, leaves, grad_outputs=g_chunk)`` (on the
   card through ``FusedBlockFunction``: K1/K2 forward, K5b/K5a backward).

The sum runs as the JAX scan runs it: the chunks' gradients accumulate from
zeros in chunk order, then the head's are added. The result is the
gradient of the whole batch; chunking changes only the order of sums.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def chunk_batch(batch: dict, n_chunks: int) -> list[dict]:
    """Split every entry [B, ...] of ``batch`` into ``n_chunks`` chunks of
    B / C rows, in order; raises ``ValueError`` when C does not divide B."""
    out = [{} for _ in range(n_chunks)]
    for k, a in batch.items():
        b = a.shape[0]
        if b % n_chunks:
            raise ValueError(f"gradcache: batch size {b} not divisible by {n_chunks} chunks")
        c = b // n_chunks
        for i in range(n_chunks):
            out[i][k] = a[i * c:(i + 1) * c]
    return out


def gradcache_value_and_grad(
    encode_fn: Callable[[dict], dict[str, torch.Tensor]],
    head_fn: Callable[[dict[str, torch.Tensor], Any], tuple[torch.Tensor, dict]],
    n_chunks: int,
):
    """Build the chunked value-and-grad.

    ``encode_fn(chunk) -> {name: [c, D] embedding}`` is the expensive part;
    ``head_fn(embeddings, aux) -> (loss, metrics)`` sees the full [B, D]
    embeddings and any unchunked ``aux``. Returns ``fn(batch, aux, leaves)
    -> ((loss, metrics), grads)``: ``leaves`` maps a key to each tensor to
    differentiate (they require grad), ``grads`` the same keys to their
    gradients (zeros where nothing reaches a leaf)."""

    def fn(batch: dict, aux: Any, leaves: dict[str, torch.Tensor]):
        chunks = chunk_batch(batch, n_chunks)
        with torch.no_grad():
            embs = [encode_fn(cb) for cb in chunks]
        names = list(embs[0])
        flat = {k: torch.cat([e[k] for e in embs]).requires_grad_() for k in names}
        wrt = list(leaves.values())
        with torch.enable_grad():
            loss, metrics = head_fn(flat, aux)
            g = torch.autograd.grad(loss, [flat[k] for k in names] + wrt, allow_unused=True)
        g_emb = dict(zip(names, g[:len(names)]))
        g_head = g[len(names):]
        acc = [torch.zeros_like(t) for t in wrt]
        row = 0
        for cb, e in zip(chunks, embs):
            n = e[names[0]].shape[0]
            with torch.enable_grad():
                out = encode_fn(cb)
                gp = torch.autograd.grad([out[k] for k in names], wrt,
                                         grad_outputs=[g_emb[k][row:row + n] for k in names],
                                         allow_unused=True)
            acc = [a if gr is None else a + gr for a, gr in zip(acc, gp)]
            row += n
        grads = {k: a if gh is None else a + gh for k, a, gh in zip(leaves, acc, g_head)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads

    return fn
