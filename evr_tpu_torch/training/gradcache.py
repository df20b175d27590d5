"""GradCache: the exact contrastive gradient of a batch whose encoder
activations need not fit at once (arXiv 2101.06983), on one device or
over the slots of a mesh.

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

Over several slots (``gradcache_parts``) a chunk is a row range of the
global batch and each slot encodes the part of it that it holds with its own
copy of the params; the head runs once, over the whole batch, on the first
slot's device.
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
    """Build the chunked value-and-grad on one device.

    ``encode_fn(chunk) -> {name: [c, D] embedding}`` is the expensive part;
    ``head_fn(embeddings, aux) -> (loss, metrics)`` sees the full [B, D]
    embeddings and any unchunked ``aux``. Returns ``fn(batch, aux, leaves)
    -> ((loss, metrics), grads)``: ``leaves`` maps a key to each tensor to
    differentiate (they require grad), ``grads`` the same keys to their
    gradients (zeros where nothing reaches a leaf)."""

    def fn(batch: dict, aux: Any, leaves: dict[str, torch.Tensor]):
        chunks = [[(0, lambda cb=cb: encode_fn(cb))] for cb in chunk_batch(batch, n_chunks)]
        return gradcache_parts(chunks, head_fn, aux, [leaves])

    return fn


def gradcache_parts(
    chunks: list[list[tuple[int, Callable[[], dict[str, torch.Tensor]]]]],
    head_fn: Callable[[dict[str, torch.Tensor], Any], tuple[torch.Tensor, dict]],
    aux: Any,
    leaves: list[dict[str, torch.Tensor]],
):
    """The three passes over chunks whose rows may lie with several slots.

    ``chunks``: each chunk's parts, in row order, a part ``(s, encode)``:
    ``encode() -> {name: [n, D] embedding}`` encodes the part's rows with
    slot ``s``'s ``leaves[s]`` (key → tensor to differentiate; every slot
    has the same keys). The embeddings are joined on the first part's
    device, where ``head_fn`` runs and differentiates ``leaves[0]`` too.
    Each slot's gradients accumulate from zeros in chunk order, the slots'
    are summed in slot order on the first slot's device and the head's
    added. Returns ``((loss, metrics), grads)``."""
    with torch.no_grad():
        embs = [[encode() for _, encode in parts] for parts in chunks]
    every = [e for es in embs for e in es]
    names = list(every[0])
    dev0 = every[0][names[0]].device
    flat = {k: torch.cat([e[k].to(dev0) for e in every]).requires_grad_() for k in names}
    wrt = list(leaves[0].values())
    with torch.enable_grad():
        loss, metrics = head_fn(flat, aux)
        g = torch.autograd.grad(loss, [flat[k] for k in names] + wrt, allow_unused=True)
    g_emb = dict(zip(names, g[:len(names)]))
    g_head = g[len(names):]
    acc = [[torch.zeros_like(t) for t in slot.values()] for slot in leaves]
    row = 0
    for parts, es in zip(chunks, embs):
        for (s, encode), e in zip(parts, es):
            n = e[names[0]].shape[0]
            with torch.enable_grad():
                out = encode()
                gp = torch.autograd.grad([out[k] for k in names], list(leaves[s].values()),
                                         grad_outputs=[g_emb[k][row:row + n].to(out[k].device) for k in names],
                                         allow_unused=True)
            acc[s] = [a if gr is None else a + gr for a, gr in zip(acc[s], gp)]
            row += n
    grads = {}
    for j, (k, gh) in enumerate(zip(leaves[0], g_head)):
        total = acc[0][j]
        for slot in acc[1:]:  # slot order
            total = total + slot[j].to(total.device)
        grads[k] = total if gh is None else total + gh
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads
