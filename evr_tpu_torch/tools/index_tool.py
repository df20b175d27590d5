"""Build and query standalone ANN indexes over an embedding matrix.

Counterpart of ``evr_tpu/tools/index_tool.py``. Serving gets the tiers
through ``FrameIndex(search_impl=...)``; this CLI is the offline workflow:
build once from a ``.npy`` embedding matrix, save the index (the JAX
package's ``.npz`` layout, so either package queries it), query it later.

    # build (type: ivf | pq | ivfpq)
    python -m evr_tpu_torch.tools.index_tool build --embeddings emb.npy \\
        --type ivfpq --out idx.npz --clusters 1024 --subspaces 64

    # query with text (through the port's EmbeddingEngine) or query embeddings
    python -m evr_tpu_torch.tools.index_tool query --index idx.npz --type ivfpq \\
        --query-embeddings q.npy --top-k 10 --nprobe 32 --rerank 200

``--device`` picks the torch device (default cuda; ``--device cpu`` runs on
the CPU). ``build --type ivfpq --streamed`` memmaps the ``.npy`` and builds
with ``IVFPQIndex.build_device_streamed`` (the paired packed layout);
``--host-store PREFIX`` also writes the int8 re-rank store, which ``query
--host-store PREFIX --rerank R`` attaches. Queries take ``adc_impl="auto"``
(the gather-sum) on a packed index, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _load_normed(path):
    emb = np.load(path).astype(np.float32)
    if emb.ndim != 2:
        raise SystemExit(f"{path}: expected a 2-D embedding matrix, got {emb.shape}")
    return emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)


def _default_clusters(args, n: int) -> int:
    return min(args.clusters or max(1, int(round(n**0.5))), n)


def _write_host_store(raw, prefix: str, slab_rows: int) -> None:
    """PREFIX.rows.npy (int8) + PREFIX.scales.npy, written slab by slab so
    the corpus never has to fit in memory at once."""
    from evr_tpu_torch.index.ivfpq import quantize_host_store

    n, d = raw.shape
    rows8 = np.lib.format.open_memmap(prefix + ".rows.npy", mode="w+", dtype=np.int8, shape=(n, d))
    scales = np.lib.format.open_memmap(prefix + ".scales.npy", mode="w+", dtype=np.float32,
                                       shape=(n,))
    for start in range(0, n, slab_rows):
        s = np.array(raw[start : start + slab_rows], np.float32)
        s /= np.maximum(np.linalg.norm(s, axis=1, keepdims=True), 1e-12)
        rows8[start : start + len(s)], scales[start : start + len(s)] = quantize_host_store(s)
    rows8.flush()
    scales.flush()


def cmd_build(args) -> None:
    import torch

    from evr_tpu_torch.index import IVFIndex, IVFPQIndex, PQIndex
    from evr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    streamed = args.type == "ivfpq" and args.streamed
    if streamed:
        raw = np.load(args.embeddings, mmap_mode="r")
        n, dim = raw.shape
    else:
        emb = _load_normed(args.embeddings)
        n, dim = emb.shape
    t0 = time.perf_counter()
    if args.type == "ivf":
        idx = IVFIndex().build(
            emb, n_clusters=_default_clusters(args, n), capacity_factor=args.capacity_factor,
            iters=args.iters, device=device,
        )
        extra = {"n_clusters": idx.n_clusters}
    elif args.type == "pq":
        idx = PQIndex().build(
            emb, n_subspaces=args.subspaces, n_centroids=args.centroids, iters=args.iters,
            opq_iters=args.opq_iters, keep_originals=not args.no_originals, device=device,
        )
        extra = {"code_bytes_per_row": idx.code_bytes // max(1, n)}
    elif streamed:
        def slab_fn(start, m):
            s = np.array(raw[start : start + m], np.float32)
            s /= np.maximum(np.linalg.norm(s, axis=1, keepdims=True), 1e-12)
            return torch.from_numpy(s).to(device)

        idx = IVFPQIndex().build_device_streamed(
            slab_fn, n, dim, n_clusters=_default_clusters(args, n), n_subspaces=args.subspaces,
            n_centroids=args.centroids, capacity_factor=args.capacity_factor,
            coarse_iters=args.iters, pq_iters=args.iters, opq_iters=args.opq_iters,
            slab_rows=min(args.slab_rows, n),
        )
        extra = {"n_clusters": idx.n_clusters,
                 "code_bytes_per_row": idx.code_bytes // max(1, n) + 4, "streamed": True}
        if args.host_store:
            _write_host_store(raw, args.host_store, args.slab_rows)
            extra["host_store"] = args.host_store
    else:
        idx = IVFPQIndex().build(
            emb, n_clusters=_default_clusters(args, n), n_subspaces=args.subspaces,
            n_centroids=args.centroids, capacity_factor=args.capacity_factor,
            coarse_iters=args.iters, pq_iters=args.iters,
            keep_originals=not args.no_originals, device=device,
        )
        extra = {"n_clusters": idx.n_clusters,
                 "code_bytes_per_row": idx.code_bytes // max(1, n) + 4}
    idx.save(args.out)
    print(json.dumps({
        "type": args.type, "rows": n, "dim": int(dim),
        "build_s": round(time.perf_counter() - t0, 2), "out": args.out, **extra,
    }))


def cmd_query(args) -> None:
    from evr_tpu_torch.index import IVFIndex, IVFPQIndex, PQIndex

    cls = {"ivf": IVFIndex, "pq": PQIndex, "ivfpq": IVFPQIndex}[args.type]
    idx = cls.load(args.index, device=args.device)
    if args.type == "ivfpq" and args.host_store:
        # memmapped: search(rerank=) gathers only the candidate rows
        idx.attach_host_store(np.load(args.host_store + ".rows.npy", mmap_mode="r"),
                              np.load(args.host_store + ".scales.npy", mmap_mode="r"))
    if args.query_embeddings:
        q = _load_normed(args.query_embeddings)
    elif args.query:
        from evr_tpu_torch.index import EmbeddingEngine

        engine = EmbeddingEngine(args.model, device=args.device)
        if args.checkpoint:
            engine.load_finetuned(args.checkpoint)
            engine.set_active_model("finetuned")
        q = engine.encode_texts(list(args.query))
    else:
        raise SystemExit("provide --query-embeddings or --query")

    kw = {}
    if args.type in ("ivf", "ivfpq"):
        kw["nprobe"] = args.nprobe
    if args.type in ("pq", "ivfpq") and args.rerank:
        kw["rerank"] = args.rerank
    t0 = time.perf_counter()
    scores, rows = idx.search(q, args.top_k, **kw)
    ms = (time.perf_counter() - t0) * 1000
    for qi in range(len(q)):
        hits = [{"row": int(r), "score": round(float(s), 4)}
                for s, r in zip(scores[qi], rows[qi]) if r >= 0]
        print(json.dumps({"query": qi, "hits": hits}))
    print(json.dumps({"batch_ms": round(ms, 2), "queries": len(q)}))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build + save an index")
    b.add_argument("--embeddings", required=True, help=".npy [N, D] matrix")
    b.add_argument("--type", choices=["ivf", "pq", "ivfpq"], required=True)
    b.add_argument("--out", required=True, help="output .npz path")
    b.add_argument("--clusters", type=int, default=None, help="default ~sqrt(N)")
    b.add_argument("--subspaces", type=int, default=64)
    b.add_argument("--centroids", type=int, default=256)
    b.add_argument("--capacity-factor", type=float, default=1.3)
    b.add_argument("--iters", type=int, default=10, help="k-means iterations")
    b.add_argument("--opq-iters", type=int, default=0,
                   help="pq and streamed ivfpq: OPQ rotation refinement rounds")
    b.add_argument("--streamed", action="store_true",
                   help="ivfpq: streamed device build from the memmapped .npy")
    b.add_argument("--slab-rows", type=int, default=500_000, help="streamed build slab size")
    b.add_argument("--host-store", default=None, metavar="PREFIX",
                   help="streamed ivfpq: also write PREFIX.rows.npy (int8) + "
                   "PREFIX.scales.npy, the host re-rank store")
    b.add_argument("--no-originals", action="store_true",
                   help="pq/ivfpq: drop the fp32 originals (no exact re-rank)")
    b.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card unless cpu is given)")
    b.set_defaults(fn=cmd_build)

    qp = sub.add_parser("query", help="query a saved index")
    qp.add_argument("--index", required=True)
    qp.add_argument("--type", choices=["ivf", "pq", "ivfpq"], required=True)
    qp.add_argument("--query", nargs="*", default=None, help="text queries")
    qp.add_argument("--query-embeddings", default=None, help=".npy [B, D]")
    qp.add_argument("--model", default="ViT-B/32")
    qp.add_argument("--checkpoint", default=None, help="encode --query with this fine-tuned .pt checkpoint")
    qp.add_argument("--top-k", type=int, default=10)
    qp.add_argument("--nprobe", type=int, default=32)
    qp.add_argument("--rerank", type=int, default=None)
    qp.add_argument("--host-store", default=None, metavar="PREFIX",
                    help="ivfpq: attach the memmapped int8 re-rank store of build --host-store")
    qp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; fails without a card unless cpu is given)")
    qp.set_defaults(fn=cmd_query)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
