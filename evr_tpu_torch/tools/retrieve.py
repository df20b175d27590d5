"""Retrieval over a frame folder: load a model, embed the folder, run text
queries, write the ranked results.

Counterpart of ``evr_tpu/tools/retrieve.py``::

    python -m evr_tpu_torch.tools.retrieve --frames-dir frames/ --queries "a red car" \\
        --checkpoint best_model.pt --violence-filter 0.5 --output results.json

A checkpoint with a classifier head adds each frame's class probabilities
(``--violence-filter`` drops frames whose max(violence, sensitive)
probability is below it; ``--retrieval-mode classification`` ranks by it).
``--grid`` draws the results as a PNG when matplotlib is installed.
``--aot-bundle`` (a StableHLO encoder bundle) is not ported yet (ROADMAP
A19) and is refused. ``--device`` picks the torch device (default cuda).
"""

from __future__ import annotations

import argparse
import json
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description="CLIP frame retrieval")
    parser.add_argument("--frames-dir", required=True)
    parser.add_argument("--queries", nargs="+", required=True)
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", default=None, help="fine-tuned checkpoint (.pt)")
    parser.add_argument("--top-k", type=int, default=10)
    parser.add_argument("--retrieval-mode", choices=["contrastive", "classification"],
                        default="contrastive")
    parser.add_argument(
        "--use-ema", action="store_true",
        help="the EMA weights of a Trainer checkpoint; the raw params when it has none",
    )
    parser.add_argument(
        "--violence-filter", type=float, default=None,
        help="drop frames whose max(violence, sensitive) classifier prob is below this",
    )
    parser.add_argument("--output", default="retrieval_results.json")
    parser.add_argument("--grid", default=None, help="optional path for a result-grid PNG")
    parser.add_argument("--aot-bundle", default=None,
                        help="an AOT encoder bundle: not ported (ROADMAP A19)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)
    if args.aot_bundle:
        parser.error("--aot-bundle is not ported to evr_tpu_torch yet (ROADMAP A19)")

    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex

    if args.checkpoint:
        engine = EmbeddingEngine.from_checkpoint(
            args.checkpoint, args.model, prefer_ema=args.use_ema, device=args.device)
    else:
        engine = EmbeddingEngine(args.model, device=args.device)

    emb, names = engine.embed_folder(args.frames_dir)
    index = FrameIndex(embed_dim=engine.cfg.embed_dim, device=engine.device)
    index.add_video("query_set", emb, names)
    probs = engine.classify(emb)  # None without a trained head

    all_results = {}
    for query in args.queries:
        vec = engine.encode_texts([query])
        hits = index.search(vec, args.top_k * 3)[0]
        rows = []
        for hit in hits:
            row = {"frame": hit.frame_name, "similarity": hit.score}
            if probs is not None:
                p = probs[hit.frame_index]
                row["class_probs"] = [float(x) for x in p]
                # classes: 0 = Sensitive, 1 = Violence, 2 = NonViolence
                if args.violence_filter is not None and max(p[0], p[1]) < args.violence_filter:
                    continue
                if args.retrieval_mode == "classification":
                    row["score"] = float(max(p[0], p[1]))
            rows.append(row)
            if len(rows) >= args.top_k:
                break
        if args.retrieval_mode == "classification" and probs is not None:
            rows.sort(key=lambda r: r.get("score", 0), reverse=True)
        all_results[query] = rows
        print(f"'{query}': top {len(rows)} of {len(names)} frames, "
              f"best sim {rows[0]['similarity']:.4f}" if rows else f"'{query}': no results")

    pathlib.Path(args.output).write_text(json.dumps(all_results, indent=2))
    print(f"wrote {args.output}")

    if args.grid:
        try:
            _save_grid(args.frames_dir, all_results, args.grid)
        except ImportError:
            print(f"matplotlib is not installed: no grid written to {args.grid}")


def _save_grid(frames_dir, all_results, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    queries = list(all_results)
    k = max((len(v) for v in all_results.values()), default=1)
    fig, axes = plt.subplots(len(queries), k, figsize=(2.2 * k, 2.6 * len(queries)), squeeze=False)
    for r, query in enumerate(queries):
        for c in range(k):
            ax = axes[r][c]
            ax.axis("off")
            if c < len(all_results[query]):
                row = all_results[query][c]
                ax.imshow(Image.open(pathlib.Path(frames_dir) / row["frame"]))
                ax.set_title(f"{row['similarity']:.3f}", fontsize=7)
            if c == 0:
                ax.set_ylabel(query[:28], fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
