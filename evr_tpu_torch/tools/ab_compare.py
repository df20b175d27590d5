"""Original-vs-finetuned A/B retrieval comparison (E4 parity).

Counterpart of ``evr_tpu/tools/ab_compare.py``::

    python -m evr_tpu_torch.tools.ab_compare --frames-dir frames/ --queries "a fight" \\
        --checkpoint best_model.pt [--histogram sims.png]

Reference: `content/Test_compare_model/test_clip_models.py`
(`run_comparison_test` at `:63`) and `clip_comparison_test.py` — encode a
frame directory with both models, run the same queries, dump side-by-side
rankings (`all_retrieval_results.json`) and a similarity histogram (which
needs matplotlib). ``--device`` picks the torch device (default cuda).
"""

from __future__ import annotations

import argparse
import json
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description="A/B model retrieval comparison")
    parser.add_argument("--frames-dir", required=True)
    parser.add_argument("--queries", nargs="+", required=True)
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", required=True, help="fine-tuned .pt")
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA (Polyak-averaged) weights from the checkpoint "
        "(payload['ema'], written by finetune --ema-decay); falls back to "
        "the raw params when absent",
    )
    parser.add_argument("--top-k", type=int, default=10)
    parser.add_argument("--output", default="all_retrieval_results.json")
    parser.add_argument("--histogram", default=None, help="optional sim-histogram PNG")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex

    engine = EmbeddingEngine(args.model, device=args.device)
    engine.load_finetuned(args.checkpoint, prefer_ema=args.use_ema)

    results: dict = {}
    sims_by_model: dict[str, list] = {}
    for model_name in ("original", "finetuned"):
        engine.set_active_model(model_name)
        engine.clear_text_cache()
        emb, names = engine.embed_folder(args.frames_dir)
        index = FrameIndex(embed_dim=engine.cfg.embed_dim, device=engine.device)
        index.add_video("ab", emb, names)
        per_model = {}
        all_sims = []
        for query in args.queries:
            vec = engine.encode_texts([query])
            hits = index.search(vec, args.top_k)[0]
            per_model[query] = [
                {"frame": h.frame_name, "similarity": h.score} for h in hits
            ]
            all_sims.extend(h.score for h in hits)
        results[model_name] = per_model
        sims_by_model[model_name] = all_sims
        finite = [s for s in all_sims if np.isfinite(s)]
        print(
            f"{model_name}: mean top-{args.top_k} sim "
            f"{np.mean(finite) if finite else float('nan'):.4f} over {len(args.queries)} queries"
        )

    pathlib.Path(args.output).write_text(json.dumps(results, indent=2))
    print(f"wrote {args.output}")

    if args.histogram:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for name, sims in sims_by_model.items():
            ax.hist(sims, bins=30, alpha=0.5, label=name)
        ax.set_xlabel("cosine similarity")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.histogram, dpi=110)
        print(f"wrote {args.histogram}")


if __name__ == "__main__":
    main()
