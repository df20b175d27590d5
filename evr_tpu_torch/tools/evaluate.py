"""Multi-model retrieval benchmark CLI (`compare_models.py` equivalent).

Counterpart of ``evr_tpu/tools/evaluate.py``::

    python -m evr_tpu_torch.tools.evaluate --images-dir imgs/ --captions-csv results.csv \\
        --checkpoint best_model.pt

evaluates the base model and a fine-tuned checkpoint on the same dataset in
load→eval→unload order and writes JSON, CSV, XLSX and (with matplotlib)
charts. ``--excel`` takes a 3-column test set (.xlsx or .csv, multi-GT
rows add P@K); with neither, captions are synthesized from the folder.
``--classification-dirs CLASS=DIR ...`` runs the classification benchmark
(the checkpoint's trained head where it has one, else a linear probe; with
``--zeroshot`` prompt-ensembled class names). ``--device`` picks the torch
device (default cuda; it fails without a card unless cpu is given).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="retrieval benchmark")
    parser.add_argument("--images-dir", required=True)
    parser.add_argument("--captions-csv", default=None, help="Flickr30k-style CSV")
    parser.add_argument("--excel", default=None, help="3-column Excel/CSV test set")
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", default=None, help="fine-tuned checkpoint to compare (.pt: a reference file or the Trainer's)")
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA (Polyak-averaged) weights from the checkpoint "
        "(payload['ema'], written by finetune --ema-decay); falls back to "
        "the raw params when absent",
    )
    parser.add_argument("--max-images", type=int, default=1000)
    parser.add_argument("--output-dir", default="comparison_results")
    parser.add_argument(
        "--classification-dirs",
        nargs="*",
        default=None,
        metavar="CLASS=DIR",
        help="labelled folders (e.g. Violence=imgs/v NonViolence=imgs/n) — "
        "runs the classification benchmark instead of retrieval",
    )
    parser.add_argument(
        "--zeroshot",
        action="store_true",
        help="with --classification-dirs: classify with prompt-ensembled "
        "class-name text embeddings (the CLIP paper's zero-shot transfer) "
        "instead of a trained head/probe",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    if args.classification_dirs:
        return _run_classification(args)

    from evr_tpu_torch.evaluation import EngineAdapter, ModelComparison
    from evr_tpu_torch.evaluation.datasets import (
        load_captions_csv,
        load_excel_testset,
        synthesize_from_folder,
    )
    from evr_tpu_torch.index import EmbeddingEngine

    if args.captions_csv:
        dataset = load_captions_csv(args.captions_csv, args.images_dir, max_images=args.max_images)
    elif args.excel:
        dataset = load_excel_testset(args.excel, args.images_dir)
    else:
        # fixture-fallback parity (compare_models.py:1710-1731)
        dataset = synthesize_from_folder(args.images_dir, max_images=args.max_images)
    print(f"dataset: {len(dataset.image_ids)} images, {len(dataset.captions)} captions")

    engine = EmbeddingEngine(args.model, device=args.device)
    comp = ModelComparison(output_dir=args.output_dir, device=engine.device)
    comp.register("clip_original", lambda: EngineAdapter(engine, "original"))
    if args.checkpoint:
        # a fresh engine per evaluation (load→eval→unload semantics)
        comp.register(
            "clip_finetuned",
            lambda: EngineAdapter(
                EmbeddingEngine.from_checkpoint(
                    args.checkpoint, args.model, prefer_ema=args.use_ema, device=args.device
                ),
                "finetuned",
            ),
        )

    comp.run_evaluation(dataset)
    print(comp.format_table())
    print(f"wrote {comp.save_json()}")
    print(f"wrote {comp.save_csv()}")
    print(f"wrote {comp.save_xlsx()}")
    chart = comp.save_charts()
    if chart:
        print(f"wrote {chart}")
    return comp.results


def _run_classification(args):
    """E2 parity: per-model accuracy/precision/recall/F1 over labelled
    folders (`compare_model_classification.py` equivalent)."""
    import json
    import pathlib

    import numpy as np

    from evr_tpu_torch.evaluation.classification import evaluate_classification
    from evr_tpu_torch.index import EmbeddingEngine

    class_dirs = dict(spec.split("=", 1) for spec in args.classification_dirs)
    classes = sorted(class_dirs)
    engines = {"original": lambda: EmbeddingEngine(args.model, device=args.device)}
    if args.checkpoint:
        engines["finetuned"] = lambda: EmbeddingEngine.from_checkpoint(
            args.checkpoint, args.model, prefer_ema=args.use_ema, device=args.device
        )

    paths, labels = [], []
    for ci, cls in enumerate(classes):
        for p in sorted(pathlib.Path(class_dirs[cls]).iterdir()):
            if p.suffix.lower() in (".jpg", ".jpeg", ".png"):
                paths.append(p)
                labels.append(ci)
    labels = np.asarray(labels)
    print(f"classification over {len(paths)} images, classes={classes}")

    results = {}
    for model_name, make_engine in engines.items():
        engine = make_engine()
        feats = engine.encode_image_files(paths, normalise=True)
        if args.zeroshot:
            from evr_tpu_torch.evaluation.zeroshot import (
                build_zeroshot_classifier,
                evaluate_zeroshot,
            )

            W = build_zeroshot_classifier(
                lambda prompts: engine.encode_texts(prompts, normalise=False),
                classes,
            )
            report = {"mode": "zeroshot", **evaluate_zeroshot(feats, labels, W)}
        else:
            classifier_fn = (
                engine.classify
                if engine.models[engine.active_model].get("classifier") is not None
                else None
            )
            report = evaluate_classification(
                feats, labels, n_classes=len(classes), classifier_fn=classifier_fn
            )
        results[model_name] = report
        print(
            f"{model_name} [{report['mode']}]: acc={report['accuracy']:.4f} "
            f"f1={report['f1_macro']:.4f}"
        )
    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "classification_results.json").write_text(json.dumps(results, indent=2))
    print(f"wrote {out / 'classification_results.json'}")
    return results


if __name__ == "__main__":
    main()
