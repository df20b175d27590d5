"""Pre-flight training diagnostics CLI (E3 parity).

Counterpart of ``evr_tpu/tools/diagnose.py``::

    python -m evr_tpu_torch.tools.diagnose --model ViT-B/32 [--checkpoint ft.pt] --freeze-layers 8

runs the invariant suite the reference ships as
`content/Test_compare_model/clip_pipeline_diagnostics.py` and prints a
structured JSON report: freeze audit, logit-scale sanity, dtype
consistency, embedding-norm check and a batch-size compatibility sweep. It
exits 0 when every check holds, else 1. ``--device`` picks the torch device
(default cuda); the engine keeps float32 weights on any device, so the dtype
check reads what the JAX tool reads.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="training pipeline diagnostics")
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA (Polyak-averaged) weights from the checkpoint "
        "(payload['ema'], written by finetune --ema-decay); falls back to "
        "the raw params when absent",
    )
    parser.add_argument("--freeze-layers", type=int, default=8)
    parser.add_argument("--batch-sizes", nargs="*", type=int, default=[1, 8, 16, 32])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    import numpy as np

    from evr_tpu_torch.evaluation import diagnostics
    from evr_tpu_torch.index import EmbeddingEngine

    engine = EmbeddingEngine(args.model, device=args.device)
    if args.checkpoint:
        engine.load_finetuned(args.checkpoint, prefer_ema=args.use_ema)
        engine.set_active_model("finetuned")

    report = diagnostics.run_all(engine.params, freeze_layers=args.freeze_layers)

    rng = np.random.default_rng(0)
    size = engine.cfg.vision.image_size
    feats = engine.encode_staged_images(
        (rng.random((8, size, size, 3)) * 255).astype(np.uint8), normalise=True
    )
    report["embedding_norms"] = diagnostics.check_embedding_norms(feats)
    report["batch_size_sweep"] = diagnostics.batch_size_sweep(
        lambda b: engine.encode_staged_images(b),
        lambda n: (rng.random((n, size, size, 3)) * 255).astype(np.uint8),
        sizes=tuple(args.batch_sizes),
    )
    report["loss_statistics"] = diagnostics.check_loss_statistics(
        [float(np.log(max(2, bs))) for bs in args.batch_sizes]
    )
    report["ok"] = all(
        v.get("ok", True) for v in report.values() if isinstance(v, dict)
    )
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
