"""Train the zero-egress OCR recogniser (``ingest/ocr.py``) on synthetic
renders and save the checkpoint that ``LocalOCRAnnotator`` loads.

Counterpart of ``evr_tpu/tools/train_ocr.py``: the same flags and the same
JSON line, plus ``--device`` (default cuda; ``--device cpu`` trains on the
CPU). CTC on DejaVu-font renders of the retrieval domain's vocabulary: no
network, deterministic data. Writes the port's package asset unless
``--out`` names another file; the ``.npz`` layout is the JAX package's, so
either package loads it::

    python -m evr_tpu_torch.tools.train_ocr --steps 6000 --out ocr_ctc.npz
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="train the zero-egress OCR")
    parser.add_argument("--steps", type=int, default=6000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--dataset-size", type=int, default=8192)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="checkpoint path (default: the package asset)")
    parser.add_argument("--eval-n", type=int, default=512,
                        help="held-out renders for the final accuracy gate")
    parser.add_argument("--log-every", type=int, default=500)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the recogniser (default cuda; fails without a "
                        "card unless cpu is given)")
    args = parser.parse_args(argv)

    from evr_tpu_torch.ingest import ocr

    t0 = time.time()
    params, metrics = ocr.train_ocr(
        steps=args.steps, batch=args.batch, dataset_size=args.dataset_size,
        lr=args.lr, seed=args.seed, log_every=args.log_every, device=args.device,
    )
    metrics["acc_heldout"] = ocr.eval_ocr(params, n=args.eval_n, seed=777)
    metrics["train_s"] = round(time.time() - t0, 1)
    metrics["steps"] = args.steps

    out = args.out or ocr.DEFAULT_CHECKPOINT
    ocr.save_checkpoint(params, out, meta=metrics)
    print(json.dumps({"checkpoint": str(out), **metrics}))
    return metrics


if __name__ == "__main__":
    main()
