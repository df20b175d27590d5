"""Distill a large teacher CLIP into a small student (``training/distill.py``).

MobileCLIP/CLIP-KD-style similarity distillation over a caption dataset:

    python -m evr_tpu_torch.tools.distill \\
        --train-json caps.json --data-dir frames/ \\
        --student-model ViT-B/32 --teacher-model ViT-L/14 \\
        --teacher-checkpoint vit_l.pt --epochs 3 --save-dir distilled/

The teacher is frozen; the student trains on contrastive + KD (+ optional
embedding alignment) and is written to ``<save-dir>/student.pt`` as
``{"params": {"clip": ...}, "step", "epoch", "metrics"}``, the payload the
JAX CLI writes to orbax, which ``EmbeddingEngine`` serves
(``load_torch_checkpoint``), with ``history.json`` beside it. Both towers
must share the pixel size, as in the JAX CLI: the defaults (a
ViT-L/14@336px teacher, a ViT-B/32 student) refuse. ``--device`` defaults to
``cuda``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--train-json", required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--student-model", default="ViT-B/32")
    parser.add_argument("--teacher-model", default="ViT-L/14@336px")
    parser.add_argument("--student-checkpoint", default=None,
                        help="optional student init (.pt); random init otherwise")
    parser.add_argument("--teacher-checkpoint", default=None,
                        help="teacher weights (.pt); random init otherwise (smoke runs)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--kd-weight", type=float, default=1.0)
    parser.add_argument("--align-weight", type=float, default=0.0)
    parser.add_argument("--contrastive-weight", type=float, default=1.0)
    parser.add_argument("--kd-temperature", type=float, default=2.0)
    parser.add_argument("--save-dir", default="distilled")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from evr_tpu_torch.index.engine import load_torch_checkpoint
    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.training.data import CaptionDataset
    from evr_tpu_torch.training.distill import DistillationTrainer, DistillConfig
    from evr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    s_cfg = get_model_config(args.student_model)
    t_cfg = get_model_config(args.teacher_model)
    ds = CaptionDataset(args.train_json, args.data_dir)
    print(f"train={len(ds)} student={args.student_model} teacher={args.teacher_model}")
    # the student's serving size drives the batch: both towers must share it
    # (checked before either tower's weights are drawn or read)
    if s_cfg.vision.image_size != t_cfg.vision.image_size:
        raise SystemExit(
            f"student image_size {s_cfg.vision.image_size} != teacher "
            f"{t_cfg.vision.image_size}: pick a teacher at the student's "
            "resolution (e.g. ViT-L/14 for a 224px student)"
        )

    def load_params(path, cfg, seed):
        if path is None:
            return init_clip_params(seed, cfg)
        return load_torch_checkpoint(path)["clip"]

    s_params = load_params(args.student_checkpoint, s_cfg, args.seed)
    t_params = load_params(args.teacher_checkpoint, t_cfg, args.seed + 1)
    if args.teacher_checkpoint is None:
        print("WARNING: no --teacher-checkpoint; teacher is randomly initialised")
    trainer = DistillationTrainer(
        s_cfg, s_params, t_cfg, t_params,
        DistillConfig(lr=args.lr, kd_weight=args.kd_weight, align_weight=args.align_weight,
                      contrastive_weight=args.contrastive_weight, kd_temperature=args.kd_temperature),
        device=device,
    )
    del s_params, t_params

    history = []
    for epoch in range(args.epochs):
        ms = [trainer.train_step(batch) for batch in
              ds.batches(args.batch_size, s_cfg.vision.image_size, epoch=epoch, seed=args.seed)]
        if not ms:
            raise SystemExit("dataset produced no batches (batch too large?)")
        mean = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        history.append({"epoch": epoch, **mean})
        print(f"[epoch {epoch}] " + " ".join(f"{k}={v:.4f}" for k, v in mean.items()))

    out = pathlib.Path(args.save_dir).resolve()
    out.mkdir(parents=True, exist_ok=True)
    path = out / "student.pt"
    torch.save({"params": {"clip": trainer.params}, "step": len(history), "epoch": args.epochs - 1,
                "metrics": history[-1]}, path)
    (out / "history.json").write_text(json.dumps(history, indent=2))
    print(f"wrote {path}")
    return history


if __name__ == "__main__":
    main()
