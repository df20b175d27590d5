"""Fine-tune CLI: one device, a mesh of local slots, or several processes.

``python -m evr_tpu_torch.tools.finetune --train-json a.json b.json
--data-dir images/ --model ViT-L/14@336px --epochs 10`` runs the reference
trainer's shape (``Backend/clip_finetune_correct.py``): combined caption
datasets, CLIP + 3-class head, InfoNCE + CE, early stopping, best/final
checkpoints and ``history.json`` under ``--save-dir``. The towers start from
``--init-checkpoint`` (a reference ``.pt`` in the OpenAI layout,
``models.torch_import.load_checkpoint``) or from seeded random weights
(``--seed``); the classifier head is always drawn from ``--seed`` + 1.
``--device`` defaults to ``cuda`` and ``--device cpu`` runs on the CPU.

The trainer's levers: ``--lora-rank``/``--lora-alpha`` (after a run that was
not preempted, ``<save-dir>/lora_merged.pt`` holds ``{"params": merged CLIP
tree}``, the payload the JAX CLI writes to orbax, which ``EmbeddingEngine``
serves), ``--optimizer muon`` and ``--muon-lr-scale``, ``--gradcache-chunks``,
``--remat`` and ``--patch-drop``, and Mixture-of-Experts: ``--moe-experts`` >
0 Sparse-Upcycles the dense start to that many experts per MoE layer
(``--moe-router-k``, ``--moe-every``, ``--moe-capacity``,
``--moe-aux-weight``; ``models.moe``) and ``--expert-parallel E`` splits the
experts and their moments over an E-way ``expert`` axis of the mesh, the
remaining slots forming ``data`` (``parallel.ep``).

As in the JAX CLI the trainer runs over a mesh of every local card
(``parallel.get_mesh``; ``EVR_TPU_CPU_DEVICES`` CPU slots with ``--device
cpu``), and ``--no-mesh`` runs on one device (a mesh of one slot takes
the same step). ``--fsdp`` shards the params, the AdamW
moments and the EMA over the mesh. Under ``tools.pod_launch`` each process
joins the group (``parallel.multihost.bootstrap``), the mesh spans every
process's slots, ``--batch-size`` is the global batch and each process
loads its share; the coordinator alone writes ``history.json`` and the
checkpoints.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="contrastive CLIP fine-tune (PyTorch)")
    parser.add_argument("--train-json", nargs="+", required=True)
    parser.add_argument("--val-json", nargs="*", default=[])
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--freeze-layers", type=int, default=8)
    parser.add_argument("--save-dir", default="checkpoints")
    parser.add_argument("--num-classes", type=int, default=3)
    parser.add_argument("--no-mesh", action="store_true",
                        help="single-device run (default: a mesh over every local card)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard params + AdamW moments over the mesh (ZeRO-3)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--loss", choices=["infonce", "siglip"], default="infonce",
                        help="contrastive objective: InfoNCE or SigLIP pairwise sigmoid")
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="linear LR warmup steps before the cosine schedule")
    parser.add_argument("--adam-mu-dtype", choices=["float32", "bfloat16"], default="float32",
                        help="AdamW first-moment storage dtype (update math stays fp32)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="EMA weight averaging decay (e.g. 0.999), saved as payload['ema']")
    parser.add_argument("--save-every-steps", type=int, default=0,
                        help="mid-epoch autosave every N batches + SIGTERM autosave; "
                        "resume with --resume-from autosave")
    parser.add_argument("--resume-from", default=None,
                        help="checkpoint name under --save-dir (e.g. autosave)")
    parser.add_argument("--init-checkpoint", default=None,
                        help="start the towers from this reference .pt checkpoint (OpenAI layout)")
    parser.add_argument("--patch-drop", type=float, default=0.0,
                        help="FLIP random patch masking fraction during training (arxiv 2212.00794)")
    parser.add_argument("--gradcache-chunks", type=int, default=0,
                        help="GradCache (arxiv 2101.06983): the batch encoded in N chunks, the "
                        "contrastive negatives still the full batch; 0 disables")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialise the transformer blocks in the backward pass")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="LoRA (arxiv 2106.09685): rank-r adapters on the block linears, base "
                        "frozen; a merged checkpoint is written to <save-dir>/lora_merged.pt")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--optimizer", choices=["adamw", "muon"], default="adamw",
                        help="muon: Newton-Schulz-orthogonalized momentum on the hidden 2-D "
                        "weights, AdamW elsewhere (training/muon.py)")
    parser.add_argument("--muon-lr-scale", type=float, default=10.0,
                        help="Muon lr = lr * group scale * this")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="Mixture-of-Experts fine-tune (models.moe): > 0 upcycles the dense start "
                        "to this many experts per MoE layer; 0 = dense")
    parser.add_argument("--moe-router-k", type=int, default=2, help="top-k routing (1 Switch, 2 GShard)")
    parser.add_argument("--moe-every", type=int, default=2,
                        help="every Nth block (from the tower's end) gets an MoE MLP")
    parser.add_argument("--moe-capacity", type=float, default=1.25, help="expert capacity factor")
    parser.add_argument("--moe-aux-weight", type=float, default=1e-2,
                        help="Switch load-balance aux loss weight")
    parser.add_argument("--expert-parallel", type=int, default=0, metavar="E",
                        help="split the experts (and their moments) over an E-way 'expert' mesh axis; "
                        "the remaining slots form the 'data' axis")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.parallel import get_mesh, local_device_count, multihost
    from evr_tpu_torch.training import CaptionDataset, TrainConfig, Trainer
    from evr_tpu_torch.utils.device import resolve_device

    # joins the process group when EVR_TPU_COORDINATOR & co. are set
    process_index, process_count = multihost.bootstrap(device=args.device)
    device = resolve_device(args.device)
    moe_cfg = None
    if args.moe_experts > 0:
        from evr_tpu_torch.models.moe import MoEConfig

        moe_cfg = MoEConfig(n_experts=args.moe_experts, router_k=args.moe_router_k,
                            capacity_factor=args.moe_capacity, moe_every=args.moe_every,
                            aux_weight=args.moe_aux_weight)
    mesh = None
    if not args.no_mesh and args.expert_parallel > 0:
        if moe_cfg is None:
            raise SystemExit("--expert-parallel requires --moe-experts > 0")
        if args.moe_experts % args.expert_parallel:
            raise SystemExit(f"--moe-experts {args.moe_experts} must divide over the "
                             f"{args.expert_parallel}-way expert axis")
        n_dev = local_device_count(device)
        if process_count > 1 or n_dev % args.expert_parallel:
            raise SystemExit(f"{n_dev} local slot(s) of {process_count} process(es) don't divide into an "
                             f"{args.expert_parallel}-way expert axis")
        mesh = get_mesh(n_dev, ("data", "expert"), (n_dev // args.expert_parallel, args.expert_parallel),
                        device=device)
    elif not args.no_mesh:
        mesh = (multihost.global_mesh(device=device) if process_count > 1
                else get_mesh(device=device))
    if args.batch_size % process_count:
        raise SystemExit(f"--batch-size {args.batch_size} (global) must divide over "
                         f"{process_count} processes")
    per_proc_bs = args.batch_size // process_count
    cfg = get_model_config(args.model)
    if args.init_checkpoint:
        from evr_tpu_torch.models.torch_import import load_checkpoint

        clip_params = load_checkpoint(args.init_checkpoint)["clip"]
    else:
        clip_params = init_clip_params(args.seed, cfg)
    cls_params = init_classifier_params(
        args.seed + 1, ClassifierConfig(embed_dim=cfg.embed_dim, num_classes=args.num_classes)
    )
    train_ds = CaptionDataset(args.train_json, args.data_dir)
    val_ds = CaptionDataset(args.val_json, args.data_dir) if args.val_json else None
    if val_ds is None:
        train_ds, val_ds = train_ds.split(0.2, args.seed)
    print(f"train={len(train_ds)} val={len(val_ds)} categories={train_ds.category_counts()}")
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    tc = TrainConfig(
        seed=args.seed, batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        freeze_layers=args.freeze_layers, save_dir=args.save_dir, ema_decay=args.ema_decay,
        warmup_steps=args.warmup_steps, adam_mu_dtype=args.adam_mu_dtype,
        contrastive_loss=args.loss, save_every_steps=args.save_every_steps,
        patch_drop=args.patch_drop, remat=args.remat, gradcache_chunks=args.gradcache_chunks,
        optimizer=args.optimizer, muon_lr_scale=args.muon_lr_scale,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha, moe=moe_cfg,
    )
    trainer = Trainer(
        cfg, clip_params, tc, classifier_params=cls_params,
        cls_cfg=ClassifierConfig(embed_dim=cfg.embed_dim, num_classes=args.num_classes),
        steps_per_epoch=steps_per_epoch, device=device, mesh=mesh, fsdp=args.fsdp,
    )
    if mesh is not None:
        print(f"mesh {mesh.shape} over {mesh.process_count} process(es)"
              + (", fsdp" if args.fsdp else ""))
    if args.save_every_steps:
        trainer.install_preemption_autosave()
    size = cfg.vision.image_size
    shard = dict(process_index=process_index, process_count=process_count)
    result = trainer.fit(
        lambda e: train_ds.batches(per_proc_bs, size, epoch=e, seed=args.seed, **shard),
        lambda e: val_ds.batches(per_proc_bs, size, shuffle=False, **shard),
        resume_from=args.resume_from,
    )
    merged = (trainer.merged_clip_params()
              if args.lora_rank > 0 and not result.get("preempted") else None)
    if process_index == 0:  # one writer: every process holds the same results
        out = pathlib.Path(args.save_dir) / "history.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=2))
        if merged is not None:
            # the adapters folded in: an ordinary CLIP tree every surface serves
            path = pathlib.Path(args.save_dir).absolute() / "lora_merged.pt"
            torch.save({"params": merged}, path)
            print(f"merged LoRA checkpoint -> {path}")
    print(f"best val loss {result['best_val_loss']:.4f} @ epoch {result['best_epoch']}")
    return result


if __name__ == "__main__":
    main()
