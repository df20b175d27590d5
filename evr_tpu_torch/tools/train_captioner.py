"""SCST captioner CLI (PyTorch).

``python -m evr_tpu_torch.tools.train_captioner --embeddings frames.npy
--captions captions.json --xe-epochs 5 --scst-epochs 3`` warm-starts a
prefix captioner on (frame embedding, caption) pairs with teacher forcing,
then runs self-critical sequence training against the frozen CLIP text
tower (greedy baseline, CLIP cosine ×100 reward, an early stop at the
target reward), writing ``<save-dir>/scst_epoch<n>.pt``,
``scst_final.pt`` and ``history.json`` (the counterpart of
``evr_tpu/tools/train_captioner.py``, which writes orbax directories).

``--embeddings`` is an ``(N, D)`` .npy (rows L2-normalised here);
``--captions`` a JSON list of captions aligned with the rows (for the XE
warm start only). ``--device`` defaults to ``cuda``; ``--device cpu`` runs
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SCST caption-RL fine-tune (PyTorch)")
    parser.add_argument("--embeddings", required=True, help="(N, D) .npy of frame embeddings")
    parser.add_argument("--captions", default=None,
                        help="JSON list of captions aligned with rows (XE warm start)")
    parser.add_argument("--val-fraction", type=float, default=0.1)
    parser.add_argument("--model", default="ViT-B/32", help="reward CLIP config")
    parser.add_argument("--clip-checkpoint", default=None, help=".pt with the reward CLIP weights")
    parser.add_argument("--xe-epochs", type=int, default=0)
    parser.add_argument("--scst-epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-5)
    parser.add_argument("--advantage-scale", type=float, default=0.01)
    parser.add_argument("--target-reward", type=float, default=40.0)
    parser.add_argument("--max-new-tokens", type=int, default=30)
    parser.add_argument("--prefix-len", type=int, default=10)
    parser.add_argument("--cap-width", type=int, default=512)
    parser.add_argument("--cap-layers", type=int, default=4)
    parser.add_argument("--cap-heads", type=int, default=8)
    parser.add_argument("--save-dir", default="checkpoints_scst")
    parser.add_argument("--demo", type=int, default=3, help="decode this many captions at the end")
    parser.add_argument("--beam-size", type=int, default=1,
                        help="demo decode beam width (1 = greedy; >1 uses beam_search)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    return parser


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from evr_tpu_torch.models import get_model_config, init_clip_params
    from evr_tpu_torch.models.captioner import CaptionerConfig, beam_search, decode_tokens, generate
    from evr_tpu_torch.tokenizer import get_default_tokenizer
    from evr_tpu_torch.training.scst import ScstConfig, ScstTrainer, encode_captions

    feats = np.load(args.embeddings).astype(np.float32)
    feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-8)
    clip_cfg = get_model_config(args.model)
    if 1 + args.max_new_tokens > clip_cfg.text.context_length:
        raise SystemExit(
            f"--max-new-tokens {args.max_new_tokens} overflows the reward tower's "
            f"{clip_cfg.text.context_length}-token context (max {clip_cfg.text.context_length - 1})")
    if args.clip_checkpoint:
        from evr_tpu_torch.models.torch_import import load_checkpoint

        clip_params = load_checkpoint(args.clip_checkpoint)["clip"]
    else:
        print("WARNING: no --clip-checkpoint; reward model is randomly initialised")
        clip_params = init_clip_params(args.seed, clip_cfg)
    cap_cfg = CaptionerConfig(image_dim=feats.shape[1], width=args.cap_width, layers=args.cap_layers,
                              heads=args.cap_heads, prefix_len=args.prefix_len,
                              max_new_tokens=args.max_new_tokens)
    cfg = ScstConfig(lr=args.lr, advantage_scale=args.advantage_scale, target_reward=args.target_reward,
                     batch_size=args.batch_size, save_dir=args.save_dir)
    trainer = ScstTrainer(clip_params, clip_cfg, cap_cfg=cap_cfg, cfg=cfg, seed=args.seed, device=args.device)

    n_val = max(1, int(len(feats) * args.val_fraction))
    train_feats, val_feats = feats[n_val:], feats[:n_val]
    if args.captions and args.xe_epochs > 0:
        captions = json.loads(pathlib.Path(args.captions).read_text())
        if len(captions) != len(feats):
            raise SystemExit(f"--captions has {len(captions)} entries for {len(feats)} embeddings")
        toks = encode_captions(captions, cap_cfg)
        losses = trainer.pretrain_xe(feats[n_val:], toks[n_val:], epochs=args.xe_epochs)
        print(f"XE warm start: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    history = trainer.fit(train_feats, val_features=val_feats, epochs=args.scst_epochs, seed=args.seed + 1,
                          save_checkpoints=True)
    for h in history:
        print(f"epoch {h['epoch'] + 1}: train reward {h['train_reward']:.2f}"
              + (f", val reward {h['val_reward']:.2f}" if "val_reward" in h else ""))
    if args.demo > 0:
        demo = torch.from_numpy(feats[: args.demo]).to(trainer.device)
        if args.beam_size > 1:
            toks, _ = beam_search(trainer.params, cap_cfg, demo, beam_size=args.beam_size)
        else:
            toks, _ = generate(trainer.params, cap_cfg, demo, sample=False)
        for i, text in enumerate(decode_tokens(get_default_tokenizer(), toks, cap_cfg.eot_id)):
            print(f"demo[{i}]: {text!r}")
    out = pathlib.Path(args.save_dir) / "history.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(history, indent=2))
    return history


if __name__ == "__main__":
    main()
