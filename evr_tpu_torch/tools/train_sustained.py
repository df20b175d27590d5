"""Sustained fine-tune with a measured retrieval lift, on one device.

Runs a few hundred production train steps (``training/finetune.py``
``make_train_step``: freeze-prefix AdamW groups, clipping, the finite guard,
bf16 towers) at ViT-B/32 geometry and records:

  * sustained examples/s over the run: the batch pool goes to the device
    once and a Python loop cycles it (the JAX tool scans it), so the figure
    measures the steps, not the host's feeding; and
  * text→image R@1/R@5/R@10 on a held-out set before and after.

The model starts from random weights and the data is a procedurally
generated compositional corpus (color × shape × position × background
scenes with templated captions), so the lift is attributable to the
training step alone:

    python -m evr_tpu_torch.tools.train_sustained [--steps 320] [--batch 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

COLORS = {
    "red": (0, 0, 220), "green": (0, 200, 0), "blue": (230, 80, 0),
    "yellow": (0, 215, 255), "white": (240, 240, 240),
}
SHAPES = ("circle", "square", "triangle", "cross")
POSITIONS = ("top left", "top right", "bottom left", "bottom right", "center")
BACKGROUNDS = {"black": (0, 0, 0), "gray": (90, 90, 90), "navy": (60, 20, 20)}


def render_scene(rng: np.random.Generator, color: str, shape: str,
                 pos: str, bg: str, size: int) -> np.ndarray:
    """One [size, size, 3] RGB uint8 scene; geometry jittered per sample so
    the mapping caption→pixels is a distribution, not a lookup table."""
    import cv2

    img = np.zeros((size, size, 3), np.uint8)
    img[:] = BACKGROUNDS[bg]
    cx = {"left": size // 4, "right": 3 * size // 4, "center": size // 2}
    cy = {"top": size // 4, "bottom": 3 * size // 4, "center": size // 2}
    px = cx["center"] if pos == "center" else cx[pos.split()[1]]
    py = cy["center"] if pos == "center" else cy[pos.split()[0]]
    px += int(rng.integers(-size // 16, size // 16 + 1))
    py += int(rng.integers(-size // 16, size // 16 + 1))
    r = int(size * (0.10 + 0.05 * rng.random()))
    c = COLORS[color]
    if shape == "circle":
        cv2.circle(img, (px, py), r, c, -1)
    elif shape == "square":
        cv2.rectangle(img, (px - r, py - r), (px + r, py + r), c, -1)
    elif shape == "triangle":
        pts = np.array([[px, py - r], [px - r, py + r], [px + r, py + r]])
        cv2.fillPoly(img, [pts], c)
    else:  # cross
        t = max(2, r // 3)
        cv2.rectangle(img, (px - r, py - t), (px + r, py + t), c, -1)
        cv2.rectangle(img, (px - t, py - r), (px + t, py + r), c, -1)
    return img[:, :, ::-1]  # BGR -> RGB


def make_dataset(n: int, size: int, seed: int = 0):
    """(images uint8 [n, size, size, 3], captions list[str], labels [n],
    keys) — label = shape id (drives the classifier head the production
    config carries)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    caps, labels = [], np.zeros((n,), np.int32)
    keys = []
    for i in range(n):
        color = list(COLORS)[rng.integers(len(COLORS))]
        shape = SHAPES[rng.integers(len(SHAPES))]
        pos = POSITIONS[rng.integers(len(POSITIONS))]
        bg = list(BACKGROUNDS)[rng.integers(len(BACKGROUNDS))]
        imgs[i] = render_scene(rng, color, shape, pos, bg, size)
        caps.append(f"a {color} {shape} in the {pos} on a {bg} background")
        labels[i] = SHAPES.index(shape)
        keys.append((color, shape, pos, bg))
    return imgs, caps, labels, keys


def retrieval_at_k(img_feats: np.ndarray, txt_feats: np.ndarray, ks=(1, 5, 10)) -> dict:
    """Text→image retrieval on matched pairs (row i ↔ row i)."""
    sims = txt_feats @ img_feats.T
    order = np.argsort(-sims, axis=1)
    n = len(sims)
    gold = np.arange(n)[:, None]
    return {f"R@{k}": float(np.mean((order[:, :k] == gold).any(axis=1))) for k in ks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=320)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--pool", type=int, default=32,
                    help="device-resident batch pool cycled through the run")
    ap.add_argument("--holdout", type=int, default=256)
    ap.add_argument("--model", default="ViT-B/32")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; fails without a card unless cpu is given)")
    args = ap.parse_args(argv)

    import torch

    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.models.clip import encode_image, encode_text, init_clip_params
    from evr_tpu_torch.models.convert import params_from_numpy
    from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from evr_tpu_torch.tokenizer import tokenize
    from evr_tpu_torch.training.finetune import TrainConfig, TrainState, make_optimizer, make_train_step
    from evr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model_cfg = get_model_config(args.model)
    size = model_cfg.vision.image_size
    B, pool = args.batch, args.pool
    print(f"model {args.model}  B={B}  pool={pool} device-resident batches  "
          f"steps={args.steps}", flush=True)

    n_train = B * pool
    t0 = time.perf_counter()
    imgs, caps, labels, _ = make_dataset(n_train + args.holdout, size, seed=args.seed)
    toks = np.asarray(tokenize(caps, context_length=model_cfg.text.context_length), np.int32)
    print(f"dataset: {n_train} train + {args.holdout} holdout scenes "
          f"rendered in {time.perf_counter() - t0:.1f}s", flush=True)

    tc = TrainConfig(
        batch_size=B, freeze_layers=0, lr=args.lr, compute_dtype="bfloat16",
        warmup_steps=20, epochs=10_000,  # flat-ish cosine over the run
    )
    cls_cfg = ClassifierConfig(embed_dim=model_cfg.embed_dim, num_classes=len(SHAPES))
    params = params_from_numpy({
        "clip": init_clip_params(args.seed, model_cfg),
        "classifier": init_classifier_params(args.seed + 1, cls_cfg),
    }, device)
    opt = make_optimizer(tc, params, steps_per_epoch=pool)
    step, _ = make_train_step(model_cfg, cls_cfg, tc, opt)

    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device)

    @torch.no_grad()
    def encode_holdout(p, imgs_d, toks_d):
        x = (imgs_d.float() / 255.0 - mean) / std
        im = encode_image(p["clip"], model_cfg, x, dtype=torch.bfloat16)
        tx = encode_text(p["clip"], model_cfg, toks_d, dtype=torch.bfloat16)
        im = im / im.norm(dim=-1, keepdim=True)
        tx = tx / tx.norm(dim=-1, keepdim=True)
        return im.float().cpu().numpy(), tx.float().cpu().numpy()

    ho = slice(n_train, n_train + args.holdout)
    ho_imgs = torch.from_numpy(imgs[ho]).to(device)
    ho_toks = torch.from_numpy(toks[ho]).to(device)
    before = retrieval_at_k(*encode_holdout(params, ho_imgs, ho_toks))
    print(f"before: {before}  (chance R@5 = {5 / args.holdout:.3f})", flush=True)

    # ---- the sustained run: the device-resident pool, cycled ----------------
    pool_imgs = torch.from_numpy(imgs[:n_train].reshape(pool, B, size, size, 3)).to(device)
    pool_toks = torch.from_numpy(toks[:n_train].reshape(pool, B, -1)).to(device)
    pool_labels = torch.from_numpy(labels[:n_train].reshape(pool, B)).to(device)
    print(f"batch pool resident: {pool_imgs.numel() / 1e9:.2f} GB uploaded once", flush=True)

    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)

    def run_pool():
        losses = []
        for i in range(pool):
            _, m = step(state, {"images": pool_imgs[i], "tokens": pool_toks[i], "labels": pool_labels[i]},
                        generator)
            losses.append(m["total_loss"])
        return [float(v) for v in torch.stack(losses).cpu()]

    cycles = max(1, args.steps // pool)
    # the first cycle warms the allocator and the kernels' first calls: left
    # out of the sustained figure
    t0 = time.perf_counter()
    losses = run_pool()
    first_loss = losses[0]
    print(f"cycle 1/{cycles}: {pool} steps, first loss {first_loss:.3f}, last {losses[-1]:.3f} "
          f"(incl. warm-up: {time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    done = pool
    for c in range(1, cycles):
        losses = run_pool()
        done += pool
        print(f"cycle {c + 1}/{cycles}: loss {losses[-1]:.3f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sustained = (done - pool) * B / max(1e-9, time.perf_counter() - t0)
    print(f"sustained: {sustained:,.0f} ex/s over {done - pool} post-warm-up "
          f"steps (total {done} steps incl. warm cycle)", flush=True)

    after = retrieval_at_k(*encode_holdout(state.params, ho_imgs, ho_toks))
    print(f"after:  {after}", flush=True)
    print(f"LIFT: R@5 {before['R@5']:.3f} -> {after['R@5']:.3f}  "
          f"R@1 {before['R@1']:.3f} -> {after['R@1']:.3f}  "
          f"({done} steps, holdout {args.holdout})", flush=True)
    return {"before": before, "after": after, "sustained_ex_per_s": sustained, "steps": done,
            "first_loss": first_loss, "last_loss": losses[-1]}


if __name__ == "__main__":
    main()
