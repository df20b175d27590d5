"""Chunked embedding export of a frame folder.

Counterpart of ``evr_tpu/tools/export_embeddings.py``: encode the folder's
frames (sorted by name) in chunks, write one ``.npy`` of unit rows and a
``.names.json`` manifest beside it::

    python -m evr_tpu_torch.tools.export_embeddings --frames-dir frames/ --out emb.npy

``--device`` picks the torch device (default cuda; ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description="export frame embeddings")
    parser.add_argument("--frames-dir", required=True)
    parser.add_argument("--out", required=True, help="output .npy path")
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--use-ema", action="store_true",
        help="the EMA weights of a Trainer checkpoint; the raw params when it has none",
    )
    parser.add_argument("--chunk-size", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    import numpy as np

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.index.engine import IMAGE_EXTENSIONS

    if args.checkpoint:
        engine = EmbeddingEngine.from_checkpoint(
            args.checkpoint, args.model, batch_size=args.batch_size, prefer_ema=args.use_ema,
            device=args.device)
    else:
        engine = EmbeddingEngine(args.model, batch_size=args.batch_size, device=args.device)

    frames_dir = pathlib.Path(args.frames_dir)
    names = sorted(p.name for p in frames_dir.iterdir() if p.suffix.lower() in IMAGE_EXTENSIONS)
    chunks = []
    for i in range(0, len(names), args.chunk_size):
        chunk = names[i : i + args.chunk_size]
        chunks.append(engine.encode_image_files([frames_dir / n for n in chunk], normalise=True))
        print(f"chunk {i // args.chunk_size}: {len(chunk)} frames")
    full = (
        np.concatenate(chunks, axis=0)
        if chunks
        else np.zeros((0, engine.cfg.embed_dim), np.float32)
    )
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, full)
    out.with_suffix(".names.json").write_text(json.dumps(names))
    print(f"wrote {out} {full.shape} and name manifest")


if __name__ == "__main__":
    main()
