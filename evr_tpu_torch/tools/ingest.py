"""Offline ingest CLI: videos → the data root's durable artefacts.

Counterpart of ``evr_tpu/tools/ingest.py``::

    python -m evr_tpu_torch.tools.ingest --data-root data video1.mp4 video2.mp4

writes the {name}_embeddings.npy / {name}_metadata.json / video_mapping.json
layout the serving tier boots from (either package's). ``--uniform N``
samples N frames per video besides the scene frames. ``--device`` picks the
torch device (default cuda; ``--device cpu`` runs on the CPU).
``--zeroshot-objects`` and ``--local-ocr on`` need annotators not ported yet
(ROADMAP A17) and are refused; ``--local-ocr auto`` ingests without OCR.
"""

from __future__ import annotations

import argparse
import pathlib


def main(argv=None):
    parser = argparse.ArgumentParser(description="ingest videos into a data root")
    parser.add_argument("videos", nargs="+")
    parser.add_argument("--data-root", default="data")
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--use-ema", action="store_true",
        help="the EMA weights of a Trainer checkpoint (payload['ema'], written by "
        "finetune --ema-decay); the raw params when it has none",
    )
    parser.add_argument("--scene-threshold", type=float, default=30.0)
    parser.add_argument("--uniform", type=int, default=None,
                        help="also sample N frames uniformly from each video")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the towers and the index (default cuda; fails without a "
        "card unless cpu is given)",
    )
    parser.add_argument("--zeroshot-objects", action="store_true",
                        help="the zero-shot object annotator: not ported (ROADMAP A17)")
    parser.add_argument("--local-ocr", default="auto", choices=("auto", "on", "off"),
                        help="the local OCR annotator: not ported (ROADMAP A17); auto and off "
                        "ingest without it")
    args = parser.parse_args(argv)
    if args.zeroshot_objects:
        parser.error("--zeroshot-objects is not ported to evr_tpu_torch yet (ROADMAP A17: "
                     "the zero-shot object annotator)")
    if args.local_ocr == "on":
        parser.error("--local-ocr on is not ported to evr_tpu_torch yet (ROADMAP A17: "
                     "the OCR annotator)")

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex, VideoRegistry
    from evr_tpu_torch.ingest import extract_uniform_frames, ingest_video
    from evr_tpu_torch.query.metadata import MetadataStore

    if args.checkpoint:
        engine = EmbeddingEngine.from_checkpoint(
            args.checkpoint, args.model, prefer_ema=args.use_ema, device=args.device)
    else:
        engine = EmbeddingEngine(args.model, device=args.device)
    data_root = DataRootConfig(args.data_root).ensure()
    registry = VideoRegistry(data_root.mapping_path)
    index = FrameIndex(embed_dim=engine.cfg.embed_dim, device=engine.device)
    store = MetadataStore()

    for video in args.videos:
        if args.uniform:
            extract_uniform_frames(video, data_root.frames_dir / pathlib.Path(video).stem, args.uniform)
        result = ingest_video(
            video, data_root, engine, index, registry, store,
            scene_threshold=args.scene_threshold,
        )
        print(f"{result.video_name}: {result.n_frames} frames, fps={result.fps:.2f} → "
              f"{result.embeddings_file}")
    print(f"index now holds {index.total_frames} frames across {len(index.videos)} videos")


if __name__ == "__main__":
    main()
