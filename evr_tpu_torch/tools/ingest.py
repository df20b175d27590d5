"""Offline ingest CLI: videos → the data root's durable artefacts.

Counterpart of ``evr_tpu/tools/ingest.py``::

    python -m evr_tpu_torch.tools.ingest --data-root data video1.mp4 video2.mp4

writes the {name}_embeddings.npy / {name}_metadata.json / video_mapping.json
layout the serving tier boots from (either package's). ``--uniform N``
samples N frames per video besides the scene frames. ``--device`` picks the
torch device (default cuda; ``--device cpu`` runs on the CPU) of the towers,
the index and the OCR recogniser. ``--zeroshot-objects`` fills each frame's
``object_detections`` (``ingest/zeroshot.py``); ``--local-ocr`` fills
``text_detections`` (``ingest/ocr.py``): ``auto`` (the default) when the
package's checkpoint exists, ``on`` always, ``off`` never.
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
    parser.add_argument(
        "--zeroshot-objects", action="store_true",
        help="fill object_detections with zero-shot CLIP region classification "
        "(COCO-80 vocabulary; ingest/zeroshot.py) instead of YOLO",
    )
    parser.add_argument(
        "--local-ocr", default="auto", choices=("auto", "on", "off"),
        help="fill text_detections with the zero-egress OCR (ingest/ocr.py; a CTC "
        "recogniser over host-detected line boxes); auto = on when the package's "
        "checkpoint exists (it ships with the repo)",
    )
    args = parser.parse_args(argv)

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex, VideoRegistry
    from evr_tpu_torch.ingest import extract_uniform_frames, ingest_video
    from evr_tpu_torch.ingest.annotators import build_annotator
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
    annotator = build_annotator(engine, args.zeroshot_objects, args.local_ocr, device=args.device)

    for video in args.videos:
        if args.uniform:
            extract_uniform_frames(video, data_root.frames_dir / pathlib.Path(video).stem, args.uniform)
        result = ingest_video(
            video, data_root, engine, index, registry, store,
            annotator=annotator, scene_threshold=args.scene_threshold,
        )
        print(f"{result.video_name}: {result.n_frames} frames, fps={result.fps:.2f} → "
              f"{result.embeddings_file}")
    print(f"index now holds {index.total_frames} frames across {len(index.videos)} videos")


if __name__ == "__main__":
    main()
