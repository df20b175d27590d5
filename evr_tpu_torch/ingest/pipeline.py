"""End-to-end video ingest: video → scenes → frames → embeddings → metadata
→ index and registry.

Counterpart of ``evr_tpu/ingest/pipeline.py``: the same durable artefacts
({name}_embeddings.npy, {name}_metadata.json, video_mapping.json, paths
relative to the data root), and the in-memory index and metadata store
updated in the same call so that serving sees the new video at once. The
embedding runs on the engine's device: the image tower's blocks through the
kernels on the card.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass

import numpy as np

from evr_tpu_torch.config import DataRootConfig

from .annotate import Annotator, annotate_folder
from .frames import extract_scene_frames


@dataclass
class IngestResult:
    video_name: str
    n_frames: int
    embeddings_file: str
    metadata_file: str
    frames_dir: str
    video_path: str
    fps: float


def video_fps(video_path) -> float:
    """Container fps, 25.0 when the file cannot be read."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) if cap.isOpened() else 0.0
    finally:
        cap.release()
    return fps if fps and fps > 0 else 25.0


def ingest_video(
    video_path,
    data_root: DataRootConfig,
    engine,
    index=None,
    registry=None,
    metadata_store=None,
    annotator: Annotator | None = None,
    scene_threshold: float = 30.0,
    video_name: str | None = None,
    captioner=None,
    progress=None,
) -> IngestResult:
    """``progress``: an optional ``(stage, frames_done, frames_total)``
    callback, fired at the stage boundaries (``scene_detect``,
    ``embedding``, ``annotating``, ``registering``) and per embedded chunk;
    the upload-status route reads it (``serving/jobs.py``)."""

    def report(stage, done=None, total=None):
        if progress is not None:
            progress(stage, done, total)

    video_path = pathlib.Path(video_path)
    name = video_name or video_path.stem
    data_root.ensure()
    frames_dir = data_root.frames_dir / name
    frames_dir.mkdir(parents=True, exist_ok=True)

    # 1. scene detection and one frame a scene ({frameidx}.jpg)
    report("scene_detect")
    extract_scene_frames(video_path, frames_dir, threshold=scene_threshold)

    # 2. batched embedding on the engine's device, rows sorted by file name
    report("embedding", 0)
    embeddings, frame_names = engine.embed_folder(
        frames_dir, normalise=True,
        progress=lambda done, total: report("embedding", done, total),
    )
    emb_file = data_root.embedding_dir / f"{name}_embeddings.npy"
    np.save(emb_file, embeddings)

    # 3. metadata records (pluggable annotators, optional machine captions)
    report("annotating", 0, len(frame_names))
    records = annotate_folder(frames_dir, video_path, annotator, captioner=captioner)
    report("registering", len(frame_names), len(frame_names))

    meta_file = data_root.metadata_dir / f"{name}_metadata.json"
    meta_file.write_text(json.dumps(records, indent=2, ensure_ascii=False))

    fps = video_fps(video_path)

    # 4. live state and the durable registry
    if index is not None:
        index.add_video(name, embeddings, frame_names)
    if metadata_store is not None:
        metadata_store.add_video(name, records, fps=fps)
    if registry is not None:

        def rel(p: pathlib.Path) -> str:
            # paths under the data root are stored relative to it, so the
            # data directory can be moved
            try:
                return str(pathlib.Path(p).resolve().relative_to(data_root.root.resolve()))
            except ValueError:
                return str(p)

        registry.add(
            name,
            metadata_file=rel(meta_file),
            embeddings_file=rel(emb_file),
            video_path=rel(video_path),
            frames_dir=rel(frames_dir),
            embedding_model=getattr(engine, "active_model", "original"),
        )

    return IngestResult(
        video_name=name,
        n_frames=len(frame_names),
        embeddings_file=str(emb_file),
        metadata_file=str(meta_file),
        frames_dir=str(frames_dir),
        video_path=str(video_path),
        fps=fps,
    )
