"""Frame metadata annotation: the JSON schema everything downstream reads.

Counterpart of ``evr_tpu/ingest/annotate.py``. One record a frame::

    {id (uuid), media_type, filepath, tags[], metadata{size_bytes, mime_type,
     width, height, num_channels[, caption]}, video, frameid ("1061.jpg"),
     text_detections{detections[{label, bounding_box[x, y, w, h normalised],
     confidence}]}, object_detections{...}, frameidx (int)}

OCR and object detection are pluggable host-side annotators: an
``Annotator`` returns detection lists for an image, ``NullAnnotator`` empty
ones, so ingest runs without any detector installed.
"""

from __future__ import annotations

import pathlib
import uuid
from typing import Protocol


class Annotator(Protocol):
    def __call__(self, image_path) -> dict:
        """Return {"text_detections": [...], "object_detections": [...]},
        each detection {label, bounding_box[x, y, w, h normalised],
        confidence}."""
        ...


class NullAnnotator:
    def __call__(self, image_path) -> dict:
        return {"text_detections": [], "object_detections": []}


def build_frame_record(
    image_path,
    video_path,
    frameidx: int | None = None,
    detections: dict | None = None,
    tags: list[str] | None = None,
    caption: str | None = None,
) -> dict:
    """One frame record in the reference schema (PIL reads the size, the
    mode and the MIME type)."""
    from PIL import Image

    image_path = pathlib.Path(image_path)
    detections = detections or {"text_detections": [], "object_detections": []}
    if frameidx is None:
        try:
            frameidx = int(image_path.stem)
        except ValueError:
            frameidx = 0
    with Image.open(image_path) as img:
        width, height = img.size
        mode_channels = {"RGB": 3, "RGBA": 4, "L": 1}
        channels = mode_channels.get(img.mode, len(img.getbands()))
        mime = Image.MIME.get(img.format or "JPEG", "image/jpeg")
    metadata = {
        "size_bytes": image_path.stat().st_size,
        "mime_type": mime,
        "width": width,
        "height": height,
        "num_channels": channels,
    }
    if caption:
        # a machine caption: object search scores it as the caption source
        metadata["caption"] = caption
    return {
        "id": str(uuid.uuid4()),
        "media_type": "image",
        "filepath": str(image_path),
        "tags": list(tags or []),
        "metadata": metadata,
        "video": str(video_path),
        "frameid": image_path.name,
        "text_detections": {"detections": list(detections.get("text_detections", []))},
        "object_detections": {"detections": list(detections.get("object_detections", []))},
        "frameidx": frameidx,
    }


def annotate_folder(
    frames_dir,
    video_path,
    annotator: Annotator | None = None,
    max_workers: int = 4,
    captioner=None,
) -> list[dict]:
    """Annotate every frame image in a folder, sorted by file name (the
    embedding row order), on a thread pool sharing one annotator (it must be
    thread-safe). An annotator with ``annotate_batch(paths)`` is called once
    for the folder instead (per frame if that call raises); ``captioner``
    writes a machine caption into each record's ``metadata.caption``, through
    ``caption_batch(paths)`` where it has one (per frame if that raises). A
    frame whose annotation or caption raises is skipped (no record; no
    caption)."""
    from concurrent.futures import ThreadPoolExecutor

    frames_dir = pathlib.Path(frames_dir)
    annotator = annotator or NullAnnotator()
    paths = sorted(
        p for p in frames_dir.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )

    captions: dict[pathlib.Path, str] = {}
    if captioner is not None and paths:

        def _per_frame() -> dict[pathlib.Path, str]:
            out = {}
            for p in paths:
                try:
                    out[p] = captioner(p)
                except Exception:
                    pass
            return out

        if hasattr(captioner, "caption_batch"):
            try:
                captions = dict(zip(paths, captioner.caption_batch([str(p) for p in paths])))
            except Exception:
                captions = _per_frame()
        else:
            captions = _per_frame()

    batch_dets: dict[pathlib.Path, dict] | None = None
    if hasattr(annotator, "annotate_batch") and paths:
        try:
            batch_dets = dict(zip(paths, annotator.annotate_batch(paths)))
        except Exception:
            batch_dets = None  # the per-frame protocol below

    def work(path):
        try:
            dets = batch_dets[path] if batch_dets is not None else annotator(path)
            return build_frame_record(path, video_path, detections=dets, caption=captions.get(path))
        except Exception:
            return None

    if max_workers <= 1 or batch_dets is not None:
        records = [work(p) for p in paths]
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            records = list(pool.map(work, paths))
    return [r for r in records if r is not None]
