"""Frame extraction from videos.

Counterpart of ``evr_tpu/ingest/frames.py``:

- ``extract_scene_frames``, the upload path: one frame per detected scene,
  the scene's middle frame, written as ``{frame_idx}.jpg``. The frame index
  as the file name is load-bearing: retrieval maps names back to frame
  numbers, and index rows follow the sorted names;
- ``extract_uniform_frames``, the offline path: ``np.linspace`` sampling of
  N frames per clip.
"""

from __future__ import annotations

import pathlib

import numpy as np

from .scene import ContentDetectorConfig, detect_scenes


def _grab_frame(cap, frame_idx: int):
    import cv2

    cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
    ok, frame = cap.read()
    return frame if ok else None


def extract_scene_frames(
    video_path,
    out_dir,
    threshold: float = 30.0,
    min_scene_len: int = 15,
) -> list[int]:
    """Scene-detect and save each scene's middle frame. Returns the saved
    frame indices (the file names' stems, ascending)."""
    import cv2

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scenes = detect_scenes(
        video_path, ContentDetectorConfig(threshold=threshold, min_scene_len=min_scene_len)
    )
    saved: list[int] = []
    cap = cv2.VideoCapture(str(video_path))
    try:
        for start, end in scenes:
            mid = (start + end) // 2
            frame = _grab_frame(cap, mid)
            if frame is None:
                continue
            cv2.imwrite(str(out_dir / f"{mid}.jpg"), frame)
            saved.append(mid)
    finally:
        cap.release()
    return saved


def extract_uniform_frames(
    video_path,
    out_dir,
    frames_per_video: int = 16,
    prefix: str = "",
) -> list[int]:
    """Uniformly sample N frames (``np.linspace`` over the clip)."""
    import cv2

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            return []
        picks = np.unique(np.linspace(0, total - 1, min(frames_per_video, total)).astype(int))
        saved = []
        for idx in picks:
            frame = _grab_frame(cap, int(idx))
            if frame is None:
                continue
            cv2.imwrite(str(out_dir / f"{prefix}{int(idx)}.jpg"), frame)
            saved.append(int(idx))
        return saved
    finally:
        cap.release()
