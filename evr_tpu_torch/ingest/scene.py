"""Content-delta scene detection (PySceneDetect ContentDetector semantics).

Counterpart of ``evr_tpu/ingest/scene.py``. Per frame: convert to HSV, take
the mean absolute per-pixel delta of each channel against the previous
frame, average the three channel deltas (the "content value", float64), and
cut where it reaches the threshold, subject to a minimum scene length.
Frames are downscaled before the delta (about max dim / 256), as
PySceneDetect does by default. numpy and cv2 only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ContentDetectorConfig:
    threshold: float = 30.0  # the upload default
    min_scene_len: int = 15  # frames, PySceneDetect's default
    downscale: int | None = None  # None: auto (~max dim / 256)


def _content_val(prev_hsv: np.ndarray, cur_hsv: np.ndarray) -> float:
    delta = np.abs(cur_hsv.astype(np.int16) - prev_hsv.astype(np.int16))
    return float(delta.reshape(-1, 3).mean(axis=0).sum()) / 3.0


def _auto_downscale(width: int) -> int:
    return max(1, width // 256)


def content_curve(video_path, config: ContentDetectorConfig | None = None) -> np.ndarray:
    """Per-frame content values, float64 (frame 0 has no predecessor: 0.0);
    empty for a video with no frame. ``detect_scenes`` is a threshold and
    minimum-length walk over this curve (``cuts_from_curve``)."""
    import cv2

    cfg = config or ContentDetectorConfig()
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")

    values: list[float] = [0.0]
    prev_hsv = None
    factor = cfg.downscale
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if factor is None:
                factor = _auto_downscale(frame.shape[1])
            if factor > 1:
                frame = frame[::factor, ::factor]
            hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)
            if prev_hsv is not None:
                values.append(_content_val(prev_hsv, hsv))
            prev_hsv = hsv
    finally:
        cap.release()
    if prev_hsv is None:
        return np.zeros((0,), np.float64)
    return np.asarray(values, np.float64)


def cuts_from_curve(values: np.ndarray, threshold: float, min_scene_len: int) -> list[int]:
    """Threshold walk: cut at frame i when values[i] >= threshold and the
    previous cut (or the start) is at least ``min_scene_len`` frames back."""
    cuts: list[int] = []
    last_cut = 0
    for i in range(1, len(values)):
        if values[i] >= threshold and i - last_cut >= min_scene_len:
            cuts.append(i)
            last_cut = i
    return cuts


def detect_scenes(video_path, config: ContentDetectorConfig | None = None) -> list[tuple[int, int]]:
    """[(start_frame, end_frame), ...) scene spans, end exclusive."""
    cfg = config or ContentDetectorConfig()
    values = content_curve(video_path, cfg)
    total = len(values)
    if total == 0:
        return []
    bounds = [0] + cuts_from_curve(values, cfg.threshold, cfg.min_scene_len) + [total]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
