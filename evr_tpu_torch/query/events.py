"""EventData formatting for the frontend (copy of the JAX package's
``query/events.py``; the port keeps its own).

Behavior-for-behavior port of ``DataService.format_event_for_frontend``
(`Backend/services/data_service.py:147-251`), the response contract the React
frontend consumes:

- category/description from the best text detection, overridden by the best
  object detection when its confidence is higher;
- fused ``confidence`` = max(text, object, clip) in that override order;
- ``timestamp = frameidx / fps`` — but fps comes from the MetadataStore
  (cached per video) instead of reopening the video with cv2 per event
  (`data_service.py:218-227`, a per-result hot-loop file open).
"""

from __future__ import annotations

import re


def _video_stem(path: str) -> str:
    """Filename stem robust to both separators — reference metadata carries
    Windows-absolute video paths (e.g. `Backend/metadata/video_mapping.json`)
    that must still resolve on POSIX hosts."""
    base = re.split(r"[\\/]", path)[-1]
    return base.rsplit(".", 1)[0] if "." in base else base


def format_event_for_frontend(frame_data: dict, fps: float = 25.0) -> dict:
    video_path = frame_data.get("video", "")
    if video_path:
        video_id = f"video-{_video_stem(video_path)}"
    else:
        video_id = "unknown"

    category = "Unknown"
    confidence = 0.7
    text_confidence = 0.0
    object_confidence = 0.0
    description = "Event detected"
    detection_type = "unknown"

    text_dets = (frame_data.get("text_detections") or {}).get("detections") or []
    if text_dets:
        best = max(text_dets, key=lambda d: d.get("confidence", 0))
        label = best.get("label") or ""
        category = label.split(" ")[0] if label else "Unknown"
        text_confidence = float(best.get("confidence", 0.7))
        description = label or "Event detected"
        detection_type = "text"
        confidence = text_confidence

    obj_dets = (frame_data.get("object_detections") or {}).get("detections") or []
    if obj_dets:
        best = max(obj_dets, key=lambda d: d.get("confidence", 0))
        object_confidence = float(best.get("confidence", 0.5))
        if object_confidence > text_confidence:
            category = best.get("label", "Unknown")
            description = f"Object detected: {category}"
            detection_type = "object"
            confidence = object_confidence

    clip_similarity = float(frame_data.get("clip_similarity") or 0.0)
    if clip_similarity > confidence:
        detection_type = "clip"
        confidence = clip_similarity

    frame_idx = int(frame_data.get("frameidx", 0))
    timestamp = frame_idx / fps if fps > 0 else 0.0

    return {
        "id": f"event-{frame_idx}",
        "videoId": video_id,
        "title": f"Event at frame {frame_idx}",
        "description": description,
        "timestamp": float(timestamp),
        "duration": 5,
        "category": category,
        "confidence": float(confidence),
        "text_confidence": float(text_confidence),
        "object_confidence": float(object_confidence),
        "clip_similarity": clip_similarity,
        "detection_type": detection_type,
        "thumbnailUrl": frame_data.get("filepath"),
    }
