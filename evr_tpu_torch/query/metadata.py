"""Per-video frame-metadata store: O(1) frame lookups by frame index.

Counterpart of the JAX package's ``query/metadata.py``, cut to what the two
ported strategies read: each video's metadata JSON is parsed once into a
frame-index map, and the events carry the raw record. The pre-folded label
structures behind the keyword, object and speech strategies are not ported
yet.

Frame-record schema (produced by the ingestion annotator): ``{id,
media_type, filepath, tags[], metadata{...}, video, frameid,
text_detections{detections[{label, bounding_box, confidence}]},
object_detections{...}, frameidx}``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FrameRecord:
    raw: dict
    frameidx: int
    frameid: str


class MetadataStore:
    """All videos' frame metadata, indexed by frame index."""

    def __init__(self):
        self._by_frameidx: dict[str, dict[int, FrameRecord]] = {}
        self._fps: dict[str, float] = {}

    def add_video(self, name: str, records: list[dict], fps: float = 25.0) -> None:
        frames = [
            FrameRecord(raw=rec, frameidx=int(rec.get("frameidx", 0)),
                        frameid=str(rec.get("frameid", "")))
            for rec in records
        ]
        self._by_frameidx[name] = {f.frameidx: f for f in frames}
        self._fps[name] = fps

    def remove_video(self, name: str) -> None:
        """Forget a video's frames (the registry self-heal prune calls it)."""
        self._by_frameidx.pop(name, None)
        self._fps.pop(name, None)

    def videos(self) -> list[str]:
        return list(self._by_frameidx)

    def frame_by_idx(self, video: str, frameidx: int) -> FrameRecord | None:
        return self._by_frameidx.get(video, {}).get(frameidx)

    def fps(self, video: str) -> float:
        return self._fps.get(video, 25.0)
