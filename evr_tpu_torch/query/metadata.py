"""Per-video frame-metadata store with precomputed match structures (copy of
the JAX package's ``query/metadata.py``).

The reference re-reads the metadata JSON per request and scans it linearly
per candidate frame (`Backend/query_strategies.py:148-157`: O(k·N)
``next(item for item in data if frameidx == ...)``) and recomputes
accent-folding per detection per query. Here each video's metadata is parsed
once into O(1) lookup maps with pre-folded label strings, so every strategy
is a dictionary probe.

Frame-record schema (produced by the ingestion annotator, identical to
`Backend/JSON_sample_DOC.py:72-84`):
``{id, media_type, filepath, tags[], metadata{...}, video, frameid,
text_detections{detections[{label, bounding_box, confidence}]},
object_detections{...}, frameidx}``.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field

from .text import fold_accents

# Confidence constants for non-detector match sources
# (`query_strategies.py:411-440`): caption hit = 0.65, tag hit = 0.75,
# OCR-text hit scaled by 0.7.
CAPTION_CONF = 0.65
TAG_CONF = 0.75
OCR_OBJECT_SCALE = 0.7
# ASR transcript hit: between caption (0.65) and tag (0.75) — transcripts
# are machine-generated like captions but time-anchored like detections.
# (Beyond-reference: the reference's Whisper probe, `content/file_test_prob/
# test_subtitles.py`, never fed transcripts into search.)
SPEECH_CONF = 0.70


@dataclass
class FrameRecord:
    raw: dict
    frameidx: int
    frameid: str
    # pre-folded lowercase strings
    text_labels: list[tuple[str, str, float]] = field(default_factory=list)  # (label_lower, folded, conf)
    object_labels: list[tuple[str, str, float]] = field(default_factory=list)
    tags: list[tuple[str, str]] = field(default_factory=list)  # (lower, folded)
    caption: tuple[str, str] | None = None  # (lower, folded)


def _fold_pair(s: str) -> tuple[str, str]:
    low = s.lower()
    return low, fold_accents(low)


class MetadataStore:
    """All videos' frame metadata, indexed for O(1) strategy lookups."""

    def __init__(self):
        self._videos: dict[str, list[FrameRecord]] = {}
        self._by_frameidx: dict[str, dict[int, FrameRecord]] = {}
        self._by_frameid: dict[str, dict[str, FrameRecord]] = {}
        self._fps: dict[str, float] = {}
        # ASR transcripts: per video, time-ordered (start, end, text_lower,
        # text_folded, text_original) segments
        self._transcripts: dict[str, list[tuple[float, float, str, str, str]]] = {}

    # -- loading ----------------------------------------------------------
    def add_video(self, name: str, records: list[dict], fps: float = 25.0) -> None:
        frames = []
        for rec in records:
            fr = FrameRecord(
                raw=rec,
                frameidx=int(rec.get("frameidx", 0)),
                frameid=str(rec.get("frameid", "")),
            )
            for det in rec.get("text_detections", {}).get("detections", []) or []:
                low, folded = _fold_pair(str(det.get("label", "")))
                fr.text_labels.append((low, folded, float(det.get("confidence", 0.0))))
            for det in rec.get("object_detections", {}).get("detections", []) or []:
                low, folded = _fold_pair(str(det.get("label", "")))
                fr.object_labels.append((low, folded, float(det.get("confidence", 0.0))))
            for tag in rec.get("tags", []) or []:
                fr.tags.append(_fold_pair(str(tag)))
            caption = (rec.get("metadata") or {}).get("caption", "")
            if caption:
                fr.caption = _fold_pair(str(caption))
            frames.append(fr)
        self._videos[name] = frames
        self._by_frameidx[name] = {f.frameidx: f for f in frames}
        self._by_frameid[name] = {f.frameid: f for f in frames}
        self._fps[name] = fps

    def load_video_json(self, name: str, path, fps: float = 25.0) -> None:
        records = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
        self.add_video(name, records, fps)

    def add_transcript(self, name: str, segments: list[dict]) -> None:
        """Attach ASR transcript segments (``ingest/transcripts.py`` schema:
        ``[{"start": s, "end": s, "text": str}, ...]``) to a video. Text is
        pre-folded once; segments are kept time-sorted for the per-frame
        timestamp probe."""
        segs = []
        for seg in segments:
            text = str(seg.get("text", "")).strip()
            if not text:
                continue
            low, folded = _fold_pair(text)
            segs.append(
                (float(seg.get("start", 0.0)), float(seg.get("end", 0.0)),
                 low, folded, text)
            )
        segs.sort(key=lambda s: s[0])
        self._transcripts[name] = segs

    def load_transcript_json(self, name: str, path) -> None:
        payload = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
        if isinstance(payload, dict):
            payload = payload.get("segments", [])
        self.add_transcript(name, payload)

    def has_transcript(self, video: str) -> bool:
        return bool(self._transcripts.get(video))

    def remove_video(self, name: str) -> None:
        """Forget a video's frames AND transcript. Called by the registry
        self-heal prune — without this, keyword/object/speech searches keep
        returning events for videos whose ids no longer resolve (the
        reference's `data_service.py:147-251` has the same staleness bug)."""
        self._videos.pop(name, None)
        self._by_frameidx.pop(name, None)
        self._by_frameid.pop(name, None)
        self._fps.pop(name, None)
        self._transcripts.pop(name, None)

    # -- lookups ----------------------------------------------------------
    def videos(self) -> list[str]:
        return list(self._videos)

    def frames(self, video: str) -> list[FrameRecord]:
        return self._videos.get(video, [])

    def frame_by_idx(self, video: str, frameidx: int) -> FrameRecord | None:
        return self._by_frameidx.get(video, {}).get(frameidx)

    def frame_by_id(self, video: str, frameid: str) -> FrameRecord | None:
        return self._by_frameid.get(video, {}).get(frameid)

    def fps(self, video: str) -> float:
        return self._fps.get(video, 25.0)

    def set_fps(self, video: str, fps: float) -> None:
        self._fps[video] = fps

    # -- match primitives -------------------------------------------------
    @staticmethod
    def _contains(needle_low: str, needle_folded: str, hay_low: str, hay_folded: str) -> bool:
        return needle_low in hay_low or needle_folded in hay_folded

    def keyword_best_match(self, frame: FrameRecord, keyword: str) -> float:
        """Best OCR-text confidence whose label contains the keyword
        (accent-insensitive), 0.0 if none — `search_service.py:25-58` /
        `query_strategies.py:215-231` semantics (match on folded text)."""
        folded = fold_accents(keyword.lower())
        best = 0.0
        for _low, lab_folded, conf in frame.text_labels:
            if folded in lab_folded and conf > best:
                best = conf
        return best

    def keyword_frames(self, video: str, keyword: str, limit: int | None = None) -> list[str]:
        """frameids whose OCR text contains the keyword (accent-insensitive)."""
        out = []
        for fr in self._videos.get(video, []):
            if self.keyword_best_match(fr, keyword) > 0.0:
                out.append(fr.frameid)
                if limit is not None and len(out) >= limit:
                    break
        return out

    def speech_matches(
        self, video: str, keyword: str
    ) -> list[tuple[float, float, str]]:
        """Transcript segments whose text contains the keyword
        (accent-insensitive, same `_contains` semantics as every other text
        source) → time-sorted ``(start, end, original_text)``."""
        q_low = keyword.lower()
        q_folded = fold_accents(q_low)
        return [
            (start, end, text)
            for start, end, low, folded, text in self._transcripts.get(video, [])
            if self._contains(q_low, q_folded, low, folded)
        ]

    def speech_best_match(
        self, video: str, frame: FrameRecord, keyword: str
    ) -> tuple[float, str]:
        """(confidence, segment text) for the transcript segment covering the
        frame's timestamp (frameidx/fps) when it contains the keyword;
        (0.0, "") otherwise. Confidence is the flat SPEECH_CONF — ASR output
        carries no per-word score on the greedy path."""
        t = frame.frameidx / self.fps(video)
        q_low = keyword.lower()
        q_folded = fold_accents(q_low)
        for start, end, low, folded, text in self._transcripts.get(video, []):
            if start <= t < end and self._contains(q_low, q_folded, low, folded):
                return SPEECH_CONF, text
        return 0.0, ""

    def speech_frames(
        self, video: str, keyword: str, limit: int | None = None
    ) -> list[tuple[FrameRecord, str]]:
        """Frames whose timestamp falls inside a keyword-matching transcript
        segment → ``(frame, segment_text)`` in frame order. O(F + S) merge
        over the time-sorted frames and segments."""
        segs = self.speech_matches(video, keyword)
        if not segs:
            return []
        fps = self.fps(video)
        out = []
        si = 0
        for fr in sorted(self._videos.get(video, []), key=lambda f: f.frameidx):
            t = fr.frameidx / fps
            while si < len(segs) and segs[si][1] <= t:
                si += 1
            if si >= len(segs):
                break
            start, end, text = segs[si]
            if start <= t < end:
                out.append((fr, text))
                if limit is not None and len(out) >= limit:
                    break
        return out

    def object_best_match(
        self, frame: FrameRecord, query: str, include_ocr: bool = True
    ) -> tuple[bool, float, str]:
        """(found, best confidence, best label) across the 4 match sources
        with the reference's priorities (`query_strategies.py:386-440`):
        object detections (native conf), caption (0.65), tags (0.75), and —
        when ``include_ocr`` — OCR text at conf×0.7. Note `query_by_text_and_
        object` skips the OCR source (`:530-565`), hence the flag."""
        q_low = query.lower()
        q_folded = fold_accents(q_low)
        found, best_conf, best_label = False, 0.0, ""

        for lab_low, lab_folded, conf in frame.object_labels:
            if self._contains(q_low, q_folded, lab_low, lab_folded) and conf > best_conf:
                found, best_conf, best_label = True, conf, lab_low
        if frame.caption is not None:
            cap_low, cap_folded = frame.caption
            if self._contains(q_low, q_folded, cap_low, cap_folded) and CAPTION_CONF > best_conf:
                found, best_conf, best_label = True, CAPTION_CONF, query
        for tag_low, tag_folded in frame.tags:
            if self._contains(q_low, q_folded, tag_low, tag_folded) and TAG_CONF > best_conf:
                found, best_conf, best_label = True, TAG_CONF, tag_low
        if include_ocr:
            for lab_low, lab_folded, conf in frame.text_labels:
                scaled = conf * OCR_OBJECT_SCALE
                if self._contains(q_low, q_folded, lab_low, lab_folded) and scaled > best_conf:
                    found, best_conf, best_label = True, scaled, lab_low
        return found, best_conf, best_label
