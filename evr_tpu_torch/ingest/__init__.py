"""Video ingest (counterpart of ``evr_tpu/ingest``). The zero-shot object
annotator and the local OCR annotator are not ported yet (ROADMAP A17)."""

from .annotate import Annotator, NullAnnotator, annotate_folder, build_frame_record
from .frames import extract_scene_frames, extract_uniform_frames
from .pipeline import IngestResult, ingest_video
from .scene import ContentDetectorConfig, content_curve, cuts_from_curve, detect_scenes
from .transcripts import (
    SegmentTranscriber,
    WhisperSegmentTranscriber,
    build_video_transcript,
    load_transcript,
    transcript_path_for,
)

__all__ = [
    "detect_scenes",
    "content_curve",
    "cuts_from_curve",
    "ContentDetectorConfig",
    "extract_scene_frames",
    "extract_uniform_frames",
    "build_frame_record",
    "Annotator",
    "NullAnnotator",
    "annotate_folder",
    "ingest_video",
    "IngestResult",
    "SegmentTranscriber",
    "WhisperSegmentTranscriber",
    "build_video_transcript",
    "load_transcript",
    "transcript_path_for",
]
