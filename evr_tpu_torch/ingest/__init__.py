"""Video ingest (counterpart of ``evr_tpu/ingest``), with the zero-shot
object annotator and the local OCR annotator."""

from .annotate import Annotator, NullAnnotator, annotate_folder, build_frame_record
from .frames import extract_scene_frames, extract_uniform_frames
from .ocr import LocalOCRAnnotator, detect_text_regions
from .pipeline import IngestResult, ingest_video
from .scene import ContentDetectorConfig, content_curve, cuts_from_curve, detect_scenes
from .zeroshot import COCO_CLASSES, ZeroShotObjectAnnotator, make_region_grid, nms_xywh
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
    "COCO_CLASSES",
    "ZeroShotObjectAnnotator",
    "make_region_grid",
    "nms_xywh",
    "LocalOCRAnnotator",
    "detect_text_regions",
    "ingest_video",
    "IngestResult",
    "SegmentTranscriber",
    "WhisperSegmentTranscriber",
    "build_video_transcript",
    "load_transcript",
    "transcript_path_for",
]
