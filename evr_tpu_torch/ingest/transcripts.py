"""Video speech transcripts: the searchable ASR modality.

Counterpart of ``evr_tpu/ingest/transcripts.py``. Ingest writes a
``{video}_transcript.json`` sidecar beside the metadata file;
``serving.context.ServingContext.boot`` loads it into the metadata store,
and the ``speech_only`` / ``text_speech`` strategies search it. Schema::

    {"video": name, "segments": [{"start": s, "end": s, "text": str}, ...]}

The transcriber is pluggable: any callable ``(audio_f32_16kHz) ->
[{"start", "end", "text"}, ...]``. ``WhisperSegmentTranscriber`` adapts any
object with ``transcribe_segments(audio, prompt_ids=...)``, such as
``models.whisper.WhisperASR``. Audio comes from PCM WAV sidecars (``read_wav``).
"""

from __future__ import annotations

import json
import pathlib
from typing import Protocol

import numpy as np


class SegmentTranscriber(Protocol):
    def __call__(self, audio) -> list[dict]:
        """fp32 mono waveform at 16 kHz → [{"start", "end", "text"}, ...]."""
        ...


class WhisperSegmentTranscriber:
    """Adapt an ASR object with ``transcribe_segments`` to the
    SegmentTranscriber protocol."""

    def __init__(self, asr, prompt_ids: list[int] | None = None):
        self.asr = asr
        self.prompt_ids = prompt_ids

    def __call__(self, audio) -> list[dict]:
        return self.asr.transcribe_segments(audio, prompt_ids=self.prompt_ids)


def read_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """A PCM WAV (8, 16 or 32-bit, any channel count) read with the standard
    library → float32 mono at ``target_rate`` (channels averaged, linear
    resampling)."""
    import wave

    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        t_new = np.arange(int(len(x) * target_rate / rate)) * (rate / target_rate)
        x = np.interp(t_new, np.arange(len(x)), x).astype(np.float32)
    return x


def transcript_path_for(metadata_file, video_name: str) -> pathlib.Path:
    """Sidecar convention: the transcript lives next to the metadata file as
    ``{video}_transcript.json``."""
    return pathlib.Path(metadata_file).parent / f"{video_name}_transcript.json"


def build_video_transcript(
    wav_path,
    video_name: str,
    transcriber: SegmentTranscriber,
    out_path=None,
    sample_rate: int = 16000,
) -> dict:
    """Transcribe one video's WAV sidecar into the transcript artifact;
    written to ``out_path`` when given. Segments with empty text (silence)
    are dropped."""
    audio = read_wav(str(wav_path), sample_rate)
    segments = [
        {"start": float(seg["start"]), "end": float(seg["end"]), "text": str(seg["text"]).strip()}
        for seg in transcriber(audio)
        if str(seg.get("text", "")).strip()
    ]
    payload = {"video": video_name, "segments": segments}
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(payload, indent=2), encoding="utf-8")
    return payload


def load_transcript(path) -> list[dict]:
    """A transcript artifact (or a bare segment list) → its segments."""
    payload = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
    if isinstance(payload, dict):
        return payload.get("segments", [])
    return payload
