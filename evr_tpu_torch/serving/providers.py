"""External service providers for serving (all optional, all pluggable;
counterpart of the JAX package's ``serving/providers.py``).

The reference calls AssemblyAI inline in the route with a HARDCODED API key
(`Backend/app.py:766-850`) — here transcription is a provider object wired
into ``ServingContext(transcriber=...)``, keys come from the environment,
and zero-egress deployments simply leave the provider unset (the route
answers 501).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request


class AssemblyAITranscriber:
    """Upload-and-poll transcription against the AssemblyAI v2 API.

    ``AssemblyAITranscriber()`` reads ``ASSEMBLYAI_API_KEY``; construction
    fails fast without a key so misconfiguration surfaces at wiring time,
    not on the first request.
    """

    BASE_URL = "https://api.assemblyai.com"

    def __init__(self, api_key: str | None = None, poll_interval: float = 2.0,
                 max_attempts: int = 20):
        self.api_key = api_key or os.environ.get("ASSEMBLYAI_API_KEY")
        if not self.api_key:
            raise ValueError(
                "AssemblyAITranscriber needs an API key (ASSEMBLYAI_API_KEY)"
            )
        self.poll_interval = poll_interval
        self.max_attempts = max_attempts

    def _request(self, path: str, data=None, method="GET", content_type=None):
        headers = {"authorization": self.api_key}
        if content_type:
            headers["content-type"] = content_type
        req = urllib.request.Request(
            f"{self.BASE_URL}{path}", data=data, headers=headers, method=method
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def __call__(self, audio_path: str, language: str = "en_us") -> str:
        with open(audio_path, "rb") as f:
            upload = self._request("/v2/upload", data=f.read(), method="POST")
        job = self._request(
            "/v2/transcript",
            data=json.dumps(
                {
                    "audio_url": upload["upload_url"],
                    "speech_model": "universal",
                    "language_code": language,
                }
            ).encode(),
            method="POST",
            content_type="application/json",
        )
        for _ in range(self.max_attempts):
            status = self._request(f"/v2/transcript/{job['id']}")
            if status.get("status") == "completed":
                return status["text"]
            if status.get("status") == "error":
                raise RuntimeError(f"transcription failed: {status.get('error')}")
            time.sleep(self.poll_interval)
        raise TimeoutError("transcription timed out")


class LocalWhisperTranscriber:
    """On-card Whisper transcription (``models.whisper``): the zero-egress
    replacement of the reference's AssemblyAI network call
    (`Backend/app.py:766-850`).

    Wraps a ``WhisperASR`` (its params, config and detokenizer are
    deployment assets; without them, leave the provider unset and the route
    answers 501). ``language_prompts`` maps the route's language codes
    (e.g. ``"en_us"``, ``"vi"``) to forced header id lists; an unknown code
    takes the ASR's default prompt. Input: PCM WAV read by the standard
    library; a webm or ogg upload needs a host decoder ahead of it."""

    def __init__(self, asr, language_prompts: dict[str, list[int]] | None = None):
        self.asr = asr
        self.language_prompts = language_prompts or {}

    def __call__(self, audio_path: str, language: str = "en_us") -> str:
        from evr_tpu_torch.models.whisper import read_wav

        audio = read_wav(audio_path, self.asr.cfg.sampling_rate)
        (out,) = self.asr.transcribe(audio, prompt_ids=self.language_prompts.get(language))
        if isinstance(out, list):  # no detokenizer wired: the ids as text
            return " ".join(str(i) for i in out)
        return out


class CallableTranscriber:
    """Adapter for any ``fn(audio_path, language) -> str`` (e.g. a local
    whisper install) so it can be wired as the serving transcriber."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, audio_path: str, language: str = "en_us") -> str:
        return self.fn(audio_path, language)
