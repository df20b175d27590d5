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
    """On-card Whisper transcription: not ported yet (ROADMAP A17, the model
    families). Construction raises; wire an ``AssemblyAITranscriber`` or a
    ``CallableTranscriber`` instead, or leave the provider unset (the route
    answers 501)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LocalWhisperTranscriber needs the Whisper model, which is not yet ported to "
            "evr_tpu_torch (ROADMAP A17)"
        )


class CallableTranscriber:
    """Adapter for any ``fn(audio_path, language) -> str`` (e.g. a local
    whisper install) so it can be wired as the serving transcriber."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, audio_path: str, language: str = "en_us") -> str:
        return self.fn(audio_path, language)
