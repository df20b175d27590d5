"""Deterministic zero-egress tokenizer fallbacks for SigLIP and Whisper.

A copy of the ``evr_tpu`` package's fallbacks, kept by the port so that it
imports nothing of that package; the same texts give identical ids.

Mirrors the design of the CLIP BPE fallback (`tokenizer/bpe.py`): when the
real vocabulary asset is absent (SigLIP's SentencePiece model, Whisper's
byte-BPE vocab — both deployment assets this zero-egress image cannot
fetch), a deterministic byte-level tokenizer stands in so every pipeline
stays drivable end-to-end. Ids are stable across runs and processes but
**intentionally NOT parity with the published tokenizers** — rank-parity /
transcription-quality evaluations must supply the real assets (HF
``SiglipTokenizer`` / ``WhisperTokenizer`` directories), exactly as the
reference must install its pip tokenizers. Engines record which source is
active (``tokenizer_source``) so a fallback can never masquerade as parity.

Reference parity scope: the reference has no SigLIP/Whisper at all (its
voice route calls AssemblyAI over the network, `Backend/app.py:766-850`);
these families are new capability, so the fallback's only contract is
determinism + in-vocab ids + lossless byte round-trip.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from evr_tpu_torch.tokenizer.bpe import basic_clean, whitespace_clean


class SiglipFallbackTokenizer:
    """Byte-level stand-in for SigLIP's SentencePiece tokenizer.

    Layout: id 0 = pad, id 1 = eos, ids 2..257 = the UTF-8 byte values of
    the canonicalized text (lowercased, whitespace-collapsed — SigLIP's
    canonicalizer also lowercases). Every id is < 258, far under any
    SigLIP ``vocab_size`` (>= 32000), so embeddings index safely. Texts
    are truncated to ``context_length - 1`` bytes, terminated with eos,
    and right-padded with pad — SigLIP's text tower pools the LAST
    position unmasked (no attention mask, HF semantics), so the fixed
    right-padding keeps pooling deterministic."""

    PAD_ID = 0
    EOS_ID = 1
    _OFFSET = 2

    source = "fallback"

    def __init__(self, context_length: int = 64, vocab_size: int = 32000):
        if vocab_size < self._OFFSET + 2:
            raise ValueError(f"vocab_size={vocab_size} too small")
        self.context_length = context_length
        self.vocab_size = vocab_size
        # real SigLIP vocabs (>= 32000) hold the full byte range; tiny test
        # configs fold bytes into the available id space (still
        # deterministic, more collisions — they are toys by construction)
        self._span = min(256, vocab_size - self._OFFSET)

    def encode(self, text: str) -> list[int]:
        clean = whitespace_clean(basic_clean(str(text))).lower()
        ids = [
            (b % self._span) + self._OFFSET for b in clean.encode("utf-8")
        ]
        return ids[: self.context_length - 1] + [self.EOS_ID]

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(
            i - self._OFFSET for i in ids if i >= self._OFFSET
        )
        return data.decode("utf-8", errors="replace")

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        rows = []
        for t in texts:
            ids = self.encode(t)
            ids = ids + [self.PAD_ID] * (self.context_length - len(ids))
            rows.append(ids)
        return np.asarray(rows, np.int32)


class WhisperFallbackTokenizer:
    """Byte-level stand-in for Whisper's byte-BPE tokenizer.

    Text ids are raw UTF-8 byte values (0..255 — inside any Whisper
    vocabulary, where the real byte-BPE also starts with single-byte
    tokens, though in a different order: NON-parity by design). Special
    ids (``sot_id``/``eos_id`` and anything >= 256) come from the model
    config and are skipped on decode, so the fallback detokenizer is safe
    to run over any greedy-decode output, random-init or real weights.
    With real weights the *real* tokenizer must be wired for readable
    text; this class keeps the transcribe → transcript-artifact →
    speech-search pipeline drivable without it."""

    source = "fallback"

    def __init__(self, eos_id: int, sot_id: int | None = None):
        self.eos_id = int(eos_id)
        self.sot_id = int(sot_id) if sot_id is not None else None

    @classmethod
    def for_config(cls, cfg) -> "WhisperFallbackTokenizer":
        return cls(eos_id=cfg.eos_id, sot_id=getattr(cfg, "sot_id", None))

    def encode(self, text: str) -> list[int]:
        return list(str(text).encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace").strip()
