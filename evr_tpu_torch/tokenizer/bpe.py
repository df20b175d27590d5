"""CLIP byte-level BPE tokenizer, implemented from scratch.

A copy of the ``evr_tpu`` package's tokenizer, kept by the port so that it
imports nothing of that package; the same inputs give identical ids.

Behavioural contract (what the reference relies on via the pip ``clip``
package — `Backend/services/embedding_service.py:151-184` calls
``clip.tokenize(query)`` and every trainer tokenizes with
``truncate=True``, e.g. `Backend/clip_finetune_correct.py:240,452`):

- context length 77: ``<|startoftext|> ids... <|endoftext|>`` zero-padded
- lower-cased, whitespace-collapsed input; byte-level BPE with ``</w>``
  end-of-word markers; GPT-2 byte↔unicode mapping
- `truncate=True` clips and forces the last position to be the EOT id
- the EOT id is the **argmax token id** in every sequence — the text tower
  pools the embedding at the EOT position via argmax (see
  ``evr_tpu_torch.models.clip.encode_text``), so EOT must be the largest id.

Vocabulary assets: the real OpenAI merge table (``bpe_simple_vocab_16e6.
txt.gz``) or a HuggingFace ``vocab.json``+``merges.txt`` pair can be loaded
when available — vendor it as a repo asset with ``tools/vendor_bpe.py``
(validated, then auto-loaded by ``ClipTokenizer()`` with zero config), or
point at it via ``ClipTokenizer(vocab_path=...)`` / env ``EVR_TPU_BPE_VOCAB``.
When no asset exists (zero-egress environments — the table is absent from
this build image and cannot be fetched) a deterministic byte-level fallback
vocabulary with no merges is built; ids are stable across runs but
intentionally NOT OpenAI-compatible — rank-parity evaluations must supply the
real merge table, exactly as the reference must install ``clip``.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import pathlib
from typing import Iterable, Sequence

import numpy as np
import regex as re

CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

# Vendored-asset directory: `tools/vendor_bpe.py` installs a validated copy
# of the OpenAI merge table here, making real CLIP ids the zero-config
# default. (The table itself cannot be fetched in a zero-egress build
# environment, so the directory ships empty until vendored.)
_ASSETS_DIR = pathlib.Path(__file__).parent / "assets"

# Candidate locations for the OpenAI merge table, probed in order.
_VOCAB_SEARCH_PATHS = (
    str(_ASSETS_DIR / "bpe_simple_vocab_16e6.txt.gz"),
    str(_ASSETS_DIR / "merges.txt"),
    "~/.cache/clip/bpe_simple_vocab_16e6.txt.gz",
    "~/.cache/evr_tpu/bpe_simple_vocab_16e6.txt.gz",
)


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte → printable-unicode-char table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    # ftfy.fix_text is applied by the reference stack when installed; the
    # double html-unescape + strip below covers the common mojibake-free path.
    try:  # pragma: no cover - optional dependency
        import ftfy

        text = ftfy.fix_text(text)
    except Exception:
        pass
    if "&" in text:  # html.unescape is identity without an entity ampersand
        text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _load_openai_merges(path: pathlib.Path) -> list[tuple[str, str]]:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    # Same slice the OpenAI vocab is defined over: merges 1..48894.
    merges = lines[1 : 49152 - 256 - 2 + 1]
    return [tuple(m.split()) for m in merges]


class ClipTokenizer:
    """Byte-level BPE tokenizer with CLIP's vocabulary layout."""

    def __init__(self, vocab_path: str | os.PathLike | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges: list[tuple[str, str]] = []
        hf_vocab: dict[str, int] | None = None

        path = self._resolve_vocab_path(vocab_path)
        self.vocab_source = "fallback"
        if path is not None:
            if path.name == "merges.txt" or path.suffix == ".txt":
                merges, hf_vocab = self._load_hf_assets(path)
                self.vocab_source = str(path)
            else:
                merges = _load_openai_merges(path)
                self.vocab_source = str(path)

        if hf_vocab is not None:
            self.encoder = dict(hf_vocab)
        else:
            chars = list(self.byte_encoder.values())
            vocab: list[str] = chars + [c + "</w>" for c in chars]
            vocab.extend("".join(m) for m in merges)
            vocab.extend([SOT_TOKEN, EOT_TOKEN])
            self.encoder = {tok: i for i, tok in enumerate(vocab)}

        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: dict[str, str] = {
            SOT_TOKEN: SOT_TOKEN,
            EOT_TOKEN: EOT_TOKEN,
        }
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            re.IGNORECASE,
        )
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]
        self.vocab_size = len(self.encoder)

    # -- asset resolution -------------------------------------------------
    @staticmethod
    def _resolve_vocab_path(vocab_path) -> pathlib.Path | None:
        candidates: list[pathlib.Path] = []
        if vocab_path is not None:
            candidates.append(pathlib.Path(vocab_path))
        env = os.environ.get("EVR_TPU_BPE_VOCAB")
        if env:
            candidates.append(pathlib.Path(env))
        candidates.extend(pathlib.Path(p).expanduser() for p in _VOCAB_SEARCH_PATHS)
        # any CLIP tokenizer assets already in the HF cache
        hf_home = pathlib.Path(
            os.environ.get("HF_HOME", "~/.cache/huggingface")
        ).expanduser()
        if hf_home.exists():
            candidates.extend(sorted(hf_home.glob("**/clip*/**/merges.txt"))[:4])
            candidates.extend(sorted(hf_home.glob("hub/models--*clip*/**/merges.txt"))[:4])
        for cand in candidates:
            if cand.exists():
                return cand
        if vocab_path is not None:
            raise FileNotFoundError(f"BPE vocab not found: {vocab_path}")
        return None

    @staticmethod
    def _load_hf_assets(merges_path: pathlib.Path):
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f.read().split("\n")[1:]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)
        vocab_file = merges_path.with_name("vocab.json")
        hf_vocab = None
        if vocab_file.exists():
            hf_vocab = json.loads(vocab_file.read_text())
        return merges, hf_vocab

    # -- BPE core ---------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        # unknown ids (e.g. sampled from an untrained model under the
        # fallback vocab) are skipped rather than raising
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # -- batch API (clip.tokenize parity) ---------------------------------
    def __call__(
        self,
        texts: str | Sequence[str],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"Input {row} is too long for context length {context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[row, : len(ids)] = ids
        return out


@functools.lru_cache()
def get_default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: str | Sequence[str],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
) -> np.ndarray:
    """Module-level convenience mirroring ``clip.tokenize``."""
    return get_default_tokenizer()(texts, context_length, truncate)
