"""Query text utilities: accent folding + pluggable preprocessing (copy of
the JAX package's ``query/text.py``; the port keeps its own).

Reference counterparts: ``unidecode`` accent-stripping used throughout
keyword/object matching (`Backend/services/search_service.py:25-58`,
`query_strategies.py` passim) and ``VietnameseTextProcessor``
(`Backend/word_processing.py`: lowercase → ViTokenizer stopword removal →
normalization → langdetect → GoogleTranslator vi→en).

TPU-native stance: translation is a NETWORK CALL the reference performs on
the hot query path (`word_processing.py:22-27`) — here preprocessing is a
pluggable hook that defaults to a pure-local pipeline, with the translator
injected only when explicitly configured (and it is then cached).
"""

from __future__ import annotations

import unicodedata
from typing import Callable, Protocol

_SPECIAL = str.maketrans({"đ": "d", "Đ": "D", "ø": "o", "Ø": "O", "ł": "l", "Ł": "L"})


def fold_accents(text: str) -> str:
    """ASCII-fold accents (Vietnamese-complete): NFD-strip combining marks
    plus the non-decomposing letters (đ → d). Replaces ``unidecode`` for the
    accent-insensitive substring matching the reference does."""
    text = text.translate(_SPECIAL)
    decomposed = unicodedata.normalize("NFD", text)
    return "".join(c for c in decomposed if not unicodedata.combining(c))


def segment_sentences(text: str) -> list[str]:
    """Sentence segmentation (reference exposes this via underthesea at
    `word_processing.py`; serving never calls it on the hot path)."""
    import re

    parts = re.split(r"(?<=[.!?…])\s+", text.strip())
    return [p for p in parts if p]


class QueryPreprocessor(Protocol):
    def __call__(self, query: str) -> str: ...


def identity_preprocessor(query: str) -> str:
    return query


DEFAULT_EN_STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to "
    "was were will with this these those there then than or nor not no so "
    "very just about into over under out up down off again once".split()
)


def load_stopwords(path) -> set[str]:
    """One stopword per line (the reference ships `vietnamese-stopwords.txt`
    / `Eng_stopwords.txt` in this format)."""
    import pathlib

    return {
        line.strip().lower()
        for line in pathlib.Path(path).read_text(encoding="utf-8").splitlines()
        if line.strip()
    }


class VietnamesePreprocessor:
    """Local-first equivalent of `word_processing.py:68-75`.

    Pipeline: lowercase → optional stopword removal → optional translate
    hook. The translator (if provided) receives the cleaned text and returns
    English; results are cached so repeated queries never re-trigger it.
    """

    def __init__(
        self,
        stopwords: set[str] | None = None,
        translator: Callable[[str], str] | None = None,
    ):
        self.stopwords = {s.lower() for s in (stopwords or set())}
        self.translator = translator
        self._cache: dict[str, str] = {}

    def remove_stopwords(self, text: str) -> str:
        if not self.stopwords:
            return text
        return " ".join(w for w in text.split() if w.lower() not in self.stopwords)

    @staticmethod
    def looks_vietnamese(text: str) -> bool:
        """Local language gate replacing the reference's langdetect call
        (`word_processing.py`): Vietnamese text almost always carries
        diacritics or đ; plain-ASCII queries skip translation entirely."""
        vietnamese_chars = set(
            "àáảãạăằắẳẵặâầấẩẫậèéẻẽẹêềếểễệìíỉĩịòóỏõọôồốổỗộơờớởỡợ"
            "ùúủũụưừứửữựỳýỷỹỵđ"
        )
        low = text.lower()
        return any(c in vietnamese_chars for c in low)

    def _should_translate(self, text: str) -> bool:
        if self.translator is None:
            return False
        if self.looks_vietnamese(text):
            return True
        # un-accented Vietnamese carries no diacritics; translators that can
        # report dictionary coverage (DictionaryTranslator) get a second
        # vote — majority-coverage ASCII text is treated as Vietnamese
        coverage = getattr(self.translator, "coverage", None)
        if coverage is not None:
            try:
                return coverage(text) >= 0.5
            except Exception:
                return False
        return False

    def __call__(self, query: str) -> str:
        if query in self._cache:
            return self._cache[query]
        text = " ".join(query.lower().split())
        text = self.remove_stopwords(text)
        if self._should_translate(text):
            try:
                text = self.translator(text)
            except Exception:
                pass  # degrade to untranslated text, as the reference does
        if len(self._cache) >= 4096:  # bounded, like the searcher result cache
            self._cache.clear()
        self._cache[query] = text
        return text
