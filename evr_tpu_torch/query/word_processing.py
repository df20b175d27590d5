"""Full-surface Vietnamese text processor (reference parity, zero-egress;
copy of the JAX package's ``query/word_processing.py``).

Reference counterpart: `Backend/word_processing.py:8-75`
(``VietnameseTextProcessor``): langdetect language detection,
GoogleTranslator vi→en, pyvi tokenize/de-accent/re-accent, underthesea
sentence segmentation / normalization / topic classification / sentiment.
None of those packages exist on this image and all of them are either
network calls or statistical models wrapped around small rule systems, so
each method here is a local, deterministic equivalent:

- language detection: diacritic signal + dictionary coverage (the same
  two-vote gate `query.text.VietnamesePreprocessor` uses);
- translation: the bundled longest-phrase-first `DictionaryTranslator`
  (injectable, like everywhere else in the package);
- accent removal: `query.text.fold_accents` (Vietnamese-complete);
- accent restoration: folded-form → accented-form table derived from the
  translator's own phrase vocabulary plus the stopword list (unambiguous
  forms only — ViUtils.add_accents is likewise dictionary-backed);
- normalization: NFC + canonical Vietnamese tone placement (oà→òa family,
  uý→úy family — the modern-orthography rules underthesea applies) +
  whitespace collapse;
- topic classification: accent-folded keyword scoring over the same
  news-topic label set underthesea.classify emits;
- sentiment: polarity lexicon (vi+en, accent-folded) with negation flip —
  underthesea.sentiment's binary positive/negative contract.

The serving hot path never calls this class (the reference's doesn't
either); it exists for pipeline/tooling parity and is exercised by
`tests/test_torch_query_text.py`.
"""

from __future__ import annotations

import pathlib
import re
import unicodedata
from typing import Callable

from .text import fold_accents, load_stopwords, segment_sentences

# canonical modern tone placement (underthesea text_normalize behavior):
# the glide keeps no mark — "hoà" → "hòa", "thuỷ" → "thủy"
_TONE_PAIRS = {
    "oà": "òa", "oá": "óa", "oả": "ỏa", "oã": "õa", "oạ": "ọa",
    "oè": "òe", "oé": "óe", "oẻ": "ỏe", "oẽ": "õe", "oẹ": "ọe",
    "uỳ": "ùy", "uý": "úy", "uỷ": "ủy", "uỹ": "ũy", "uỵ": "ụy",
}
_TONE_RE = re.compile("|".join(_TONE_PAIRS))

# minimal built-in Vietnamese stopword list (the reference loads
# `vietnamese-stopwords.txt` when present and degrades to [] otherwise —
# word_processing.py:11-16; we degrade to this instead of nothing)
_BUILTIN_VI_STOPWORDS = frozenset(
    "là của và các những một này đó khi đã sẽ được bị thì mà ở tại vào ra "
    "cho nên vì nếu như cũng rất quá lắm đây kia ấy nào gì ai đâu sao "
    "hơn nhất còn chỉ từng mỗi mọi nhiều ít vài đến từ về theo cùng".split()
)

# polarity lexicons, mixed vi+en because queries arrive in both. Matching
# is two-tier: the accented form matches exactly; the accent-FOLDED form
# matches only pure-ASCII input tokens (unaccented typing). Folding both
# sides unconditionally over-matches short words ("bàn" table would hit
# folded "bẩn" dirty).
_POSITIVE_SRC = (
    "tốt đẹp hay tuyệt vui thích yêu hạnh_phúc xuất_sắc hoàn_hảo "
    "dễ_thương tuyệt_vời thú_vị hài_lòng ngon giỏi chất_lượng "
    "an_toàn sạch nhanh tiện_lợi thân_thiện nhiệt_tình chu_đáo "
    "ổn ưng_ý cảm_ơn khen thành_công may_mắn "
    "good great excellent happy love wonderful amazing awesome "
    "perfect beautiful nice enjoy best fantastic pleasant safe "
    "clean fast friendly helpful success lucky"
).split()
_NEGATIVE_SRC = (
    "xấu tệ dở chán ghét buồn kém tồi tồi_tệ thất_vọng kinh_khủng "
    "khủng_khiếp bẩn chậm lừa_đảo hỏng vỡ gãy đau sợ_hãi "
    "nguy_hiểm bạo_lực đánh_nhau giết chết máu tai_nạn cháy nổ "
    "trộm cướp phàn_nàn chê thất_bại xui "
    "bad terrible awful horrible sad hate poor worst disappointing "
    "dirty slow broken scam dangerous violent kill blood accident "
    "fire explosion thief robbery fail angry scared ugly boring"
).split()
_NEGATOR_SRC = "không chẳng chả chưa đừng no not never without".split()

_POSITIVE = frozenset(_POSITIVE_SRC)
_POSITIVE_FOLDED = frozenset(map(fold_accents, _POSITIVE_SRC))
_NEGATIVE = frozenset(_NEGATIVE_SRC)
_NEGATIVE_FOLDED = frozenset(map(fold_accents, _NEGATIVE_SRC))
_NEGATORS = frozenset(_NEGATOR_SRC)
_NEGATORS_FOLDED = frozenset(map(fold_accents, _NEGATOR_SRC))

# news-topic label set (the labels underthesea.classify emits, unaccented
# exactly as that model prints them) → accent-folded keyword cues
_TOPIC_KEYWORDS: dict[str, tuple[str, ...]] = {
    "The thao": (
        "bong da", "the thao", "cau thu", "tran dau", "vo dich", "ban thang",
        "doi tuyen", "huan luyen vien", "giai dau", "olympic", "tennis",
        "football", "soccer", "match", "goal", "player", "championship",
    ),
    "Phap luat": (
        "cong an", "canh sat", "toa an", "phap luat", "bat giu", "khoi to",
        "pham toi", "trom", "cuop", "giet", "an ninh", "vi pham", "xet xu",
        "police", "court", "crime", "arrest", "law", "illegal", "trial",
    ),
    "Giao duc": (
        "hoc sinh", "sinh vien", "truong hoc", "giao vien", "thi", "diem",
        "dai hoc", "giao duc", "lop hoc", "tot nghiep", "tuyen sinh",
        "school", "student", "teacher", "exam", "education", "university",
    ),
    "Suc khoe": (
        "benh", "bac si", "benh vien", "suc khoe", "thuoc", "dieu tri",
        "vac xin", "dich benh", "y te", "phau thuat", "dinh duong",
        "health", "doctor", "hospital", "disease", "medicine", "vaccine",
    ),
    "Kinh doanh": (
        "kinh doanh", "doanh nghiep", "gia", "thi truong", "co phieu",
        "ngan hang", "dau tu", "loi nhuan", "xuat khau", "kinh te", "tien",
        "business", "market", "stock", "bank", "investment", "economy",
    ),
    "Cong nghe": (
        "cong nghe", "dien thoai", "may tinh", "phan mem", "internet",
        "ung dung", "tri tue nhan tao", "du lieu", "mang", "chip", "robot",
        "technology", "phone", "computer", "software", "app", "ai", "data",
    ),
    "Giai tri": (
        "ca si", "dien vien", "phim", "am nhac", "show", "nghe si",
        "san khau", "mv", "bai hat", "giai tri", "than tuong",
        "singer", "actor", "movie", "music", "concert", "celebrity",
    ),
    "Doi song": (
        "gia dinh", "am thuc", "mon an", "nau", "du lich", "doi song",
        "nha cua", "tinh yeu", "cuoi", "thoi trang", "lam dep",
        "family", "food", "cooking", "travel", "wedding", "fashion",
    ),
    "The gioi": (
        "the gioi", "quoc te", "my", "trung quoc", "nga", "chau au",
        "tong thong", "chien tranh", "lien hop quoc", "ngoai giao",
        "world", "international", "president", "war", "country", "global",
    ),
    "Xe": (
        "o to", "xe may", "xe hoi", "dong co", "lai xe", "hang xe",
        "sedan", "suv", "car", "motorbike", "engine", "driver", "vehicle",
    ),
}


def _fold_words(text: str) -> list[str]:
    return re.findall(r"[a-z0-9]+", fold_accents(text.lower()))


class VietnameseTextProcessor:
    """Method-for-method local counterpart of the reference class
    (`Backend/word_processing.py:8-75`); every network/model dependency is
    replaced by the deterministic equivalents described in the module
    docstring. ``translator`` is injectable; the bundled
    ``DictionaryTranslator`` is the zero-egress default."""

    def __init__(
        self,
        stopwords_path: str | pathlib.Path | None = None,
        translator: Callable[[str], str] | None = None,
    ):
        if stopwords_path and pathlib.Path(stopwords_path).exists():
            self.stop_words = sorted(load_stopwords(stopwords_path))
        else:
            self.stop_words = sorted(_BUILTIN_VI_STOPWORDS)
        if translator is None:
            from .translate import DictionaryTranslator

            translator = DictionaryTranslator()
        self.translator = translator
        self._stop_set = set(self.stop_words)
        self._accent_map = self._build_accent_map()

    # -- language ----------------------------------------------------------
    def detect_language(self, text: str) -> str:
        """'vi' or 'en' — diacritic signal first, dictionary coverage as the
        second vote for unaccented Vietnamese (replaces langdetect)."""
        from .text import VietnamesePreprocessor

        if VietnamesePreprocessor.looks_vietnamese(text):
            return "vi"
        coverage = getattr(self.translator, "coverage", None)
        if coverage is not None:
            try:
                if coverage(text) >= 0.5:
                    return "vi"
            except Exception:
                pass
        return "en"

    def translate_to_english(self, text: str) -> str:
        if self.detect_language(text) == "vi":
            try:
                return self.translator(text)
            except Exception:
                return text  # degrade untranslated, like the reference
        return text

    # -- casing / stopwords --------------------------------------------------
    def lowercasing(self, text: str) -> str:
        return text.lower()

    def uppercasing(self, text: str) -> str:
        return text.upper()

    def remove_stopwords(self, text: str) -> str:
        kept = [w for w in text.split() if w.lower() not in self._stop_set]
        return " ".join(kept).replace("_", " ")

    # -- accents -------------------------------------------------------------
    def remove_accents(self, text: str) -> str:
        return fold_accents(text)

    def _build_accent_map(self) -> dict[str, str]:
        """folded word → accented word, from the translator's phrase
        vocabulary + the stopword list; ambiguous folded forms (two
        accented words colliding) are dropped rather than guessed."""
        vocab: set[str] = set(self.stop_words)
        phrases = getattr(self.translator, "phrases", None)
        if isinstance(phrases, dict):
            for phrase in phrases:
                vocab.update(phrase.split())
        else:
            from .translate import VI_EN_PHRASES

            for phrase in VI_EN_PHRASES:
                vocab.update(phrase.split())
        mapping: dict[str, str] = {}
        ambiguous: set[str] = set()
        for word in vocab:
            folded = fold_accents(word)
            if folded == word:
                continue
            if folded in mapping and mapping[folded] != word:
                ambiguous.add(folded)
            else:
                mapping[folded] = word
        for folded in ambiguous:
            mapping.pop(folded, None)
        return mapping

    def add_accents(self, text: str) -> str:
        """Best-effort diacritic restoration (ViUtils.add_accents parity):
        unambiguous dictionary forms are restored, everything else passes
        through unchanged."""
        out = []
        for token in text.split():
            low = token.lower()
            restored = self._accent_map.get(low)
            if restored is None:
                out.append(token)
            elif token[:1].isupper():
                out.append(restored[:1].upper() + restored[1:])
            else:
                out.append(restored)
        return " ".join(out)

    # -- structure -------------------------------------------------------
    def sentence_segment(self, text: str) -> list[str]:
        return segment_sentences(text)

    def text_normalization(self, text: str) -> str:
        """NFC + canonical tone placement + whitespace collapse
        (underthesea.text_normalize's observable behavior on real text)."""
        text = unicodedata.normalize("NFC", text)
        text = _TONE_RE.sub(lambda m: _TONE_PAIRS[m.group(0)], text)
        return " ".join(text.split())

    # -- classification / sentiment ------------------------------------------
    def text_classification(self, text: str) -> list[str]:
        """Topic labels (underthesea.classify contract: a list, usually one
        label, [] when nothing matches) via accent-folded keyword scoring."""
        folded = " " + " ".join(_fold_words(text)) + " "
        scores: dict[str, int] = {}
        for topic, keywords in _TOPIC_KEYWORDS.items():
            hits = sum(1 for kw in keywords if f" {kw} " in folded)
            if hits:
                scores[topic] = hits
        if not scores:
            return []
        best = max(scores.values())
        return [t for t, s in scores.items() if s == best]

    @staticmethod
    def _polarity(token: str) -> int:
        """Two-tier lexicon lookup: accented forms match exactly; folded
        forms match only tokens the user typed without diacritics."""
        if token in _POSITIVE:
            return 1
        if token in _NEGATIVE:
            return -1
        if token == fold_accents(token):  # pure-ASCII input token
            if token in _POSITIVE_FOLDED:
                return 1
            if token in _NEGATIVE_FOLDED:
                return -1
        return 0

    @staticmethod
    def _is_negator(token: str) -> bool:
        if token in _NEGATORS:
            return True
        return token == fold_accents(token) and token in _NEGATORS_FOLDED

    def sentiment_analysis(self, text: str) -> str | None:
        """'positive' / 'negative' / None (no signal) — lexicon polarity
        with single-step negation flip ("không tốt" → negative)."""
        words = re.findall(r"\w+", unicodedata.normalize("NFC", text.lower()))
        score = 0
        for i, w in enumerate(words):
            polarity = self._polarity(w)
            if not polarity and i + 1 < len(words):
                # lexicon stores compounds with underscores — match bigrams
                polarity = self._polarity(f"{w}_{words[i + 1]}")
            if polarity and i > 0 and self._is_negator(words[i - 1]):
                polarity = -polarity
            score += polarity
        if score > 0:
            return "positive"
        if score < 0:
            return "negative"
        return None

    # -- pipeline --------------------------------------------------------
    def preprocess_and_translate(self, text: str) -> str:
        """lowercase → stopword removal → normalization → translate —
        the exact stage order of the reference pipeline
        (`word_processing.py:68-75`)."""
        text = self.lowercasing(text)
        text = self.remove_stopwords(text)
        text = self.text_normalization(text)
        return self.translate_to_english(text)
