"""Offline Vietnamese→English query translation (copy of the JAX package's
``query/translate.py``, entry for entry).

The reference translates queries with GoogleTranslator on the hot serving
path (`Backend/word_processing.py:22-27`) — a network call per query. This
environment is zero-egress, so the network provider stays an injectable
hook; this module supplies the LOCAL default: a longest-phrase-first
dictionary over the retrieval domain's vocabulary (violence/NSFW video
search — the reference's target domain per its training data).

Vietnamese is analytic (no inflection), so phrase-table substitution is a
workable query-level translation: multi-word phrases are matched first
("đánh nhau" → "fighting" before "đánh" → "hit"), unknown words pass
through unchanged (CLIP tolerates mixed-language tokens better than a
dropped query). Accent-folded duplicates of unambiguous keys are accepted
so un-accented typing still matches.
"""

from __future__ import annotations

from .text import fold_accents

# phrase → english; multi-word phrases matched longest-first
VI_EN_PHRASES: dict[str, str] = {
    # violence domain (the fine-tune's classes)
    "bạo lực": "violence",
    "đánh nhau": "fighting",
    "đánh đập": "beating",
    "ẩu đả": "brawl",
    "tấn công": "attack",
    "đấm": "punch",
    "đá": "kick",
    "súng": "gun",
    "dao": "knife",
    "vũ khí": "weapon",
    "máu": "blood",
    "bắn": "shooting",
    "đâm": "stabbing",
    "cướp": "robbery",
    "trộm": "thief",
    "cháy": "fire",
    "nổ": "explosion",
    "tai nạn": "accident",
    "khỏa thân": "nude",
    "nội dung nhạy cảm": "sensitive content",
    "nhạy cảm": "sensitive",
    # people
    "người": "person",
    "đàn ông": "man",
    "phụ nữ": "woman",
    "trẻ em": "child",
    "đứa trẻ": "child",
    "đám đông": "crowd",
    "cảnh sát": "police",
    "nhóm người": "group of people",
    "hai người": "two people",
    # places / scenes
    "đường phố": "street",
    "trên đường": "on the road",
    "con đường": "road",
    "tòa nhà": "building",
    "căn phòng": "room",
    "trong phòng": "in a room",
    "công viên": "park",
    "trường học": "school",
    "bệnh viện": "hospital",
    "cửa hàng": "shop",
    "sân": "yard",
    "ban đêm": "at night",
    "ban ngày": "daytime",
    # objects
    "xe hơi": "car",
    "ô tô": "car",
    "xe máy": "motorbike",
    "xe đạp": "bicycle",
    "xe tải": "truck",
    "xe buýt": "bus",
    "điện thoại": "phone",
    "máy tính": "computer",
    "bàn": "table",
    "ghế": "chair",
    "cây": "tree",
    "động vật": "animal",
    "chó": "dog",
    "mèo": "cat",
    # actions
    "chạy": "running",
    "đi bộ": "walking",
    "nhảy": "jumping",
    "ngồi": "sitting",
    "đứng": "standing",
    "nằm": "lying down",
    "nói chuyện": "talking",
    "la hét": "screaming",
    "khóc": "crying",
    "cười": "laughing",
    "ăn": "eating",
    "uống": "drinking",
    "lái xe": "driving",
    "cầm": "holding",
    "ném": "throwing",
    "đuổi theo": "chasing",
    "ngã": "falling",
    "ôm": "hugging",
    "hôn": "kissing",
    # descriptors / colours
    "màu đỏ": "red",
    "màu xanh": "blue",
    "màu đen": "black",
    "màu trắng": "white",
    "lớn": "big",
    "nhỏ": "small",
    "nhanh": "fast",
    "chậm": "slow",
    "nguy hiểm": "dangerous",
    "đông người": "crowded",
    # function words that help caption-shaped queries
    "một": "a",
    "và": "and",
    "với": "with",
    "trong": "in",
    "trên": "on",
    "dưới": "under",
    "của": "of",
    "đang": "",  # progressive marker: English -ing already carried by verbs
    "những": "",  # plural marker
    "các": "",
}


class DictionaryTranslator:
    """Longest-phrase-first vi→en substitution, callable as the
    ``VietnamesePreprocessor`` translator hook. Pure-local (zero egress)."""

    def __init__(self, phrases: dict[str, str] | None = None):
        table = dict(VI_EN_PHRASES if phrases is None else phrases)
        # accept accent-folded spellings when they don't collide
        folded: dict[str, str] = {}
        for k, v in table.items():
            fk = fold_accents(k)
            if fk != k and fk not in table:
                if fk in folded and folded[fk] != v:
                    folded[fk] = None  # ambiguous — drop
                elif fk not in folded:
                    folded[fk] = v
        table.update({k: v for k, v in folded.items() if v is not None})
        # longest-first by word count then char length
        self._phrases = sorted(
            table.items(), key=lambda kv: (-len(kv[0].split()), -len(kv[0]))
        )
        self._table = table

    @property
    def phrases(self) -> dict[str, str]:
        """The phrase table (incl. accepted accent-folded spellings) —
        consumed by ``VietnameseTextProcessor`` for accent restoration."""
        return dict(self._table)

    def _walk(self, words: list[str]):
        """Longest-phrase-first walk: yields (consumed, replacement_or_None)
        per step — the single source of truth for __call__ and coverage."""
        i = 0
        while i < len(words):
            for phrase, eng in self._phrases:
                pw = phrase.split()
                if words[i : i + len(pw)] == pw:
                    yield len(pw), eng
                    i += len(pw)
                    break
            else:
                yield 1, None
                i += 1

    def __call__(self, text: str) -> str:
        words = text.lower().split()
        out: list[str] = []
        i = 0
        for consumed, eng in self._walk(words):
            if eng is None:
                out.append(words[i])
            elif eng:
                out.append(eng)
            i += consumed
        return " ".join(out)

    def coverage(self, text: str) -> float:
        """Fraction of words consumed by dictionary phrases (also the
        un-accented-Vietnamese vote in VietnamesePreprocessor)."""
        words = text.lower().split()
        if not words:
            return 1.0
        hit = sum(c for c, eng in self._walk(words) if eng is not None)
        return hit / len(words)
