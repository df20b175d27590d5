"""The port's query text layer against the JAX package's: accent folding,
sentence segmentation, stopwords, the vi→en dictionary translator, the
Vietnamese preprocessor and ``VietnameseTextProcessor``. Every output is a
string (or a list of them), so each must equal JAX's byte for byte over the
same corpus: accented and unaccented Vietnamese (đ/Đ, decomposed combining
marks, old tone placement), English, mixed and empty text."""

import unicodedata

import pytest

from evr_tpu.query import metadata as jmeta
from evr_tpu.query import text as jtext
from evr_tpu.query import translate as jtrans
from evr_tpu.query import word_processing as jwp
from evr_tpu_torch.query import metadata as tmeta
from evr_tpu_torch.query import text as ttext
from evr_tpu_torch.query import translate as ttrans
from evr_tpu_torch.query import word_processing as twp

CORPUS = [
    "Đánh nhau trên đường phố",
    "đánh nhau trên đường",
    "danh nhau tren duong pho",
    "ĐƯỜNG PHỐ ban đêm",
    unicodedata.normalize("NFD", "Người đàn ông đang chạy với con chó"),
    "hoà bình thuỷ  điện, Ø and Łódź",
    "những người đang chạy",
    "hai người đánh nhau trong phòng",
    "bạo lực và vũ khí trong trường học",
    "bao luc",
    "A man running in the park. Then a dog! Why?",
    "an old man in the park",
    "một túi đánh nhau TRÊN đường",
    "món ăn không ngon, dịch vụ quá tệ",
    "trận đấu bóng đá có bàn thắng đẹp",
    "cảnh sát bắt giữ kẻ phạm tội",
    "not bad at all",
    "Trời đẹp. Tôi đi chơi! Bạn thì sao?",
    "xyzzy qwerty",
    "",
    "   ",
]


def test_fold_accents_byte_for_byte():
    for s in CORPUS:
        assert ttext.fold_accents(s) == jtext.fold_accents(s), s
        assert tmeta._fold_pair(s) == jmeta._fold_pair(s), s
    assert ttext.fold_accents("Đường đi") == "Duong di"


def test_segmentation_and_stopwords(tmp_path):
    for s in CORPUS:
        assert ttext.segment_sentences(s) == jtext.segment_sentences(s), s
    assert ttext.DEFAULT_EN_STOPWORDS == jtext.DEFAULT_EN_STOPWORDS
    path = tmp_path / "stop.txt"
    path.write_text("Và\nCủa\n\n the \n", encoding="utf-8")
    assert ttext.load_stopwords(path) == jtext.load_stopwords(path) == {"và", "của", "the"}


def test_phrase_table_copied_entry_for_entry():
    assert list(ttrans.VI_EN_PHRASES.items()) == list(jtrans.VI_EN_PHRASES.items())
    t, j = ttrans.DictionaryTranslator(), jtrans.DictionaryTranslator()
    assert t.phrases == j.phrases
    assert t._phrases == j._phrases  # the longest-first walk order


def test_translator_matches():
    t, j = ttrans.DictionaryTranslator(), jtrans.DictionaryTranslator()
    custom = {"xe": "vehicle", "xe hơi": "sedan", "xé": "tear"}  # "xe" and "xé" fold alike
    tc, jc = ttrans.DictionaryTranslator(custom), jtrans.DictionaryTranslator(custom)
    for s in CORPUS:
        assert t(s) == j(s), s
        assert t.coverage(s) == j.coverage(s), s
        assert tc(s + " xe hơi xe") == jc(s + " xe hơi xe"), s
    assert t("đánh nhau trên đường phố") == "fighting on the road phố"


def test_preprocessor_matches():
    stop = {"đang", "the"}

    def boom(text):
        raise RuntimeError("network down")

    pairs = [
        (ttext.VietnamesePreprocessor(), jtext.VietnamesePreprocessor()),
        (ttext.VietnamesePreprocessor(stop, ttrans.DictionaryTranslator()),
         jtext.VietnamesePreprocessor(stop, jtrans.DictionaryTranslator())),
        (ttext.VietnamesePreprocessor(translator=boom), jtext.VietnamesePreprocessor(translator=boom)),
    ]
    for tp, jp in pairs:
        for s in CORPUS + CORPUS:  # the second pass reads the cache
            assert tp(s) == jp(s), s
    for s in CORPUS:
        assert ttext.VietnamesePreprocessor.looks_vietnamese(s) == \
            jtext.VietnamesePreprocessor.looks_vietnamese(s)
    assert pairs[1][0]("Danh nhau tren duong") == "fighting on the road"


METHODS = ("detect_language", "translate_to_english", "lowercasing", "uppercasing",
           "remove_stopwords", "remove_accents", "add_accents", "sentence_segment",
           "text_normalization", "text_classification", "sentiment_analysis",
           "preprocess_and_translate")


def test_word_processor_methods_match():
    t, j = twp.VietnameseTextProcessor(), jwp.VietnameseTextProcessor()
    assert t.stop_words == j.stop_words
    assert t._accent_map == j._accent_map
    for name in METHODS:
        for s in CORPUS + [jtext.fold_accents(s) for s in CORPUS]:
            assert getattr(t, name)(s) == getattr(j, name)(s), (name, s)


def test_word_processor_stopwords_file_and_injected_translator(tmp_path):
    sw = tmp_path / "stop.txt"
    sw.write_text("foo\nbar\nđang\n", encoding="utf-8")
    calls = []

    def fake(text):
        calls.append(text)
        return "TRANSLATED"

    t, j = twp.VietnameseTextProcessor(sw, fake), jwp.VietnameseTextProcessor(sw, fake)
    assert t.stop_words == j.stop_words == ["bar", "foo", "đang"]
    for s in CORPUS + ["foo keeps bar this đang"]:
        for name in ("remove_stopwords", "add_accents", "translate_to_english",
                     "preprocess_and_translate"):
            assert getattr(t, name)(s) == getattr(j, name)(s), (name, s)
    assert calls  # the hook ran
    # a translator without a phrase table: accents come from VI_EN_PHRASES
    assert t._accent_map == j._accent_map


@pytest.mark.parametrize("text,expected", [
    ("hoà bình", "hòa bình"),
    ("thuỷ  điện", "thủy điện"),
])
def test_tone_placement_as_jax(text, expected):
    assert twp.VietnameseTextProcessor().text_normalization(text) == expected == \
        jwp.VietnameseTextProcessor().text_normalization(text)
