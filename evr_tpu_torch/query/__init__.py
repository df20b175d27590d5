from .diversify import mmr_order, mmr_select
from .events import format_event_for_frontend
from .metadata import MetadataStore
from .strategies import SEARCH_METHODS, QueryEngine
from .text import (
    DEFAULT_EN_STOPWORDS,
    QueryPreprocessor,
    VietnamesePreprocessor,
    fold_accents,
    identity_preprocessor,
    load_stopwords,
    segment_sentences,
)
from .translate import VI_EN_PHRASES, DictionaryTranslator
from .word_processing import VietnameseTextProcessor

__all__ = [
    "MetadataStore",
    "format_event_for_frontend",
    "QueryEngine",
    "SEARCH_METHODS",
    "mmr_order",
    "mmr_select",
    "fold_accents",
    "identity_preprocessor",
    "QueryPreprocessor",
    "VietnamesePreprocessor",
    "DictionaryTranslator",
    "VietnameseTextProcessor",
    "VI_EN_PHRASES",
    "DEFAULT_EN_STOPWORDS",
    "load_stopwords",
    "segment_sentences",
]
