from .bpe import ClipTokenizer, get_default_tokenizer, tokenize
from .fallbacks import SiglipFallbackTokenizer, WhisperFallbackTokenizer

__all__ = [
    "ClipTokenizer",
    "get_default_tokenizer",
    "tokenize",
    "SiglipFallbackTokenizer",
    "WhisperFallbackTokenizer",
]
