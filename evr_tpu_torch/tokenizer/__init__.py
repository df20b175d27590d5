from .bpe import ClipTokenizer, get_default_tokenizer, tokenize

__all__ = ["ClipTokenizer", "get_default_tokenizer", "tokenize"]
