"""The query-preprocessing hook.

The part of ``evr_tpu/query/text.py`` the slice needs: the identity query
preprocessor. The Vietnamese pipeline, accent folding and the dictionary
translator are not ported yet.
"""

from __future__ import annotations


def identity_preprocessor(query: str) -> str:
    return query
