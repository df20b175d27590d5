from .diversify import mmr_order, mmr_select
from .events import format_event_for_frontend
from .metadata import MetadataStore
from .strategies import QueryEngine
from .text import identity_preprocessor

__all__ = [
    "MetadataStore",
    "format_event_for_frontend",
    "QueryEngine",
    "mmr_order",
    "mmr_select",
    "identity_preprocessor",
]
