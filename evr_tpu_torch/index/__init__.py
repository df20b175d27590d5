from .engine import EmbeddingEngine
from .ivf import IVFIndex
from .ivfpq import IVFPQIndex
from .pq import PQIndex
from .store import FrameIndex, SearchHit, VideoRegistry

__all__ = [
    "EmbeddingEngine", "FrameIndex", "IVFIndex", "IVFPQIndex", "PQIndex", "SearchHit",
    "VideoRegistry",
]
