from .engine import EmbeddingEngine
from .store import FrameIndex, SearchHit, VideoRegistry

__all__ = ["EmbeddingEngine", "FrameIndex", "SearchHit", "VideoRegistry"]
