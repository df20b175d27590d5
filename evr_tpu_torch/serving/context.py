"""ServingContext — the wired service graph behind the HTTP API (PyTorch).

Counterpart of ``evr_tpu/serving/context.py`` for the slice the port serves:
one object owns the data root, the embedding engine, one frame index per
embedding model, the metadata store, the registry and the search cache;
``boot()`` restores durable state from the data root's layout (per-video
``.npy`` embeddings, metadata JSON, ``video_mapping.json``), which is the
JAX package's, so either package serves the other's data root.

Text search runs through each model's ``QueryEngine`` (the one-call
``TextSearcher``; ``batch_window_ms`` coalesces concurrent queries), and
``image_searcher`` builds each model's one-call ``ImageSearcher``. Not ported
yet: ingest and upload jobs, the image and hybrid search routes (the image
searcher has no route until then), ASR transcripts, and the Vietnamese
preprocessing pipeline (queries take the identity preprocessor).
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.index import EmbeddingEngine, FrameIndex, VideoRegistry
from evr_tpu_torch.index.fused_image_search import ImageSearcher
from evr_tpu_torch.query.metadata import MetadataStore
from evr_tpu_torch.query.strategies import QueryEngine

from .cache import TTLCache


def video_fps(video_path) -> float:
    """Container fps, 25.0 when the file cannot be read."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) if cap.isOpened() else 0.0
    finally:
        cap.release()
    return fps if fps and fps > 0 else 25.0


class ServingContext:
    def __init__(
        self,
        data_root: DataRootConfig | str = "data",
        engine: EmbeddingEngine | None = None,
        index_dtype: str = "float32",
        search_impl: str = "xla",
        ivf_nprobe: int = 32,
        ivf_clusters: int | None = None,
        ivfpq_host_store: bool = False,
        mesh=None,
        batch_window_ms: float | None = None,
    ):
        """``index_dtype``, ``search_impl``, ``ivf_nprobe``, ``ivf_clusters``,
        ``ivfpq_host_store`` and ``mesh``: see ``FrameIndex``; applied to
        every per-model index. An invalid combination raises here, at boot,
        not at the first request. ``batch_window_ms``: concurrent queries
        arriving within the window coalesce into one device dispatch
        (``serving.batcher``); None disables."""
        self.data_root = (
            data_root
            if isinstance(data_root, DataRootConfig)
            else DataRootConfig(pathlib.Path(data_root))
        )
        self.engine = engine or EmbeddingEngine()
        # one index per embedding model: a text query with model M only ever
        # scores embeddings M produced
        self._indexes: dict[str, FrameIndex] = {}
        self._query_engines: dict[str, QueryEngine] = {}
        self._image_searchers: dict[str, ImageSearcher] = {}
        self.metadata = MetadataStore()
        self.registry = VideoRegistry(self.data_root.mapping_path)
        self.search_cache = TTLCache(default_ttl=3600.0)
        self.index_dtype = index_dtype
        self.search_impl = search_impl
        self.ivf_nprobe = ivf_nprobe
        self.ivf_clusters = ivf_clusters
        self.ivfpq_host_store = ivfpq_host_store
        self.batch_window_ms = batch_window_ms
        # per-model indexes build lazily: fail fast on an invalid tier combo
        self._index_kwargs = dict(
            device_dtype=index_dtype, search_impl=search_impl, ivf_nprobe=ivf_nprobe,
            ivf_clusters=ivf_clusters, ivfpq_host_store=ivfpq_host_store, mesh=mesh,
            device=self.engine.device,
        )
        FrameIndex(embed_dim=1, **self._index_kwargs)

    def resolve_path(self, p: str) -> pathlib.Path:
        """Registry paths may be data-root-relative or absolute."""
        path = pathlib.Path(p)
        return path if path.is_absolute() else self.data_root.root / path

    def first_frame(self, frames_dir) -> str | None:
        """First extracted frame of a video in numeric {frameidx}.jpg order;
        None when the directory is missing or empty."""
        if not frames_dir:
            return None
        d = self.resolve_path(frames_dir)
        if not d.exists():
            return None

        def order(p):
            try:
                return (0, int(p.stem), p.name)
            except ValueError:
                return (1, 0, p.name)

        frames = sorted((p for p in d.iterdir() if p.is_file()), key=order)
        return str(frames[0]) if frames else None

    # -- per-model index routing ------------------------------------------
    def index_for(self, model: str) -> FrameIndex:
        if model not in self._indexes:
            self._indexes[model] = FrameIndex(
                embed_dim=self.engine.cfg.embed_dim, **self._index_kwargs
            )
        return self._indexes[model]

    @property
    def index(self) -> FrameIndex:
        """The active model's index."""
        return self.index_for(self.engine.active_model)

    @property
    def query_engine(self) -> QueryEngine:
        model = self.engine.active_model
        if model not in self._query_engines:
            self._query_engines[model] = QueryEngine(
                self.engine, self.index_for(model), self.metadata,
                batch_window_ms=self.batch_window_ms,
            )
        return self._query_engines[model]

    @property
    def image_searcher(self) -> ImageSearcher:
        """The active model's one-call image searcher over its index."""
        model = self.engine.active_model
        if model not in self._image_searchers:
            self._image_searchers[model] = ImageSearcher(
                self.engine, self.index_for(model), batch_window_ms=self.batch_window_ms
            )
        return self._image_searchers[model]

    # -- boot / durable state ---------------------------------------------
    def boot(self) -> list[str]:
        """Load every registered video's embeddings + metadata from disk,
        after pruning registry entries whose video file disappeared.
        Returns the video names loaded."""
        self.registry.prune_missing(self.data_root.root)
        resolve = self.resolve_path
        loaded = []
        for name in self.registry.names():
            entry = self.registry.get(name)
            emb_path = resolve(entry.get("embeddings_file", ""))
            meta_path = resolve(entry.get("metadata_file", ""))
            if not emb_path.exists():
                continue
            emb = np.load(emb_path)
            records = (
                json.loads(meta_path.read_text(encoding="utf-8"))
                if meta_path.exists()
                else []
            )
            frame_names = [r.get("frameid", f"{i}.jpg") for i, r in enumerate(records)]
            if len(frame_names) != len(emb):
                frame_names = None
            model = entry.get("embedding_model", "original")
            self.index_for(model).add_video(name, emb, frame_names)
            fps = 25.0
            video_path = entry.get("video_path", "")
            if video_path and resolve(video_path).exists():
                fps = video_fps(resolve(video_path))
            self.metadata.add_video(name, records, fps=fps)
            loaded.append(name)
        return loaded

    def prune_missing(self) -> list[str]:
        """Drop registry entries whose video file disappeared and purge the
        indexes and metadata of those videos."""
        dropped = self.registry.prune_missing(self.data_root.root)
        for name in dropped:
            for index in self._indexes.values():
                index.remove_video(name)
            self.metadata.remove_video(name)
        return dropped

    # -- video identity ---------------------------------------------------
    def video_names(self) -> list[str]:
        return self.registry.names()

    def video_name_from_id(self, video_id: str) -> str | None:
        """'video-N' (1-based registry order) → video name."""
        if not video_id or not video_id.startswith("video-"):
            return None
        try:
            num = int(video_id.split("-")[1])
        except (IndexError, ValueError):
            return None
        names = self.video_names()
        if 1 <= num <= len(names):
            return names[num - 1]
        return None

    # -- video file info --------------------------------------------------
    @staticmethod
    def video_file_info(video_path: str) -> dict:
        import cv2

        info = {"duration": 0.0, "resolution": "unknown"}
        cap = cv2.VideoCapture(video_path)
        try:
            if cap.isOpened():
                fps = cap.get(cv2.CAP_PROP_FPS) or 0
                frames = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0
                if fps > 0:
                    info["duration"] = frames / fps
                w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                if w and h:
                    info["resolution"] = f"{w}x{h}"
        finally:
            cap.release()
        return info

    def video_summary(self, idx: int, name: str) -> dict | None:
        entry = self.registry.get(name) or {}
        video_path = entry.get("video_path", "")
        p = self.resolve_path(video_path) if video_path else None
        if p is None or not p.exists():
            return None
        info = self.video_file_info(str(p))
        return {
            "id": f"video-{idx}",
            "title": name,
            "thumbnail": self.first_frame(entry.get("frames_dir")),
            "duration": info["duration"],
            "uploadDate": time.strftime("%Y-%m-%d", time.gmtime(p.stat().st_ctime)),
            "size": f"{p.stat().st_size // (1024 * 1024)} MB",
            "resolution": info["resolution"],
            "path": str(video_path),
        }
