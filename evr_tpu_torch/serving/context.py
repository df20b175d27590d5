"""ServingContext — the wired service graph behind the HTTP API (PyTorch).

Counterpart of ``evr_tpu/serving/context.py`` for the slice the port serves:
one object owns the data root, the embedding engine, one frame index per
embedding model, the metadata store, the registry and the search cache;
``boot()`` restores durable state from the data root's layout (per-video
``.npy`` embeddings, metadata JSON, ``video_mapping.json``), which is the
JAX package's, so either package serves the other's data root.

Text search runs through each model's ``QueryEngine`` (the one-call
``TextSearcher``; ``batch_window_ms`` coalesces concurrent queries), its
queries through the Vietnamese preprocessing pipeline with the local
dictionary translator unless another ``preprocessor`` is given. Image search
runs through each model's one-call ``ImageSearcher``; a hybrid query encodes
the image and the text apart and searches their blend through
``FrameIndex.search_raw``, as the JAX package does. ``boot`` also loads each
video's ASR transcript (speech search). ``ingest`` runs the ingest pipeline
into the live state (``ingest.pipeline.ingest_video``) and empties the
caches; ``ingest_jobs`` runs uploads in the background (``serving/jobs.py``),
each ending in ``upload_payload``.
"""

from __future__ import annotations

import base64
import json
import pathlib
import time

import numpy as np

from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.index import EmbeddingEngine, FrameIndex, VideoRegistry
from evr_tpu_torch.index.fused_image_search import ImageSearcher
from evr_tpu_torch.ingest.pipeline import ingest_video, video_fps
from evr_tpu_torch.ingest.transcripts import transcript_path_for
from evr_tpu_torch.ops.preprocess import stage_array_fast
from evr_tpu_torch.query.events import format_event_for_frontend
from evr_tpu_torch.query.metadata import MetadataStore
from evr_tpu_torch.query.strategies import QueryEngine
from evr_tpu_torch.utils import get_logger

from .cache import TTLCache


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes → uint8 RGB [H, W, 3] by cv2, as PIL's
    ``Image.open(...).convert("RGB")`` reads them: alpha dropped, grey
    replicated, EXIF orientation not applied. Raises ValueError when the
    bytes are no image."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise ValueError("cannot decode image")
    return np.ascontiguousarray(bgr[:, :, ::-1])


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
        transcriber=None,
        preprocessor=None,
        scene_threshold: float = 30.0,
        annotator=None,
    ):
        """``index_dtype``, ``search_impl``, ``ivf_nprobe``, ``ivf_clusters``,
        ``ivfpq_host_store`` and ``mesh`` (the index split over its
        slots, every tier): see ``FrameIndex``; applied to every per-model index. An invalid combination raises here, at boot,
        not at the first request. ``batch_window_ms``: concurrent queries
        arriving within the window coalesce into one device dispatch
        (``serving.batcher``); None disables. ``transcriber``: a
        ``serving.providers`` object for /api/transcribe-voice (None: the
        route answers 501). ``preprocessor``: the query hook; None is the
        Vietnamese pipeline with the zero-egress dictionary translator.
        ``scene_threshold``: the content threshold of an upload's scene
        detection; ``annotator``: the default frame annotator of uploads
        (``ingest.annotate``; None gives empty detections)."""
        self.data_root = (
            data_root
            if isinstance(data_root, DataRootConfig)
            else DataRootConfig(pathlib.Path(data_root))
        )
        self.engine = engine or EmbeddingEngine()
        self.mesh = mesh
        # one index per embedding model: a text query with model M only ever
        # scores embeddings M produced
        self._indexes: dict[str, FrameIndex] = {}
        self._query_engines: dict[str, QueryEngine] = {}
        self._image_searchers: dict[str, ImageSearcher] = {}
        self.metadata = MetadataStore()
        self.registry = VideoRegistry(self.data_root.mapping_path)
        self.search_cache = TTLCache(default_ttl=3600.0)
        self.viz_cache = TTLCache(default_ttl=24 * 3600.0)
        self.transcriber = transcriber
        if preprocessor is None:
            from evr_tpu_torch.query.text import VietnamesePreprocessor
            from evr_tpu_torch.query.translate import DictionaryTranslator

            preprocessor = VietnamesePreprocessor(translator=DictionaryTranslator())
        self.preprocessor = preprocessor
        self.annotator = annotator
        self.scene_threshold = scene_threshold
        self._ingest_jobs = None
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
            device=None if mesh is not None else self.engine.device,
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
                preprocessor=self.preprocessor, batch_window_ms=self.batch_window_ms,
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
            # ASR transcript (speech search): the registry's file, else the
            # `{video}_transcript.json` sidecar
            tr_path = resolve(entry.get("transcript_file", ""))
            if not (entry.get("transcript_file") and tr_path.exists()):
                tr_path = transcript_path_for(meta_path, name)
            if tr_path.exists():
                try:
                    self.metadata.load_transcript_json(name, tr_path)
                except (ValueError, KeyError) as e:
                    get_logger("evr_tpu_torch.serving").warning(
                        "skipping unreadable transcript %s: %s", tr_path, e)
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

    # -- ingest -------------------------------------------------------------
    def ingest(self, video_path, video_name=None, annotator=None, progress=None):
        """Ingest one video into the active model's index, the metadata store
        and the registry (``ingest.pipeline.ingest_video``), then empty the
        search and view caches."""
        result = ingest_video(
            video_path,
            self.data_root,
            self.engine,
            index=self.index,
            registry=self.registry,
            metadata_store=self.metadata,
            annotator=annotator if annotator is not None else self.annotator,
            scene_threshold=self.scene_threshold,
            video_name=video_name,
            progress=progress,
        )
        self.search_cache.invalidate()
        self.viz_cache.invalidate()
        return result

    @property
    def ingest_jobs(self):
        """The background ingest-job manager (``serving/jobs.py``), made at
        first use."""
        if self._ingest_jobs is None:
            from .jobs import IngestJobManager

            self._ingest_jobs = IngestJobManager()
        return self._ingest_jobs

    def upload_payload(self, save_path, video_name, model_name, result) -> dict:
        """The upload response body: the synchronous upload's answer and an
        async job's final payload."""
        info = self.video_file_info(str(save_path))
        return {
            "status": "success",
            "message": "Video processed successfully",
            "video": {
                "id": f"video-{int(time.time())}",
                "title": video_name,
                "thumbnail": self.first_frame(result.frames_dir),
                "path": str(save_path),
                "uploadDate": time.strftime("%Y-%m-%d"),
                "size": f"{save_path.stat().st_size // (1024 * 1024)} MB",
                "resolution": info["resolution"],
                "duration": info["duration"],
                "embedding_model": model_name,
                "frames": result.n_frames,
            },
        }

    # -- image and hybrid search ------------------------------------------
    def _stage(self, rgb: np.ndarray) -> np.ndarray:
        """A query image staged with the engine's geometry: the engine's own
        stager where it has one (SigLIP squashes, no crop), else CLIP's
        shorter-side resize and centre crop (``ops.preprocess.stage_array_fast``)."""
        stage = getattr(self.engine, "stage_array", None)
        if stage is not None:
            return stage(rgb)
        return stage_array_fast(rgb, self.engine.cfg.vision.image_size)

    def load_image_source(self, source: str) -> np.ndarray:
        """An image search source (data URL, base64 or local path) → uint8
        RGB [H, W, 3]. Remote URLs are not fetched. A string that cannot name
        a file is read as base64 (the JAX package's ``Path.exists`` raises on
        one with a component over 255 characters: an HTTP 500)."""
        if source.startswith("data:"):
            return decode_image(base64.b64decode(source.split(",", 1)[1]))
        if source.startswith(("http://", "https://")):
            raise ValueError(
                "remote image URLs are not fetched in this deployment; "
                "send base64 or a local path"
            )
        path = pathlib.Path(source)
        try:
            is_file = path.is_file()
        except OSError:  # e.g. base64 with a run of over 255 characters between slashes
            is_file = False
        if is_file:
            return decode_image(path.read_bytes())
        try:
            return decode_image(base64.b64decode(source))
        except Exception:
            raise ValueError(f"cannot resolve image source: {source[:64]}") from None

    def search_by_image(
        self, source: str, threshold: float, top_k: int, video_name: str | None = None
    ) -> list[dict]:
        """Frames like the image: one dispatch of the active model's
        ``ImageSearcher`` (normalise → every vision block → GEMM → top-k).
        An engine without ``models`` (``SiglipEngine``) takes two steps
        through its own preprocessing: the engine's encode, then
        ``FrameIndex.search_raw``."""
        staged = self._stage(self.load_image_source(source))
        if not hasattr(self.engine, "models"):
            v = np.asarray(self.engine.encode_staged_images(staged[None], normalise=True))[0]
            scores, rows = self.index.search_raw(v[None], top_k * 3, video_name)
            return self._events_from_rows(scores[0], rows[0], threshold, top_k)
        scores, rows = self.image_searcher.search(staged[None], top_k * 3, video_name)
        return self._events_from_rows(scores[0], rows[0], threshold, top_k)

    def _events_from_rows(self, scores, rows, threshold: float, top_k: int) -> list[dict]:
        """Row hits → frontend events (image and hybrid search)."""
        results = []
        for score, row in zip(scores, rows):
            score = float(score)
            if not np.isfinite(score) or score < threshold:
                continue
            video, frame_name, _ = self.index.resolve_row(int(row))
            try:
                hit_frame = self.metadata.frame_by_idx(video, int(frame_name.rsplit(".", 1)[0]))
            except ValueError:
                hit_frame = None
            if hit_frame is None:
                continue
            event = format_event_for_frontend(
                {**hit_frame.raw, "clip_similarity": score}, fps=self.metadata.fps(video))
            event["clip_similarity"] = score
            results.append(event)
        results.sort(key=lambda e: e.get("clip_similarity", 0), reverse=True)
        return results[:top_k]

    def search_hybrid(
        self,
        source: str,
        query: str,
        image_weight: float,
        threshold: float,
        top_k: int,
        video_name: str | None = None,
    ) -> list[dict]:
        """Image + text: one composite direction ``normalise(α·v_image +
        (1−α)·v_text)``, "frames like this image that also match this text".
        The image (alone, unpadded) and the text encode in two dispatches; the
        blend searches through ``FrameIndex.search_raw``, so every index tier
        serves it."""
        staged = self._stage(self.load_image_source(source))
        v_img = np.asarray(
            self.engine.encode_staged_images(staged[None], normalise=True, pad=False)[0],
            np.float32)
        v_txt = np.asarray(self.engine.get_text_features(self.query_engine.preprocess(query)),
                           np.float32).reshape(-1)
        v_txt = v_txt / max(float(np.linalg.norm(v_txt)), 1e-12)
        v = image_weight * v_img + (1.0 - image_weight) * v_txt
        v /= max(float(np.linalg.norm(v)), 1e-12)
        scores, rows = self.index.search_raw(v[None], top_k * 3, video_name)
        return self._events_from_rows(scores[0], rows[0], threshold, top_k)
