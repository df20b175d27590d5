"""Device-resident L2-normalised frame index + durable per-video registry.

Counterpart of ``evr_tpu/index/store.py`` (exact search only): every video
lives in ONE (N_padded, D) tensor on the device, each video owning a
contiguous row interval, so a search over any video (or all of them) is a
row-range-masked score + top-k: ``search_impl="xla"`` (the default) is one
GEMM and a sort (``ops.topk.cosine_topk``), ``"pallas"`` the fused streaming
kernel K4 (``ops.retrieval.fused_topk``), which takes any padded row count.
Row → (video, frame) resolution is host-side bookkeeping.

Storage: float32 (exact), bfloat16, or int8 with symmetric per-row scales
applied after the GEMM. ``save``/``load`` write the JAX package's layout
(``embedding/{video}_embeddings.npy`` + ``metadata/{video}_frames.json``), so
each package loads the other's index. The IVF / IVF-PQ tiers (ROADMAP item
A16) and mesh sharding are not ported yet.
"""

from __future__ import annotations

import json
import pathlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.ops.retrieval import fused_topk
from evr_tpu_torch.ops.topk import cosine_topk
from evr_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_SEARCH_IMPLS = ("xla", "pallas")


@dataclass
class VideoEntry:
    name: str
    n_frames: int
    row_start: int = 0
    frame_names: list[str] = field(default_factory=list)


@dataclass
class SearchHit:
    video: str
    frame_name: str
    score: float
    row: int
    frame_index: int  # position within the video


class FrameIndex:
    """In-memory + on-device cosine retrieval index over video frames."""

    def __init__(
        self,
        embed_dim: int = 512,
        pad_multiple: int = 1024,
        device_dtype: str = "float32",
        search_impl: str = "xla",
        device=None,
    ):
        """``pad_multiple``: device rows are allocated in multiples of this.
        ``search_impl``: "xla" (GEMM + sort, ``cosine_topk``) or "pallas"
        (the fused streaming kernel K4, ``fused_topk``); both give the same
        top-k."""
        if device_dtype not in _DTYPES:
            raise ValueError(f"unknown device_dtype {device_dtype!r}")
        if search_impl in ("ivf", "ivfpq"):
            raise NotImplementedError(
                f"search_impl={search_impl!r}: the IVF / IVF-PQ tiers are not ported "
                "yet (ROADMAP item A16)"
            )
        if search_impl not in _SEARCH_IMPLS:
            raise ValueError(f"unknown search_impl {search_impl!r}")
        self.embed_dim = embed_dim
        self.pad_multiple = pad_multiple
        self.device_dtype = device_dtype
        self.search_impl = search_impl
        self.device = resolve_device(device)
        self._videos: dict[str, VideoEntry] = {}
        self._embeddings: dict[str, np.ndarray] = {}
        self._order: list[str] = []
        self._device_index: torch.Tensor | None = None
        self._row_scales: torch.Tensor | None = None
        self._total = 0
        self._dirty = True
        self.version = 0  # bumped on every rebuild or append (cache key)
        # serving is threaded: mutation, build and row resolution share it
        self._lock = threading.RLock()

    # -- mutation ---------------------------------------------------------
    def add_video(
        self, name: str, embeddings: np.ndarray, frame_names: list[str] | None = None
    ) -> None:
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.embed_dim:
            raise ValueError(
                f"embeddings for {name!r} must be (N, {self.embed_dim}), got {emb.shape}"
            )
        if frame_names is None:
            frame_names = [f"{i}.jpg" for i in range(len(emb))]
        if len(frame_names) != len(emb):
            raise ValueError(
                f"{name!r}: {len(frame_names)} frame names for {len(emb)} embeddings"
            )
        with self._lock:
            if self._try_append(name, emb, frame_names):
                return
            if name not in self._videos:
                self._order.append(name)
            self._videos[name] = VideoEntry(name, len(emb), 0, list(frame_names))
            self._embeddings[name] = emb
            self._dirty = True

    def _try_append(self, name: str, emb: np.ndarray, frame_names: list[str]) -> bool:
        """A NEW video whose rows fit the allocated padding is written into
        the device tensor in place, with no O(total) rebuild. Replacements,
        an int8 index and a full index rebuild instead (returns False)."""
        if (
            self._dirty
            or self._device_index is None
            or name in self._videos
            or self._row_scales is not None
        ):
            return False
        n = len(emb)
        if self._total + n > self._device_index.shape[0]:
            return False
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        rows = (emb / np.maximum(norms, 1e-12)).astype(np.float32)
        self._device_index[self._total : self._total + n] = torch.from_numpy(rows).to(
            self.device
        ).to(self._device_index.dtype)
        self._order.append(name)
        self._videos[name] = VideoEntry(name, n, self._total, list(frame_names))
        self._embeddings[name] = emb
        self._total += n
        self.version += 1
        return True

    def remove_video(self, name: str) -> None:
        with self._lock:
            self._videos.pop(name, None)
            self._embeddings.pop(name, None)
            if name in self._order:
                self._order.remove(name)
            self._dirty = True

    # -- properties -------------------------------------------------------
    @property
    def videos(self) -> list[str]:
        return list(self._order)

    @property
    def total_frames(self) -> int:
        return sum(v.n_frames for v in self._videos.values())

    def frame_names(self, name: str) -> list[str]:
        return list(self._videos[name].frame_names)

    def get_embeddings(self, name: str, normalised: bool = True) -> np.ndarray:
        """Per-video embedding matrix, row-normalised by default."""
        emb = self._embeddings[name]
        if not normalised:
            return emb
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(norms, 1e-12)

    # -- device build -----------------------------------------------------
    def _padded_rows(self, n: int) -> int:
        # 25% headroom so uploads append in place
        m = self.pad_multiple
        n = int(n * 1.25)
        return max(m, ((n + m - 1) // m) * m)

    def build(self) -> None:
        """(Re)concatenate, normalise, pad and copy the index to the device."""
        with self._lock:
            self._build_locked()

    def _build_locked(self) -> None:
        row = 0
        mats = []
        for name in self._order:
            entry = self._videos[name]
            entry.row_start = row
            row += entry.n_frames
            mats.append(self.get_embeddings(name))
        total = row
        full = np.zeros((self._padded_rows(total), self.embed_dim), dtype=np.float32)
        if mats:
            full[:total] = np.concatenate(mats, axis=0)
        self._row_scales = None
        if self.device_dtype == "int8":
            max_abs = np.maximum(np.abs(full).max(axis=1), 1e-12)
            scales = (max_abs / 127.0).astype(np.float32)
            quant = np.clip(np.round(full / scales[:, None]), -127, 127).astype(np.int8)
            self._device_index = torch.from_numpy(quant).to(self.device)
            self._row_scales = torch.from_numpy(scales).to(self.device)
        else:
            self._device_index = torch.from_numpy(full).to(self.device).to(
                _DTYPES[self.device_dtype]
            )
        self._total = total
        self._dirty = False
        self.version += 1

    def _ensure_built(self):
        with self._lock:
            if self._dirty or self._device_index is None:
                self._build_locked()

    # -- search -----------------------------------------------------------
    def _range_for(self, video_name: str | None) -> tuple[int, int]:
        if video_name is None:
            return 0, self._total
        entry = self._videos[video_name]
        return entry.row_start, entry.row_start + entry.n_frames

    def search_raw(
        self, queries: np.ndarray, top_k: int, video_name: str | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], global row indices [Q, k]); k clamped to range."""
        with self._lock:
            return self._search_raw_locked(queries, top_k, video_name)

    def _search_raw_locked(self, queries, top_k, video_name):
        self._ensure_built()
        start, end = self._range_for(video_name)
        k = max(1, min(top_k, end - start))
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        topk = fused_topk if self.search_impl == "pallas" else cosine_topk
        with torch.inference_mode():
            scores, rows = topk(self._device_index, q, start, end, k, row_scales=self._row_scales)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def resolve_row(self, row: int) -> tuple[str, str, int]:
        """global row → (video, frame_name, frame_index)."""
        with self._lock:
            return self._resolve_row_locked(row)

    def _resolve_row_locked(self, row: int) -> tuple[str, str, int]:
        for name in self._order:
            entry = self._videos[name]
            if entry.row_start <= row < entry.row_start + entry.n_frames:
                i = row - entry.row_start
                return name, entry.frame_names[i], i
        raise IndexError(f"row {row} out of range")

    def search(
        self, queries: np.ndarray, top_k: int, video_name: str | None = None
    ) -> list[list[SearchHit]]:
        # one lock around scoring AND row resolution: a remove_video between
        # the two would compact the row layout under a just-computed row id
        with self._lock:
            scores, rows = self._search_raw_locked(queries, top_k, video_name)
            out: list[list[SearchHit]] = []
            for qi in range(scores.shape[0]):
                hits = []
                for score, row in zip(scores[qi], rows[qi]):
                    if not np.isfinite(score):
                        continue
                    video, frame, fidx = self._resolve_row_locked(int(row))
                    hits.append(SearchHit(video, frame, float(score), int(row), fidx))
                out.append(hits)
            return out

    # -- persistence ------------------------------------------------------
    def save(self, data_root) -> None:
        """Per-video .npy + frame-name JSON, the JAX package's layout."""
        cfg = data_root if isinstance(data_root, DataRootConfig) else DataRootConfig(pathlib.Path(data_root))
        cfg.ensure()
        for name in self._order:
            np.save(cfg.embedding_dir / f"{name}_embeddings.npy", self._embeddings[name])
            (cfg.metadata_dir / f"{name}_frames.json").write_text(
                json.dumps(self._videos[name].frame_names)
            )

    @classmethod
    def load(cls, data_root, embed_dim: int = 512, device=None, **kwargs) -> "FrameIndex":
        cfg = data_root if isinstance(data_root, DataRootConfig) else DataRootConfig(pathlib.Path(data_root))
        idx = cls(embed_dim=embed_dim, device=device, **kwargs)
        for npy in sorted(cfg.embedding_dir.glob("*_embeddings.npy")):
            name = npy.name[: -len("_embeddings.npy")]
            emb = np.load(npy)
            frames_file = cfg.metadata_dir / f"{name}_frames.json"
            frame_names = (
                json.loads(frames_file.read_text()) if frames_file.exists() else None
            )
            idx.add_video(name, emb, frame_names)
        return idx


class VideoRegistry:
    """Durable per-video artefact registry (``metadata/video_mapping.json``),
    the JAX package's schema: ``{metadata_file, embeddings_file, video_path,
    frames_dir, embedding_model, transcript_file}``. Paths are stored as
    given; data-root-relative paths resolve against the root."""

    FIELDS = (
        "metadata_file",
        "embeddings_file",
        "video_path",
        "frames_dir",
        "embedding_model",
        "transcript_file",
    )

    def __init__(self, mapping_path):
        self.path = pathlib.Path(mapping_path)
        self._mapping: dict[str, dict] = {}
        if self.path.exists():
            self._mapping = json.loads(self.path.read_text())

    def add(self, name: str, **paths) -> None:
        unknown = set(paths) - set(self.FIELDS)
        if unknown:
            raise KeyError(f"unknown registry fields: {sorted(unknown)}")
        self._mapping[name] = {k: str(v) for k, v in paths.items()}
        self.save()

    def remove(self, name: str) -> None:
        if self._mapping.pop(name, None) is not None:
            self.save()

    def get(self, name: str) -> dict | None:
        return self._mapping.get(name)

    def names(self) -> list[str]:
        return list(self._mapping)

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._mapping, indent=2, ensure_ascii=False))

    def prune_missing(self, root: pathlib.Path | None = None) -> list[str]:
        """Drop entries whose video file disappeared (the boot self-heal)."""
        dropped = []
        for name, entry in list(self._mapping.items()):
            vp = pathlib.Path(entry.get("video_path", ""))
            if root is not None and not vp.is_absolute():
                vp = root / vp
            if not vp.exists():
                dropped.append(name)
                del self._mapping[name]
        if dropped:
            self.save()
        return dropped
