"""Device-resident L2-normalised frame index + durable per-video registry.

Counterpart of ``evr_tpu/index/store.py`` without a mesh: every video lives
in ONE (N_padded, D) tensor on the device, each video owning a contiguous row
interval, so a search over any video (or all of them) is a row-range-masked
score + top-k: ``search_impl="xla"`` (the default) is one GEMM and a sort
(``ops.topk.cosine_topk``), ``"pallas"`` the fused streaming kernel K4
(``ops.retrieval.fused_topk``), which takes any padded row count. Row →
(video, frame) resolution is host-side bookkeeping.

The approximate tiers: ``search_impl="ivf"`` builds an ``IVFIndex`` and
``"ivfpq"`` an ``IVFPQIndex`` over the corpus, and a global (unscoped) search
probes ``ivf_nprobe`` of their lists; video-scoped searches stay exact. The
``ivfpq`` tier is built by ``IVFPQIndex.build`` (the unpacked layout, which
reaches no kernel: K7 serves only the packed layout's ``adc_impl="pallas"``)
and always re-ranks ``max(50, 4k)`` candidates exactly.

Storage: float32 (exact), bfloat16, or int8 with symmetric per-row scales
applied after the GEMM. ``save``/``load`` write the JAX package's layout
(``embedding/{video}_embeddings.npy`` + ``metadata/{video}_frames.json``), so
each package loads the other's index.

With a ``mesh`` the exact tiers split the rows over ``mesh_axis``, one shard
a slot (``parallel.sharded_search.ShardedIndex``): the rows are padded to a
multiple of 128 a shard, at least ``shards × 128``, and a search with more
than one shard and k within a shard scores each shard on its slot and merges
the slots' top k (``sharded_cosine_topk``, K4 on each slot under
``search_impl="pallas"``). The ANN tiers under a mesh build one sub-index a
shard (``parallel.sharded_ann``) once the corpus holds at least two rows a
shard, sized as the JAX package sizes them (~√(N/S) lists, at most the
smallest shard's rows); a smaller corpus takes the one-device tier.
"""

from __future__ import annotations

import json
import pathlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.index.ivf import IVFIndex
from evr_tpu_torch.index.ivfpq import IVFPQIndex, quantize_host_store
from evr_tpu_torch.ops.retrieval import fused_topk
from evr_tpu_torch.ops.topk import cosine_topk
from evr_tpu_torch.parallel.sharded_search import ShardedIndex, place_rows
from evr_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_SEARCH_IMPLS = ("xla", "pallas", "ivf", "ivfpq")
_ANN_IMPLS = ("ivf", "ivfpq")


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
        ivf_nprobe: int = 32,
        ivf_clusters: int | None = None,
        ivfpq_host_store: bool = False,
        mesh=None,
        device=None,
        mesh_axis: str = "data",
    ):
        """``pad_multiple``: device rows are allocated in multiples of this.
        ``search_impl``: "xla" (GEMM + sort, ``cosine_topk``) or "pallas"
        (the fused streaming kernel K4, ``fused_topk``), both exact and
        giving the same top-k; or the approximate tiers "ivf" (inverted
        lists; ``ivf_nprobe`` of ``ivf_clusters`` lists probed, ~√N lists by
        default; ``ivf_nprobe = ivf_clusters`` is brute force) and "ivfpq"
        (the same probing over residual PQ codes with an exact re-rank of
        max(50, 4k) candidates; float32/bfloat16 storage only).
        ``ivfpq_host_store`` (ivfpq only): the re-rank rows live in host
        memory as int8 with per-row scales and the device keeps only the PQ
        codes; appended rows join the store with their ids. ``mesh``: the
        exact tiers' rows split over ``mesh_axis``, the ANN tiers built a
        shard a group of it (module docstring); ``device`` is then the first
        slot's."""
        if device_dtype not in _DTYPES:
            raise ValueError(f"unknown device_dtype {device_dtype!r}")
        if search_impl not in _SEARCH_IMPLS:
            raise ValueError(f"unknown search_impl {search_impl!r}")
        if search_impl == "ivfpq" and device_dtype == "int8":
            # PQ already compresses to S bytes a row; int8 originals buy nothing
            raise ValueError("search_impl='ivfpq' supports float32/bfloat16 storage only")
        if search_impl == "ivf" and mesh is not None and device_dtype == "int8":
            raise ValueError(
                "mesh-sharded IVF stores float32/bfloat16 shards; use "
                "single-device IVF for the int8 inverted-file tier")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            device = mesh.slot_devices[mesh.local_slots[0]]
        if ivfpq_host_store and search_impl != "ivfpq":
            raise ValueError("ivfpq_host_store requires search_impl='ivfpq'")
        self.embed_dim = embed_dim
        self.pad_multiple = pad_multiple
        self.device_dtype = device_dtype
        self.search_impl = search_impl
        self.ivf_nprobe = ivf_nprobe
        self.ivf_clusters = ivf_clusters
        self.ivfpq_host_store = ivfpq_host_store
        self._ivf = None
        self._ivf_built_rows = 0
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
        the device tensor in place, with no O(total) rebuild; under the ANN
        tiers its rows are appended to the built index (and to the int8 host
        store) until the corpus outgrows the build by half. Replacements, an
        int8 index and a full index rebuild instead (returns False)."""
        ann = self.search_impl in _ANN_IMPLS
        if (
            self._dirty
            or self._device_index is None
            or name in self._videos
            or self._row_scales is not None
            or (ann and self._ivf is None)
        ):
            return False
        n = len(emb)
        if self.mesh is not None or self._total + n > self._device_index.shape[0]:
            return False
        # centroids and codebooks do not move on append: past 1.5x the rows
        # they were trained on, rebuild so the lists re-balance
        if ann and self._total + n > 1.5 * self._ivf_built_rows:
            return False
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        rows = (emb / np.maximum(norms, 1e-12)).astype(np.float32)
        if ann:
            if self.ivfpq_host_store:
                # the host re-rank rows stay in lockstep with the appended ids
                quant, scales = quantize_host_store(rows)
                self._ivf._originals_int8 = np.concatenate([self._ivf._originals_int8, quant])
                self._ivf._originals_int8_scales = np.concatenate(
                    [self._ivf._originals_int8_scales, scales]
                )
            self._ivf.append(rows)
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
        m = self.pad_multiple
        if self.mesh is not None:
            # whole 128-row tiles a shard, the total divisible by the shards
            shards = self.mesh.axis_size(self.mesh_axis)
            per = -(-max(n, 1) // shards)
            return ((per + 127) // 128) * 128 * shards
        # 25% headroom so uploads append in place
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
        self._ivf = None
        if self.search_impl in _ANN_IMPLS and total > 1:
            self._build_ann(full[:total])
        self._row_scales = None
        if self.device_dtype == "int8":
            max_abs = np.maximum(np.abs(full).max(axis=1), 1e-12)
            scales = (max_abs / 127.0).astype(np.float32)
            quant = np.clip(np.round(full / scales[:, None]), -127, 127).astype(np.int8)
            rows, self._row_scales = torch.from_numpy(quant), torch.from_numpy(scales)
        else:
            rows = torch.from_numpy(full).to(_DTYPES[self.device_dtype])
        if self.mesh is not None:
            self._device_index = ShardedIndex(
                self.mesh, self.mesh_axis, place_rows(self.mesh, rows, self.mesh_axis),
                place_rows(self.mesh, self._row_scales, self.mesh_axis))
            self._row_scales = None  # the shards carry theirs
        else:
            self._device_index = rows.to(self.device)
            if self._row_scales is not None:
                self._row_scales = self._row_scales.to(self.device)
        self._total = total
        self._dirty = False
        self.version += 1

    def _build_ann(self, rows: np.ndarray) -> None:
        """The IVF or IVF-PQ index over the corpus's normalised rows, as the
        JAX package sizes it: ~√N lists unless ``ivf_clusters`` is given,
        capacity factor 1.3, 6 k-means iterations; int8 IVF storage through
        ``build_device``; IVF-PQ with the largest subspace count ≤ 64 that
        divides D and the fp32 originals (or the int8 host store) for its
        re-rank. Under a mesh with at least two rows a shard: the sharded
        tier (~√(N/S) lists, at most the smallest shard's rows; IVF-PQ's
        ``n_centroids`` at most the smallest shard's rows too)."""
        total = rows.shape[0]
        self._ivf_built_rows = total
        n_shards = self.mesh.axis_size(self.mesh_axis) if self.mesh is not None else 0
        if self.mesh is not None and total >= 2 * n_shards:
            from evr_tpu_torch.parallel.sharded_ann import ShardedIVFIndex, ShardedIVFPQIndex

            # the sharded tiers: one sub-index a shard (parallel.sharded_ann);
            # the smallest of the balanced shards holds floor(N / S) rows
            smallest = max(1, total // n_shards)
            k = self.ivf_clusters or max(1, int(round((total / n_shards) ** 0.5)))
            k = max(1, min(k, smallest))
            if self.search_impl == "ivf":
                self._ivf = ShardedIVFIndex(self.mesh, self.mesh_axis).build(
                    rows, n_clusters=k, capacity_factor=1.3, iters=6,
                    dtype="bfloat16" if self.device_dtype == "bfloat16" else "float32")
            else:
                sub = next(s for s in (64, 32, 16, 8, 4, 2, 1) if self.embed_dim % s == 0)
                self._ivf = ShardedIVFPQIndex(self.mesh, self.mesh_axis).build(
                    rows, n_clusters=k, n_subspaces=sub, n_centroids=min(256, smallest),
                    capacity_factor=1.3, coarse_iters=6, pq_iters=6,
                    keep_originals=not self.ivfpq_host_store)
                if self.ivfpq_host_store:
                    self._ivf.attach_host_store(*quantize_host_store(rows))
            return
        k = min(self.ivf_clusters or max(1, int(round(total**0.5))), total)
        if self.search_impl == "ivf" and self.device_dtype == "int8":
            self._ivf = IVFIndex().build_device(
                torch.from_numpy(rows).to(self.device), n_clusters=k, capacity_factor=1.3,
                iters=6, dtype="int8",
            )
        elif self.search_impl == "ivf":
            self._ivf = IVFIndex().build(
                rows, n_clusters=k, capacity_factor=1.3, iters=6,
                dtype="bfloat16" if self.device_dtype == "bfloat16" else "float32",
                device=self.device,
            )
        else:
            sub = next(s for s in (64, 32, 16, 8, 4, 2, 1) if self.embed_dim % s == 0)
            self._ivf = IVFPQIndex().build(
                rows, n_clusters=k, n_subspaces=sub, n_centroids=min(256, total),
                capacity_factor=1.3, coarse_iters=6, pq_iters=6,
                keep_originals=not self.ivfpq_host_store, device=self.device,
            )
            if self.ivfpq_host_store:
                self._ivf.attach_host_store(*quantize_host_store(rows))

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
        if self._ivf is not None and video_name is None:
            # the ANN tiers answer global searches; results are padded to k
            # with (-inf, -1) where fewer candidates are reachable
            q_np = np.atleast_2d(np.asarray(queries, np.float32))
            if self.search_impl == "ivfpq":
                # codes are lossy: always re-rank 4x the ask exactly
                scores, rows = self._ivf.search(q_np, k, nprobe=self.ivf_nprobe,
                                                rerank=max(50, 4 * k))
            else:
                scores, rows = self._ivf.search(q_np, k, nprobe=self.ivf_nprobe)
            if scores.shape[1] < k:
                pad = ((0, 0), (0, k - scores.shape[1]))
                scores = np.pad(scores, pad, constant_values=-np.inf)
                rows = np.pad(rows, pad, constant_values=-1)
            return scores, rows
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        with torch.inference_mode():
            if self.mesh is not None:
                impl = "pallas" if self.search_impl == "pallas" else "xla"  # the ANN tiers' scoped searches
                scores, rows = self._device_index.topk(q, start, end, k, impl=impl)
            else:
                topk = fused_topk if self.search_impl == "pallas" else cosine_topk
                scores, rows = topk(self._device_index, q, start, end, k, row_scales=self._row_scales)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def snapshot(self, video_name: str | None = None):
        """A consistent view for the searchers (``index.fused_search``):
        (device_index, row_scales, start, end, version), taken under the lock.
        A rebuild replaces the tensors and an append writes rows past ``end``
        only, so the view stays valid while a search runs over it."""
        with self._lock:
            self._ensure_built()
            start, end = self._range_for(video_name)
            return self._device_index, self._row_scales, start, end, self.version

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
