"""Relocatable data-root configuration (a copy of the JAX package's
``DataRootConfig``)."""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field


@dataclass
class DataRootConfig:
    """Single relocatable root for all durable serving state: metadata JSONs,
    embedding .npy files, uploaded videos, extracted frames. The layout is
    ``evr_tpu``'s, so either package serves the other's data root."""

    root: pathlib.Path = field(default_factory=lambda: pathlib.Path("data"))

    def __post_init__(self):
        self.root = pathlib.Path(self.root)

    @property
    def metadata_dir(self) -> pathlib.Path:
        return self.root / "metadata"

    @property
    def embedding_dir(self) -> pathlib.Path:
        return self.root / "embedding"

    @property
    def video_dir(self) -> pathlib.Path:
        return self.root / "videos"

    @property
    def frames_dir(self) -> pathlib.Path:
        return self.root / "frames"

    @property
    def models_dir(self) -> pathlib.Path:
        return self.root / "models"

    @property
    def mapping_path(self) -> pathlib.Path:
        return self.metadata_dir / "video_mapping.json"

    def ensure(self) -> "DataRootConfig":
        for d in (self.metadata_dir, self.embedding_dir, self.video_dir,
                  self.frames_dir, self.models_dir):
            d.mkdir(parents=True, exist_ok=True)
        return self
