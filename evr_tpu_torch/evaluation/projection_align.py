"""Cross-model feature-space alignment for the comparison harness.

A copy of ``evr_tpu/evaluation/projection_align.py`` (numpy; the port
imports nothing of the JAX package). Reference: `compare_models.py:423-472`
fits a least-squares projection taking a non-CLIP vision encoder's features
(ViT-B/16, 768-d) into CLIP's 512-d joint space using paired image features,
plus a statistical renormalisation step (`:669-707`) matching the target
space's moments, so models without a text tower can still be scored on t2i
retrieval against CLIP text features.
"""

from __future__ import annotations

import numpy as np


def fit_projection(
    source: np.ndarray,  # [N, Ds] features from the foreign encoder
    target: np.ndarray,  # [N, Dt] CLIP features for the same images
    l2: float = 1e-2,
) -> np.ndarray:
    """Ridge least-squares W: source @ W ≈ target. Returns [Ds+1, Dt]
    (bias row last)."""
    X = np.concatenate([source, np.ones((len(source), 1), source.dtype)], axis=1)
    A = X.T @ X + l2 * np.eye(X.shape[1], dtype=X.dtype)
    return np.linalg.solve(A, X.T @ target)


def apply_projection(features: np.ndarray, W: np.ndarray) -> np.ndarray:
    X = np.concatenate([features, np.ones((len(features), 1), features.dtype)], axis=1)
    return X @ W


def statistical_renormalize(
    features: np.ndarray, target_mean: np.ndarray, target_std: np.ndarray
) -> np.ndarray:
    """Match per-dimension moments of the target space
    (`compare_models.py:669-707`)."""
    mu = features.mean(axis=0, keepdims=True)
    sd = features.std(axis=0, keepdims=True)
    out = (features - mu) / np.maximum(sd, 1e-8)
    return out * target_std + target_mean


class ProjectedAdapter:
    """Wrap any image-encoder adapter into CLIP space for the comparison
    harness: encodes with the foreign model, projects, renormalises, and
    reuses a CLIP adapter's text tower."""

    def __init__(self, image_adapter, clip_adapter, W, target_mean=None, target_std=None):
        self.image_adapter = image_adapter
        self.clip_adapter = clip_adapter
        self.W = W
        self.target_mean = target_mean
        self.target_std = target_std

    def encode_image_files(self, paths):
        feats = apply_projection(self.image_adapter.encode_image_files(paths), self.W)
        if self.target_mean is not None:
            feats = statistical_renormalize(feats, self.target_mean, self.target_std)
        norms = np.linalg.norm(feats, axis=1, keepdims=True)
        return feats / np.maximum(norms, 1e-12)

    def encode_texts(self, texts):
        return self.clip_adapter.encode_texts(texts)
