"""Zero-shot prompt-ensemble classification — the CLIP paper's headline
capability ("Learning Transferable Visual Models From Natural Language
Supervision" §3.1.4, the method the reference repo is named after).

Counterpart of ``evr_tpu/evaluation/zeroshot.py``. The reference evaluates
classification only through trained heads or probes
(`Backend/content/Test_compare_model/compare_model_classification.py`);
zero-shot transfer, classifying with nothing but class names, makes a CLIP
retrieval stack extensible to new event categories without retraining.

Method (per the paper): each class name is expanded through a set of prompt
templates; every prompt is text-encoded (all C x T prompts in one encode on
the engine's device) and L2-normalised; the per-class embeddings are
averaged over templates and re-normalised ("prompt ensembling"); the
classification is one [N, D] @ [D, C] product over image features, on the
host (numpy; ``argmax`` takes the first of tied classes, as JAX's does).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .classification import _prf

# The paper's core ensemble idea with a compact general-purpose template
# set (the full 80-template ImageNet list is ImageNet-specific; these are
# the domain-neutral ones plus the video-frame phrasing this workload sees).
DEFAULT_TEMPLATES: tuple[str, ...] = (
    "a photo of a {}.",
    "a photo of the {}.",
    "a blurry photo of a {}.",
    "a dark photo of a {}.",
    "a cropped photo of a {}.",
    "a close-up photo of a {}.",
    "a video frame of {}.",
    "a scene of {}.",
)


def build_zeroshot_classifier(
    encode_texts_fn: Callable[[Sequence[str]], np.ndarray],
    classnames: Sequence[str],
    templates: Sequence[str] = DEFAULT_TEMPLATES,
) -> np.ndarray:
    """Prompt-ensembled class embeddings: returns W [D, C], unit columns.

    ``encode_texts_fn(prompts) -> [B, D]`` (unnormalised is fine — e.g.
    ``EmbeddingEngine.encode_texts``). All C×T prompts are encoded in ONE
    batch — one device dispatch for the whole classifier."""
    prompts = [t.format(name) for name in classnames for t in templates]
    feats = np.asarray(encode_texts_fn(prompts), np.float32)
    feats = feats / (np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-12)
    per_class = feats.reshape(len(classnames), len(templates), -1).mean(axis=1)
    per_class = per_class / (
        np.linalg.norm(per_class, axis=-1, keepdims=True) + 1e-12
    )
    return per_class.T  # [D, C]


def zeroshot_predict(
    image_features: np.ndarray, classifier: np.ndarray
) -> np.ndarray:
    """[N, D] features (any norm) x [D, C] -> predicted class per row."""
    f = np.asarray(image_features, np.float32)
    f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)
    return np.argmax(f @ np.asarray(classifier, np.float32), axis=-1)


def evaluate_zeroshot(
    image_features: np.ndarray,
    labels: np.ndarray,
    classifier: np.ndarray,
    topk: Sequence[int] = (1, 5),
) -> dict:
    """Accuracy@k + macro P/R/F1 (same metric surface as the trained-head
    benchmark, `evaluation.classification`)."""
    f = np.asarray(image_features, np.float32)
    f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)
    logits = f @ np.asarray(classifier, np.float32)
    labels = np.asarray(labels)
    n_classes = classifier.shape[1]
    order = np.argsort(-logits, axis=-1)
    metrics = _prf(labels, order[:, 0], n_classes)
    for k in topk:
        k_eff = min(k, n_classes)
        hit = (order[:, :k_eff] == labels[:, None]).any(axis=1)
        metrics[f"top{k}_accuracy"] = float(hit.mean())
    return metrics
