"""Classification benchmark (E2 parity).

Counterpart of ``evr_tpu/evaluation/classification.py`` (numpy on the host,
as there). Reference: `Backend/content/Test_compare_model/
compare_model_classification.py` — per-model 3-class accuracy / precision /
recall / F1 over labelled image folders, with linear probes for models that
lack a native head (`LinearClassifier`, `:104-111`).

Features come from any adapter; the head is either the engine's trained
classifier (``EmbeddingEngine.classify``, on the engine's device) or a
ridge-regression linear probe fitted on the spot (closed form, on the host).
"""

from __future__ import annotations

import numpy as np


def _prf(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int) -> dict:
    metrics = {"accuracy": float((y_true == y_pred).mean())}
    precisions, recalls, f1s = [], [], []
    for c in range(n_classes):
        tp = int(((y_pred == c) & (y_true == c)).sum())
        fp = int(((y_pred == c) & (y_true != c)).sum())
        fn = int(((y_pred != c) & (y_true == c)).sum())
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        precisions.append(p)
        recalls.append(r)
        f1s.append(f1)
    metrics["precision_macro"] = float(np.mean(precisions))
    metrics["recall_macro"] = float(np.mean(recalls))
    metrics["f1_macro"] = float(np.mean(f1s))
    metrics["per_class"] = {
        str(c): {"precision": precisions[c], "recall": recalls[c], "f1": f1s[c]}
        for c in range(n_classes)
    }
    return metrics


def fit_linear_probe(
    features: np.ndarray, labels: np.ndarray, n_classes: int, l2: float = 1e-3
) -> np.ndarray:
    """Closed-form ridge one-vs-all probe: returns W [D+1, C]."""
    X = np.concatenate([features, np.ones((len(features), 1))], axis=1)
    Y = np.eye(n_classes)[labels]
    A = X.T @ X + l2 * np.eye(X.shape[1])
    return np.linalg.solve(A, X.T @ Y)


def probe_predict(W: np.ndarray, features: np.ndarray) -> np.ndarray:
    X = np.concatenate([features, np.ones((len(features), 1))], axis=1)
    return (X @ W).argmax(axis=1)


def evaluate_classification(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int = 3,
    classifier_fn=None,
    train_mask: np.ndarray | None = None,
) -> dict:
    """Evaluate classification over embedded images.

    - ``classifier_fn(features) -> probs`` (e.g. ``EmbeddingEngine.classify``)
      uses a trained head;
    - otherwise a linear probe is fitted on ``train_mask`` rows (default:
      80/20 split by index parity with seed 42) and evaluated on the rest.
    """
    labels = np.asarray(labels)
    if classifier_fn is not None:
        probs = classifier_fn(features)
        preds = np.asarray(probs).argmax(axis=1)
        return _prf(labels, preds, n_classes) | {"mode": "trained_head"}

    if train_mask is None:
        rng = np.random.default_rng(42)
        train_mask = rng.random(len(labels)) < 0.8
    W = fit_linear_probe(features[train_mask], labels[train_mask], n_classes)
    preds = probe_predict(W, features[~train_mask])
    return _prf(labels[~train_mask], preds, n_classes) | {
        "mode": "linear_probe",
        "n_train": int(train_mask.sum()),
        "n_eval": int((~train_mask).sum()),
    }
