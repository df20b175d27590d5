"""Training-pipeline diagnostics (E3 parity).

Counterpart of ``evr_tpu/evaluation/diagnostics.py`` over the port's params
(nested dicts and lists of tensors or numpy arrays). The reference ships
pre-flight checks as a runnable script
(`Backend/content/Test_compare_model/clip_pipeline_diagnostics.py`):
parameter-freeze audit (`:112-140`), optimizer-group audit (`:141-160`),
logit-scale sanity (`:196-221`), embedding-normalisation check (`:222-271`),
dtype consistency (`:340-364`), batch-size compatibility sweep (`:365-416`).
Each is a pure function returning a structured report.

Dtypes are reported by their numpy names ("float32", "bfloat16"), as the
JAX package reports them, so the same weights give the same report.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from evr_tpu_torch.training.partition import count_labels, iter_paths, param_group_labels


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaves(tree) -> list:
    return [leaf for _, leaf in iter_paths(tree)]


def check_frozen_parameters(params: dict, freeze_layers: int) -> dict:
    """Audit which tensors the freeze mask covers and the trainable ratio.

    Accepts either the training-layout tree ({'clip': ..., 'classifier':
    ...}) or a bare CLIP params tree."""
    if "clip" not in params:
        params = {"clip": params}
    labels = param_group_labels(params, freeze_layers)
    counts = count_labels(labels)
    total_params = sum(int(np.prod(tuple(leaf.shape))) for leaf in _leaves(params))
    return {
        "tensor_counts_by_group": counts,
        "total_tensors": sum(counts.values()),
        "total_parameters": total_params,
        "frozen_tensors": counts.get("frozen", 0),
        "ok": counts.get("frozen", 0) == (2 * freeze_layers if freeze_layers else 0),
    }


def check_logit_scale(params: dict) -> dict:
    """logit_scale sanity (`:196-221`): init log(1/0.07)≈2.659, exp in a
    sane temperature band."""
    leaf = params["logit_scale"]
    scale = float(leaf.item() if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
    exp_scale = math.exp(scale)
    return {
        "logit_scale": scale,
        "exp_logit_scale": exp_scale,
        "temperature": 1.0 / exp_scale,
        "ok": 1.0 <= exp_scale <= 200.0,
    }


def check_embedding_norms(features: np.ndarray, atol: float = 1e-3) -> dict:
    norms = np.linalg.norm(np.asarray(features), axis=-1)
    return {
        "mean_norm": float(norms.mean()),
        "min_norm": float(norms.min()),
        "max_norm": float(norms.max()),
        "ok": bool(np.allclose(norms, 1.0, atol=atol)),
    }


def check_dtype_consistency(params: dict) -> dict:
    dtypes = {_dtype_name(leaf) for leaf in _leaves(params)}
    return {"dtypes": sorted(dtypes), "ok": dtypes <= {"float32"}}


def check_loss_statistics(loss_samples: list[float]) -> dict:
    """Loss sanity on random batches (`:272-339` equivalent): finite, and
    near ln(batch) for untrained contrastive models is expected."""
    arr = np.asarray(loss_samples, np.float64)
    return {
        "mean": float(arr.mean()),
        "std": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "ok": bool(np.isfinite(arr).all()),
    }


def batch_size_sweep(
    encode_fn, make_batch, sizes=(1, 8, 16, 32)
) -> dict:
    """Run ``encode_fn(make_batch(n))`` across batch sizes (`:365-416`). An
    error is reported in the result, with its type and message."""
    report = {}
    for n in sizes:
        try:
            out = np.asarray(encode_fn(make_batch(n)))
            report[str(n)] = {
                "ok": True,
                "output_shape": list(out.shape),
                "finite": bool(np.isfinite(out).all()),
            }
        except Exception as e:  # surfaced, not swallowed
            report[str(n)] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    report["ok"] = all(v.get("ok") for v in report.values() if isinstance(v, dict))
    return report


def run_all(params: dict, freeze_layers: int = 8, features: np.ndarray | None = None) -> dict:
    report = {
        "freeze_audit": check_frozen_parameters(params, freeze_layers),
        "logit_scale": check_logit_scale(params),
        "dtype": check_dtype_consistency(params),
    }
    if features is not None:
        report["embedding_norms"] = check_embedding_norms(features)
    report["ok"] = all(v.get("ok", True) for v in report.values() if isinstance(v, dict))
    return report
