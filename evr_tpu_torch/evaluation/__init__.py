"""The retrieval and classification benchmark harness (counterpart of
``evr_tpu/evaluation``): R@K / MRR / rank / P@K / rsum over captions,
classification over labelled folders (trained head, linear probe or
zero-shot), the multi-model comparison with its JSON / CSV / XLSX reports,
HF adapters, cross-model projection and the training diagnostics."""

from .retrieval import (
    metrics_from_ranks,
    calculate_metrics,
    evaluate_retrieval,
)
from .datasets import CaptionsTable, load_captions_csv, load_excel_testset
from .compare import ModelComparison, EngineAdapter
from .classification import evaluate_classification
from . import diagnostics

__all__ = [
    "metrics_from_ranks",
    "calculate_metrics",
    "evaluate_retrieval",
    "CaptionsTable",
    "load_captions_csv",
    "load_excel_testset",
    "ModelComparison",
    "EngineAdapter",
    "evaluate_classification",
    "diagnostics",
]
