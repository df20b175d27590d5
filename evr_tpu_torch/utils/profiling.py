"""Wall-time registry behind ``/api/stats`` (the ``Timer`` registry of the
JAX package's ``utils/profiling.py``; its context manager and device-trace
spans have no caller in the port)."""

from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np

_registry: dict[str, list[float]] = defaultdict(list)
_lock = threading.Lock()


class Timer:
    @staticmethod
    def record(name: str, seconds: float) -> None:
        with _lock:
            _registry[name].append(seconds)

    @staticmethod
    def report() -> dict[str, dict[str, float]]:
        """Per name: count, total seconds, mean, p50 and p95 in ms."""
        with _lock:
            out = {}
            for name, samples in _registry.items():
                arr = np.asarray(samples)
                out[name] = {
                    "count": len(arr),
                    "total_s": float(arr.sum()),
                    "mean_ms": float(arr.mean() * 1e3),
                    "p50_ms": float(np.percentile(arr, 50) * 1e3),
                    "p95_ms": float(np.percentile(arr, 95) * 1e3),
                }
            return out
