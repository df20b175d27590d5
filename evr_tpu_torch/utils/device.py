"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device that is not there raises: an
    entry point never carries on quietly on the CPU; the CPU is used only
    when the caller asks for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


_FP32_LOCK = threading.Lock()
_fp32_callers = 0
_fp32_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_fp32():
    """fp32 products and convolutions on the card (TF32 off for matmuls and
    for cuDNN) while any caller is inside. The flags are process-wide: the
    first caller to enter saves them and the last to leave restores them, so
    calls that overlap in threads keep fp32 until the last one is done."""
    global _fp32_callers, _fp32_saved
    with _FP32_LOCK:
        if _fp32_callers == 0:
            _fp32_saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        _fp32_callers += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_callers -= 1
            if _fp32_callers == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _fp32_saved
