from .device import resolve_device
from .logging import get_logger
from .profiling import Timer

__all__ = ["Timer", "get_logger", "resolve_device"]
