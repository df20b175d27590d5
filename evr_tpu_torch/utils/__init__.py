from .device import resolve_device
from .logging import get_logger

__all__ = ["get_logger", "resolve_device"]
