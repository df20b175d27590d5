from .app import create_app
from .cache import TTLCache
from .context import ServingContext

__all__ = ["create_app", "ServingContext", "TTLCache"]
