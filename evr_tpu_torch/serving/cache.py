"""TTL cache for the serving tier (the JAX package's ``serving/cache.py``,
without the per-key invalidation that only the upload path, not ported yet,
needs).

One generic lock-guarded TTL cache: the serving path keeps search results in
it, keyed by the request semantics and the index version, and the UMAP
route's payloads (24 h); text features are cached by the EmbeddingEngine.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Hashable


class TTLCache:
    def __init__(self, default_ttl: float = 3600.0, max_entries: int = 4096):
        self.default_ttl = default_ttl
        self.max_entries = max_entries
        self._data: dict[Hashable, tuple[float, Any]] = {}
        self._lock = threading.Lock()

    def get(self, key: Hashable, default: Any = None) -> Any:
        now = time.monotonic()
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return default
            expires, value = entry
            if now >= expires:
                del self._data[key]
                return default
            return value

    def set(self, key: Hashable, value: Any, ttl: float | None = None) -> None:
        ttl = self.default_ttl if ttl is None else ttl
        with self._lock:
            if len(self._data) >= self.max_entries:
                # drop expired first, then oldest-expiring
                now = time.monotonic()
                self._data = {k: v for k, v in self._data.items() if v[0] > now}
                while len(self._data) >= self.max_entries:
                    oldest = min(self._data, key=lambda k: self._data[k][0])
                    del self._data[oldest]
            self._data[key] = (time.monotonic() + ttl, value)

    def __len__(self) -> int:
        return len(self._data)

    def invalidate(self) -> int:
        """Remove every entry. Returns the number removed."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            return n
