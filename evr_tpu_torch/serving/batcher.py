"""Dynamic micro-batching for the serving hot path.

Counterpart of ``evr_tpu/serving/batcher.py`` (pure Python, kept as its own
copy): one dispatch scoring 16 queries costs barely more than one dispatch
scoring a single query, since each dispatch pays a fixed host↔device round
trip and the search GEMM is bound by reading the index. The reference serves
every request as its own torch call under Flask's threaded server, so
concurrency multiplies dispatches; here concurrent requests coalesce into
one.

``MicroBatcher`` is a leader/follower coalescer: the first thread to submit
for a group key becomes the leader, waits up to ``window_s`` (or until the
group reaches ``max_batch``), then runs the whole group in one call on its
own thread and hands each follower its result. No dedicated thread and no
queue to drain on shutdown; a lone request pays only the window.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Hashable, Sequence


class _Group:
    __slots__ = ("items", "event", "done", "results", "error", "closed")

    def __init__(self):
        self.items: list[Any] = []
        self.event = threading.Event()  # leader: flush early when full
        self.done = threading.Event()  # followers: results ready
        self.results: Sequence[Any] | None = None
        self.error: BaseException | None = None
        self.closed = False  # no further joins once the leader starts flushing


class MicroBatcher:
    """Coalesce concurrent ``submit(key, item)`` calls into one
    ``batch_fn(key, items) -> results`` call per group key."""

    def __init__(
        self,
        batch_fn: Callable[[Hashable, list[Any]], Sequence[Any]],
        max_batch: int = 16,
        window_s: float = 0.004,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_fn = batch_fn
        self.max_batch = max_batch
        self.window_s = window_s
        self._lock = threading.Lock()
        self._groups: dict[Hashable, _Group] = {}

    def submit(self, key: Hashable, item: Any) -> Any:
        with self._lock:
            group = self._groups.get(key)
            if group is None or group.closed:
                group = _Group()
                self._groups[key] = group
                leader = True
            else:
                leader = False
            group.items.append(item)
            pos = len(group.items) - 1
            if len(group.items) >= self.max_batch:
                group.closed = True
                group.event.set()

        if leader:
            try:
                if self.max_batch > 1:
                    group.event.wait(self.window_s)
                with self._lock:
                    group.closed = True
                results = self.batch_fn(key, group.items)
                if len(results) != len(group.items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(group.items)} items"
                    )
                group.results = results
            except BaseException as e:  # propagate to every waiter
                group.error = e
            finally:
                # Runs even if an async exception (KeyboardInterrupt, thread
                # timeout) lands mid-wait: unregister the group and wake every
                # follower so no submitter can wedge on a leaderless group.
                with self._lock:
                    group.closed = True
                    if self._groups.get(key) is group:
                        del self._groups[key]
                if group.results is None and group.error is None:
                    group.error = RuntimeError("batch leader aborted")
                group.done.set()
        else:
            group.done.wait()

        if group.error is not None:
            raise group.error
        return group.results[pos]


def bucket_size(n: int, cap: int) -> int:
    """Smallest power-of-two ≥ n, or ``cap`` itself when that power would
    exceed it — so padded group sizes come from the bounded set
    {1, 2, 4, ..., cap} and never exceed the configured max batch."""
    b = 1
    while b < n and b * 2 <= cap:
        b *= 2
    return b if b >= n else cap


def flush_padded(items: list, max_batch: int, run: Callable[[list], tuple]) -> list:
    """Shared MicroBatcher flush scheme for the fused searchers: pad the
    group to a bucket size, run ONE dispatch, slice per-item results.
    ``run(padded_items) -> (scores [B, k], rows [B, k])``."""
    b = bucket_size(len(items), max_batch)
    padded = list(items) + [items[0]] * (b - len(items))
    scores, rows = run(padded)
    return [(scores[i], rows[i]) for i in range(len(items))]
