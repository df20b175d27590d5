"""The port's micro-batcher (``serving/batcher.py``) and the batched searchers,
on the CPU.

The ``MicroBatcher`` cases of the JAX package's ``tests/test_batcher.py`` run
against the port's copy; concurrent single queries through the batched
searchers must coalesce into fewer dispatches of power-of-two sizes and
return the unbatched results (rows equal, scores within 1e-5); batched
results are cached under the flush-time index version; the ANN tier
micro-batches its global probes; ``--batch-window-ms`` reaches every
``QueryEngine`` through ``ServingContext``.
"""

import threading
import time

import numpy as np
import pytest

from evr_tpu_torch.index import EmbeddingEngine, FrameIndex
from evr_tpu_torch.index.fused_image_search import ImageSearcher
from evr_tpu_torch.index.fused_search import TextSearcher
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.serving.batcher import MicroBatcher, bucket_size

JOIN_S = 30


def run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=args) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def test_microbatcher_coalesces_concurrent_submits():
    calls = []

    def batch_fn(key, items):
        calls.append(list(items))
        return [x * 10 for x in items]

    mb = MicroBatcher(batch_fn, max_batch=8, window_s=0.05)
    results = {}
    run_threads(lambda i: results.__setitem__(i, mb.submit("k", i)), [(i,) for i in range(6)])
    assert results == {i: i * 10 for i in range(6)}
    assert len(calls) <= 2, calls  # one window: typically 1 flush, 2 under scheduling jitter
    assert sorted(sum(calls, [])) == list(range(6))


def test_microbatcher_flushes_early_when_full():
    mb = MicroBatcher(lambda key, items: items, max_batch=2, window_s=5.0)
    t0 = time.perf_counter()
    results = {}
    run_threads(lambda i: results.__setitem__(i, mb.submit("k", i)), [(0,), (1,)])
    assert time.perf_counter() - t0 < 2.0  # a full group does not wait out the 5 s window
    assert results == {0: 0, 1: 1}


def test_microbatcher_separate_keys_do_not_mix():
    mb = MicroBatcher(lambda key, items: [(key, x) for x in items], max_batch=4, window_s=0.01)
    out = {}
    run_threads(lambda i: out.__setitem__(i, mb.submit(i % 2, i)), [(i,) for i in range(4)])
    assert out == {i: (i % 2, i) for i in range(4)}


@pytest.mark.parametrize("error", [ValueError("boom"), SystemExit("async-style abort")])
def test_microbatcher_errors_reach_every_waiter(error):
    """An exception, or a leader that dies without results (a BaseException),
    wakes every follower with an error; the key is then free again."""
    def batch_fn(key, items):
        raise error

    mb = MicroBatcher(batch_fn, max_batch=4, window_s=0.01)
    errs = []

    def worker(i):
        try:
            mb.submit("k", i)
        except BaseException as e:  # noqa: BLE001 - the test collects what each waiter got
            errs.append(type(e).__name__)

    run_threads(worker, [(i,) for i in range(3)])
    assert errs == [type(error).__name__] * 3
    mb.batch_fn = lambda key, items: items
    assert mb.submit("k", 42) == 42


def test_bucket_size_never_exceeds_cap():
    assert [bucket_size(n, 16) for n in (1, 3, 5, 9, 16)] == [1, 4, 8, 16, 16]
    assert bucket_size(5, 6) == 6  # the next power of two would exceed the cap
    assert bucket_size(12, 12) == 12 and bucket_size(8, 8) == 8
    for n in range(1, 13):
        assert n <= bucket_size(n, 12) <= 12


def test_microbatcher_sequential_submits_still_work():
    mb = MicroBatcher(lambda key, items: [x + 1 for x in items], max_batch=4, window_s=0.001)
    assert [mb.submit("k", i) for i in range(5)] == [1, 2, 3, 4, 5]


@pytest.fixture(scope="module")
def small_engine_index():
    cfg = tclip.CLIPConfig(
        embed_dim=32,
        vision=tclip.VisionConfig(image_size=32, patch_size=8, width=32, layers=1, heads=2),
        text=tclip.TextConfig(context_length=16, vocab_size=49408, width=32, layers=1, heads=2),
    )
    engine = EmbeddingEngine(cfg=cfg, batch_size=4, device="cpu")
    emb = np.random.default_rng(0).normal(size=(40, 32)).astype(np.float32)
    index = FrameIndex(embed_dim=32, pad_multiple=64, device="cpu")
    index.add_video("v", emb)
    return engine, index


@pytest.mark.parametrize("kind", ["text", "image"])
def test_batched_searcher_matches_unbatched(small_engine_index, kind):
    engine, index = small_engine_index
    rng = np.random.default_rng(3)
    if kind == "text":
        cls, items = TextSearcher, [f"query number {i}" for i in range(6)]
    else:
        cls, items = ImageSearcher, [rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8) for _ in range(6)]
    plain = cls(engine, index)
    batched = cls(engine, index, batch_window_ms=50.0, max_batch=8)
    expected = [plain.search(q, 5) for q in items]
    dispatches = []
    if kind == "text":
        orig = batched._dispatch
        batched._dispatch = lambda qs, *a, **kw: (dispatches.append(len(qs)), orig(qs, *a, **kw))[1]
    else:
        orig = batched._run_fused
        batched._run_fused = lambda x, *a, **kw: (dispatches.append(len(x)), orig(x, *a, **kw))[1]
    got = [None] * len(items)
    run_threads(lambda i: got.__setitem__(i, batched.search(items[i], 5)), [(i,) for i in range(len(items))])
    for (es, er), (gs, gr) in zip(expected, got):
        np.testing.assert_array_equal(gr, er)
        np.testing.assert_allclose(gs, es, rtol=0, atol=1e-5)
    assert len(dispatches) < len(items), dispatches  # coalesced
    assert all(d in (1, 2, 4, 8) for d in dispatches), dispatches  # padded to buckets


def test_batched_result_cached_under_flush_version(small_engine_index):
    """The index advances inside the window: the result reflects, and is
    cached under, the flush-time version; a hot repeat then dispatches
    nothing."""
    engine, index = small_engine_index
    batched = TextSearcher(engine, index, batch_window_ms=5.0, max_batch=4)
    submit_version = index.snapshot()[4]
    extra = np.random.default_rng(9).normal(size=(3, 32)).astype(np.float32)
    flush = batched._batcher.batch_fn

    def append_then_flush(key, items):  # a video lands inside the window
        index.add_video(f"late{submit_version}", extra)
        return flush(key, items)

    batched._batcher.batch_fn = append_then_flush
    s1, r1 = batched.search("stale window query", 3)
    flush_version = index.snapshot()[4]
    assert flush_version > submit_version
    key = (engine.active_model, flush_version, ("stale window query",), 3, None)
    assert key in batched._result_cache
    assert all(k[1] != submit_version for k in batched._result_cache)
    dispatches = []
    orig = batched._dispatch
    batched._dispatch = lambda *a, **kw: (dispatches.append(1), orig(*a, **kw))[1]
    s1b, r1b = batched.search("stale window query", 3)
    assert dispatches == [] and s1b is batched._result_cache[key][0]
    s2, r2 = TextSearcher(engine, index).search("stale window query", 3)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-5)


def test_query_engine_ann_tier_micro_batches(monkeypatch):
    """Under ivf, concurrent global queries share one probe dispatch (the
    searcher is off there), with the unbatched results; scoped searches
    bypass the batcher."""
    from evr_tpu_torch.query import MetadataStore, QueryEngine
    from tests.test_query import FakeEngine

    rng = np.random.default_rng(7)
    emb = rng.normal(size=(400, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    def build(window):
        idx = FrameIndex(embed_dim=16, pad_multiple=32, search_impl="ivf", ivf_clusters=8,
                         ivf_nprobe=8, device="cpu")
        idx.add_video("v", emb, [f"{i}.jpg" for i in range(len(emb))])
        eng = FakeEngine(dim=16)
        for i in range(8):
            eng.register(f"q{i}", i)
        return QueryEngine(eng, idx, MetadataStore(), batch_window_ms=window)

    plain, batched = build(None), build(50.0)
    assert plain._ann_batcher is None
    assert batched._ann_batcher is not None and batched._searcher is None
    queries = [f"q{i}" for i in range(6)]
    expected = {q: [(h.row, round(h.score, 5)) for h in plain._candidates_n(q, 5, None)] for q in queries}
    calls = []
    orig = batched.index.search_raw

    def counting(qmat, k, video_name=None):
        calls.append(np.atleast_2d(np.asarray(qmat)).shape[0])
        return orig(qmat, k, video_name)

    monkeypatch.setattr(batched.index, "search_raw", counting)
    got = {}
    run_threads(lambda q: got.__setitem__(q, [(h.row, round(h.score, 5))
                                              for h in batched._candidates_n(q, 5, None)]),
                [(q,) for q in queries])
    assert got == expected
    assert len(calls) < 6 and all(c in (1, 2, 4, 8) for c in calls), calls
    calls.clear()
    assert batched._candidates_n("q1", 5, "v") and calls == []


def test_batch_window_reaches_every_query_engine(tmp_path, monkeypatch):
    """``--batch-window-ms`` → ``ServingContext`` → each model's
    ``QueryEngine`` → its searcher's batcher; the image searcher too."""
    import werkzeug.serving

    from evr_tpu_torch.serving import __main__ as cli

    served = {}
    monkeypatch.setattr(werkzeug.serving, "run_simple",
                        lambda host, port, app, **kw: served.update(app=app))
    cli.main(["--data-root", str(tmp_path), "--device", "cpu", "--model", "ViT-Tiny-Test",
              "--batch-window-ms", "4"])
    ctx = served["app"].ctx
    assert ctx.batch_window_ms == 4.0
    qe = ctx.query_engine
    assert qe._searcher._batcher.window_s == pytest.approx(0.004)
    assert qe._searcher._batcher.max_batch == 16
    assert ctx.image_searcher._batcher.window_s == pytest.approx(0.004)
    assert ctx.image_searcher is ctx.image_searcher  # one per model
