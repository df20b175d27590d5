"""The port's one-call searchers (``index/fused_search.py``,
``index/fused_image_search.py``) and ``FrameIndex.snapshot`` against the JAX
package's, on the CPU.

Same params carried across, same index rows and queries, fp32 on both sides:
rows must be equal and scores within 1e-5. ``QueryEngine`` builds the text
searcher under the JAX package's conditions (every tier but the ANN ones).
"""

import numpy as np
import pytest
import torch

import jax

from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.index import FrameIndex as JIndex
from evr_tpu.index.fused_image_search import ImageSearcher as JImageSearcher
from evr_tpu.index.fused_search import TextSearcher as JTextSearcher
from evr_tpu.models import clip as jclip
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.index import FrameIndex as TIndex
from evr_tpu_torch.index.fused_image_search import ImageSearcher as TImageSearcher
from evr_tpu_torch.index.fused_search import TextSearcher as TTextSearcher
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.query import MetadataStore, QueryEngine

SCORE_TOL = 1e-5
QUERIES = ["a person fighting", "an empty street", "a red car at night"]


def small_cfg(module):
    return module.CLIPConfig(
        embed_dim=32,
        vision=module.VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4),
        text=module.TextConfig(width=64, layers=2, heads=4),
    )


@pytest.fixture(scope="module")
def engines():
    params = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(2), small_cfg(jclip)))
    j = JEngine(cfg=small_cfg(jclip), params=params, batch_size=4)
    t = TEngine(cfg=small_cfg(tclip), params=params, batch_size=4, device="cpu")
    return j, t


def corpus(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(40, 32)).astype(np.float32),
            "b": rng.normal(size=(25, 32)).astype(np.float32)}


def indexes(dtype: str = "float32", **kw):
    j = JIndex(embed_dim=32, pad_multiple=64, device_dtype=dtype, **kw)
    t = TIndex(embed_dim=32, pad_multiple=64, device_dtype=dtype, device="cpu", **kw)
    for name, emb in corpus().items():
        j.add_video(name, emb)
        t.add_video(name, emb)
    return j, t


def assert_same_results(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_text_searcher_matches_jax_and_the_two_step_path(engines, dtype):
    je, te = engines
    ji, ti = indexes(dtype)
    got = TTextSearcher(te, ti).search(QUERIES, 7)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64 and got[0].shape == (3, 7)
    assert_same_results(got, JTextSearcher(je, ji).search(QUERIES, 7))
    # the searcher's full final text block against the engine's pooled-row one
    two_step = ti.search_raw(te.encode_texts(QUERIES), 7)
    assert_same_results(got, two_step)


def test_image_searcher_matches_jax(engines):
    je, te = engines
    ji, ti = indexes()
    staged = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got = TImageSearcher(te, ti).search(staged, 5)
    assert_same_results(got, JImageSearcher(je, ji).search(staged, 5))
    assert_same_results(TImageSearcher(te, ti).search(staged, 5, video_name="b"),
                        JImageSearcher(je, ji).search(staged, 5, video_name="b"))


def test_video_scope_and_cache(engines):
    _, te = engines
    _, ti = indexes()
    searcher = TTextSearcher(te, ti)
    scores, rows = searcher.search("query", 5, video_name="b")
    start, end = ti._range_for("b")
    assert ((rows >= start) & (rows < end)).all()
    again = searcher.search("query", 5, video_name="b")
    assert again[0] is scores and again[1] is rows  # the cached arrays
    searcher.invalidate()
    assert searcher.search("query", 5, video_name="b")[0] is not scores
    # k is clamped to the scope: video b holds 25 frames
    assert searcher.search("query", 100, video_name="b")[1].shape == (1, 25)


def test_cache_is_keyed_on_the_index_version(engines):
    je, te = engines
    ji, ti = indexes()
    searcher = TTextSearcher(te, ti)
    first = searcher.search("a dog", 4)
    v0 = ti.version
    extra = np.zeros((3, 32), np.float32)
    extra[:, 0] = 1.0
    ti.add_video("c", extra)
    ji.add_video("c", extra)
    assert ti.snapshot()[4] > v0
    second = searcher.search("a dog", 4)
    assert second[0] is not first[0]
    assert_same_results(second, JTextSearcher(je, ji).search("a dog", 4))
    assert len(searcher._result_cache) == 2


def test_snapshot_matches_jax():
    ji, ti = indexes("int8")
    for scope in (None, "a", "b"):
        jd, js, jstart, jend, jver = ji.snapshot(scope)
        td, ts, tstart, tend, tver = ti.snapshot(scope)
        assert (tstart, tend, tver) == (jstart, jend, jver)
        assert td is ti._device_index and ts is ti._row_scales
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_searcher_follows_the_active_model(engines):
    _, te = engines
    _, ti = indexes()
    other = TEngine(cfg=small_cfg(tclip), params=tclip.init_clip_params(7, small_cfg(tclip)),
                    batch_size=4, device="cpu")
    te.register_model("finetuned", other.params)
    searcher = TTextSearcher(te, ti)
    try:
        s1, _ = searcher.search("query", 5)
        te.set_active_model("finetuned")
        s2, _ = searcher.search("query", 5)
    finally:
        te.set_active_model("original")
    assert np.abs(s1 - s2).max() > 1e-4


@pytest.mark.parametrize("search_impl", ["xla", "pallas", "ivf", "ivfpq"])
def test_query_engine_builds_the_searcher_as_jax_does(engines, search_impl):
    from evr_tpu.query import MetadataStore as JStore
    from evr_tpu.query import QueryEngine as JQueryEngine

    je, te = engines
    kw = {"search_impl": search_impl, "ivf_clusters": 4}
    ji, ti = indexes(**kw)
    jq = JQueryEngine(je, ji, JStore(), batch_window_ms=5.0)
    tq = QueryEngine(te, ti, MetadataStore(), batch_window_ms=5.0)
    assert (tq._searcher is None) == (jq._searcher is None) == (search_impl in ("ivf", "ivfpq"))
    assert (tq._ann_batcher is None) == (jq._ann_batcher is None)
    if tq._searcher is not None:
        hits = tq._candidates_n(QUERIES[0], 6, None)
        ref = jq._candidates_n(QUERIES[0], 6, None)
        assert [(h.video, h.frame_name, h.row) for h in hits] == [(h.video, h.frame_name, h.row) for h in ref]
        np.testing.assert_allclose([h.score for h in hits], [h.score for h in ref], rtol=0, atol=SCORE_TOL)
