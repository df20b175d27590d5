"""The port's exact search over a row-sharded index
(``evr_tpu_torch.parallel.sharded_search``, ``FrameIndex(mesh=)``) held to
the JAX package's (``evr_tpu.parallel.sharded_search``, on conftest's 8 host
devices): the same unit rows, queries and ranges, rows equal and scores
within 1e-5, at 4 and 8 slots, bf16 and int8, with a range that ends inside
a shard holding fewer than k of its rows. The port's mesh slots are the CPU
listed several times."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from evr_tpu.index.store import FrameIndex as JFrameIndex
from evr_tpu.ops.topk import merge_topk as jmerge_topk
from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.sharded_search import sharded_cosine_topk as jsharded
from evr_tpu_torch.index.fused_search import TextSearcher
from evr_tpu_torch.index.store import FrameIndex
from evr_tpu_torch.ops.topk import merge_topk
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.sharded_search import ShardedIndex, shard_route, sharded_cosine_topk
from torch_threads import one_torch_thread  # noqa: F401

ROWS, DIM, K = 512, 32, 10
# (start, end): the whole corpus, a range inside it, and one ending two rows
# into a shard (of 64 rows at 8 slots, 128 at 4), fewer than k of its rows
RANGES = ((0, 500), (37, 301), (10, 130))


def unit_rows(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def stored(rows: np.ndarray, dtype: str):
    """(rows as the index stores them, per-row scales or None), numpy."""
    if dtype == "int8":
        scales = (np.maximum(np.abs(rows).max(axis=1), 1e-12) / 127.0).astype(np.float32)
        return np.clip(np.round(rows / scales[:, None]), -127, 127).astype(np.int8), scales
    return rows, None


def jax_index(mesh, rows, dtype):
    arr = jnp.asarray(rows).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(rows)
    return jax.device_put(arr, NamedSharding(mesh, P("data", None)))


def torch_index(rows, dtype):
    t = torch.from_numpy(rows)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def test_merge_topk_exact(rng):
    """``tests/test_parallel.py::test_merge_topk_exact``: both packages'
    merges over the same per-shard lists give the global top k."""
    S, Q, k, N = 4, 3, 5, 40
    full = rng.normal(size=(Q, S * N)).astype(np.float32)
    shard_scores, shard_idx = [], []
    for s in range(S):
        block = full[:, s * N:(s + 1) * N]
        top = np.argsort(-block, axis=1)[:, :k]
        shard_scores.append(np.take_along_axis(block, top, axis=1))
        shard_idx.append(top + s * N)
    ts, ti = merge_topk(torch.from_numpy(np.stack(shard_scores)), torch.from_numpy(np.stack(shard_idx)), k)
    js, ji = jmerge_topk(jnp.asarray(np.stack(shard_scores)), jnp.asarray(np.stack(shard_idx)), k)
    expected = np.argsort(-full, axis=1)[:, :k]
    np.testing.assert_array_equal(ti.numpy(), expected)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("slots", [4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_cosine_topk_matches_jax(slots, dtype):
    rng = np.random.default_rng(slots)
    rows, scales = stored(unit_rows(rng, ROWS), dtype)
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    jmesh, tmesh = jget_mesh(slots), get_mesh(slots, device="cpu")
    jidx = jax_index(jmesh, rows, dtype)
    jsc = None if scales is None else jax.device_put(jnp.asarray(scales), NamedSharding(jmesh, P("data")))
    tsc = None if scales is None else torch.from_numpy(scales)
    # one compile for every range: the range is a traced argument
    jsearch = jax.jit(lambda idx, qq, a, b, sc: jsharded(jmesh, idx, qq, a, b, K, row_scales=sc))
    for start, end in RANGES:
        js, jr = jsearch(jidx, jnp.asarray(q), jnp.int32(start), jnp.int32(end), jsc)
        ts, tr = sharded_cosine_topk(tmesh, torch_index(rows, dtype), torch.from_numpy(q), start, end, K,
                                     row_scales=tsc)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=str((start, end)))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, err_msg=str((start, end)))
        assert ((tr.numpy() >= start) & (tr.numpy() < end)).all()


def test_pallas_route_equals_xla_and_one_device():
    """``impl="pallas"`` runs K4's function on each slot (its plain version
    on the CPU): the same rows as the GEMM route and as the one-device
    search, scores within 1e-5; where a shard holds fewer than k rows of the
    range, its −inf entries never reach the merged top k."""
    from evr_tpu_torch.ops.retrieval import fused_topk

    rng = np.random.default_rng(3)
    rows, scales = stored(unit_rows(rng, ROWS), "int8")
    q = torch.from_numpy(rng.standard_normal((2, DIM)).astype(np.float32))
    idx, sc = torch.from_numpy(rows), torch.from_numpy(scales)
    mesh = get_mesh(8, device="cpu")
    assert shard_route("pallas", ROWS // 8, DIM, 2, K) == "pallas"
    for start, end in RANGES + ((120, 130),):
        k = min(K, end - start)
        one_s, one_r = fused_topk(idx, q, start, end, k, sc)
        for impl in ("pallas", "xla"):
            s, r = sharded_cosine_topk(mesh, idx, q, start, end, k, row_scales=sc, impl=impl)
            np.testing.assert_array_equal(r.numpy(), one_r.numpy(), err_msg=f"{impl} {start} {end}")
            np.testing.assert_allclose(s.numpy(), one_s.numpy(), atol=1e-5)
            assert np.isfinite(s.numpy()).all()
            assert all(len(set(row)) == k for row in r.numpy().tolist())


def test_route_is_decided_by_shape():
    """K4 where its plan takes a shard's shape, the GEMM route otherwise (a
    width that is no multiple of 16; k past the shard); an unknown impl and a
    k larger than a shard raise."""
    assert shard_route("pallas", 64, 32, 1, 10) == "pallas"
    assert shard_route("pallas", 64, 24, 1, 10) == "xla"
    assert shard_route("pallas", 64, 32, 1, 65) == "xla"
    assert shard_route("xla", 64, 32, 1, 10) == "xla"
    mesh = get_mesh(4, device="cpu")
    x = torch.zeros((256, 32))
    with pytest.raises(ValueError, match="unknown impl"):
        sharded_cosine_topk(mesh, x, x[:1], 0, 256, 5, impl="faiss")
    with pytest.raises(ValueError, match="rows of one shard"):
        sharded_cosine_topk(mesh, x, x[:1], 0, 256, 65)
    with pytest.raises(ValueError, match="do not split"):
        sharded_cosine_topk(mesh, x[:255], x[:1], 0, 255, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frame_index_mesh_matches_jax_and_one_device(dtype):
    """``FrameIndex(mesh=)`` against the JAX package's over its mesh and the
    port's own one-device index: padded rows, global and per-video results."""
    rng = np.random.default_rng(11)
    videos = {"a": unit_rows(rng, 70), "b": unit_rows(rng, 3), "c": unit_rows(rng, 150)}
    q = unit_rows(rng, 2)
    tmesh, jmesh = get_mesh(4, device="cpu"), jget_mesh(4)
    sharded = FrameIndex(embed_dim=DIM, device_dtype=dtype, mesh=tmesh)
    one = FrameIndex(embed_dim=DIM, device_dtype=dtype, device="cpu")
    jidx = JFrameIndex(embed_dim=DIM, device_dtype=dtype, mesh=jmesh)
    for name, emb in videos.items():
        for ix in (sharded, one, jidx):
            ix.add_video(name, emb)
    sharded.build()
    jidx.build()
    assert isinstance(sharded._device_index, ShardedIndex)
    assert sharded._device_index.shape[0] == jidx._device_index.shape[0] == 4 * 128
    for video, k in ((None, K), ("a", 5), ("b", 3), ("c", 20)):
        ts, tr = sharded.search_raw(q, k, video)
        os_, or_ = one.search_raw(q, k, video)
        np.testing.assert_array_equal(tr, or_, err_msg=str(video))
        np.testing.assert_allclose(ts, os_, atol=1e-5)
        if video is None:  # each JAX search compiles: the global one
            js, jr = jidx.search_raw(q, k, video)
            np.testing.assert_array_equal(tr, np.asarray(jr), err_msg=str(video))
            np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5)
    # the uploads of a mesh index rebuild (no in-place append), as in JAX
    sharded.add_video("d", unit_rows(rng, 5))
    assert sharded._dirty


def test_text_searcher_over_a_sharded_index():
    """The one-call searcher takes a sharded snapshot: the same results as
    over the one-device index."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig

    cfg = CLIPConfig(embed_dim=32, vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=1, heads=4),
                     text=TextConfig(width=64, layers=1, heads=4))
    engine = EmbeddingEngine(cfg=cfg, batch_size=8, device="cpu")
    rng = np.random.default_rng(5)
    emb = unit_rows(rng, 300)
    results = []
    for mesh in (None, get_mesh(4, device="cpu")):
        ix = FrameIndex(embed_dim=32, mesh=mesh, device=None if mesh else "cpu")
        ix.add_video("v", emb)
        results.append(TextSearcher(engine, ix).search(["a red car", "a dog"], 7))
    np.testing.assert_array_equal(results[0][1], results[1][1])
    np.testing.assert_allclose(results[0][0], results[1][0], atol=1e-5)
