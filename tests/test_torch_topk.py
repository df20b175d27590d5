"""The PyTorch port's cosine top-k and top-k merge against the JAX package.

Same rows and queries (numpy, seeded) into both on the CPU. Tolerance:
scores within 1e-5 (the JAX retrieval tests' top-k bound), row indices
identical; equal scores must return the lower row first, as ``lax.top_k``
does, also across the row chunks a quantised index is scored in.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops.topk import cosine_topk as jtopk, merge_topk as jmerge
from evr_tpu_torch.ops import topk as ttopk_module
from evr_tpu_torch.ops.topk import cosine_topk as ttopk, merge_topk as tmerge

SCORE_TOL = 1e-5
D = 32


def _unit_rows(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _quantise(rows):
    scales = np.maximum(np.abs(rows).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.round(rows / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rng_range", [(0, 200), (37, 91)])
def test_cosine_topk_matches_jax(dtype, rng_range):
    rows = _unit_rows(256, 0)
    queries = np.random.default_rng(1).standard_normal((3, D)).astype(np.float32) * 3
    start, end = rng_range
    scales = None
    if dtype == "int8":
        rows, scales = _quantise(rows)
        jidx, tidx = jnp.asarray(rows), torch.from_numpy(rows)
    elif dtype == "bfloat16":
        jidx, tidx = jnp.asarray(rows).astype(jnp.bfloat16), torch.from_numpy(rows).bfloat16()
    else:
        jidx, tidx = jnp.asarray(rows), torch.from_numpy(rows)
    js, ji = jtopk(jidx, jnp.asarray(queries), jnp.int32(start), jnp.int32(end), 10,
                   None if scales is None else jnp.asarray(scales))
    ts, ti = ttopk(tidx, torch.from_numpy(queries), start, end, 10,
                   None if scales is None else torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    assert ((ti.numpy() >= start) & (ti.numpy() < end)).all()


def test_topk_ties_return_the_lower_row_first():
    base = _unit_rows(4, 2)
    # rows 3, 7, 8, 12 are the same vector; 5 and 9 are another one
    rows = _unit_rows(16, 3)
    for r in (3, 7, 8, 12):
        rows[r] = base[0]
    rows[5] = rows[9] = base[1]
    q = (base[0] + 0.5 * base[1])[None]
    js, ji = jtopk(jnp.asarray(rows), jnp.asarray(q), jnp.int32(0), jnp.int32(16), 6)
    ts, ti = ttopk(torch.from_numpy(rows), torch.from_numpy(q), 0, 16, 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, :4].tolist() == [3, 7, 8, 12]
    # masked rows (-inf) tie too: still the lower row first
    ts, ti = ttopk(torch.from_numpy(rows), torch.from_numpy(q), 2, 5, 4)
    js, ji = jtopk(jnp.asarray(rows), jnp.asarray(q), jnp.int32(2), jnp.int32(5), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(4)
    scores = np.round(rng.standard_normal((3, 2, 5)), 1).astype(np.float32)  # with ties
    idx = rng.integers(0, 1000, (3, 2, 5)).astype(np.int32)
    jb, jp = jmerge(jnp.asarray(scores), jnp.asarray(idx), 6)
    tb, tp = tmerge(torch.from_numpy(scores), torch.from_numpy(idx), 6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("rng_range", [(0, 100), (21, 30)])
def test_chunked_topk_matches_jax(monkeypatch, dtype, rng_range):
    """A quantised index scored in 16-row chunks: the same top k as the JAX
    one-shot top-k, with ties across chunk boundaries lower row first, and
    a range holding fewer than k rows padded with masked rows as JAX pads."""
    monkeypatch.setattr(ttopk_module, "CHUNK_ROWS", 16)
    rows = _unit_rows(100, 9)
    for r in (14, 15, 16, 33, 70):  # one vector in four chunks
        rows[r] = rows[3]
    queries = np.concatenate([rows[3:4], np.random.default_rng(10).standard_normal((2, D))])
    queries = queries.astype(np.float32)
    start, end = rng_range
    scales = None
    if dtype == "int8":
        rows, scales = _quantise(rows)
        jidx, tidx = jnp.asarray(rows), torch.from_numpy(rows)
    else:
        jidx, tidx = jnp.asarray(rows).astype(jnp.bfloat16), torch.from_numpy(rows).bfloat16()
    js, ji = jtopk(jidx, jnp.asarray(queries), jnp.int32(start), jnp.int32(end), 12,
                   None if scales is None else jnp.asarray(scales))
    ts, ti = ttopk(tidx, torch.from_numpy(queries), start, end, 12,
                   None if scales is None else torch.from_numpy(scales))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    if rng_range == (0, 100):
        assert ti[0, :6].tolist() == [3, 14, 15, 16, 33, 70]
