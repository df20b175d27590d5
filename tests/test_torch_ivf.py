"""The IVF tier of the PyTorch port (``evr_tpu_torch.index.ivf``) against the
JAX package's (``evr_tpu.index.ivf``).

The list fill is the same numpy code (bit-equal placements). k-means differs
only in its initial draw, so ``kmeans_from_init`` is held to JAX ``kmeans``
given JAX's own init rows: centroids within 1e-5, assignments equal. Whole
indexes cross through the shared ``.npz`` layout: a JAX-built index (every
layout and storage dtype) is searched by the port with rows equal to JAX's
and scores within 1e-5 (every layout sums its scores in fp32, bf16 and int8
operands being exact there); a port-built index is searched by JAX with the same rows. A
port-built index is also held to the tier's invariants: every row in exactly
one place, the spill keeping the pool small, and a full probe equal to brute
force.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.index.ivf import IVFIndex as JIVF
from evr_tpu.index.ivf import fill_inverted_lists_multi as jfill
from evr_tpu.index.ivf import kmeans as jkmeans
from evr_tpu_torch.index import IVFIndex
from evr_tpu_torch.index.ivf import fill_inverted_lists_multi, kmeans_from_init

TOL = dict(rtol=1e-5, atol=1e-5)


def _normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    centers = _normed(rng.standard_normal((16, 32)))
    emb = _normed(centers[rng.integers(0, 16, 2000)] + 0.2 * rng.standard_normal((2000, 32)))
    q = _normed(emb[rng.integers(0, 2000, 6)] + 0.05 * rng.standard_normal((6, 32)))
    return emb, q


@pytest.mark.parametrize("m,start_row", [(1, 0), (4, 37)])
def test_fill_inverted_lists_multi_is_bit_equal(m, start_row):
    rng = np.random.default_rng(m)
    topm = np.stack([rng.permutation(12)[:m] for _ in range(900)])
    lists_j = np.full((12, 70), -1, np.int32)
    lists_j[:, :5] = rng.integers(0, 10, (12, 5))  # lists already part full
    lists_t = lists_j.copy()
    ovf_j, ovf_t = [], []
    pj = jfill(topm, lists_j, ovf_j, start_row=start_row)
    pt = fill_inverted_lists_multi(topm, lists_t, ovf_t, start_row=start_row)
    np.testing.assert_array_equal(lists_t, lists_j)
    np.testing.assert_array_equal(pt, pj)
    assert ovf_t == ovf_j and len(ovf_j) > 0


def test_kmeans_from_init_matches_jax(corpus):
    emb, _ = corpus
    key = jax.random.PRNGKey(5)
    init_idx = np.asarray(jax.random.choice(key, len(emb), (16,), replace=False))
    jc, ja = jkmeans(key, jnp.asarray(emb), 16, iters=6)
    tc, ta = kmeans_from_init(torch.from_numpy(emb), torch.from_numpy(emb[init_idx]), iters=6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32


def _jax_index(layout, emb):
    x = jnp.asarray(emb)
    if layout == "build-f32":
        return JIVF().build(emb, n_clusters=16, capacity_factor=1.1, iters=4)
    if layout == "build-bf16":
        return JIVF().build(emb, n_clusters=16, capacity_factor=1.1, iters=4, dtype="bfloat16")
    kw = dict(n_clusters=16, iters=4, train_rows=1024, slab_rows=700, capacity_factor=1.05)
    if layout == "device-int8-unpacked":
        return JIVF().build_device(x, dtype="int8", packed=False, **kw)
    return JIVF().build_device(x, dtype=layout.split("-")[1], **kw)


LAYOUTS = ["build-f32", "build-bf16", "device-int8-unpacked", "device-int8-packed",
           "device-bfloat16-packed"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_searches_a_jax_built_index(layout, corpus, tmp_path):
    emb, q = corpus
    jidx = _jax_index(layout, emb)
    assert int(jidx.overflow.shape[0]) > 0  # a tight capacity: a real pool
    jidx.save(tmp_path / "j.npz")
    tidx = IVFIndex.load(tmp_path / "j.npz", device="cpu")
    assert tidx.packed == jidx.packed and tidx.n_rows == jidx.n_rows
    for nprobe in (1, 4, 16):
        js, jr = jidx.search(q, 10, nprobe=nprobe)
        ts, tr = tidx.search(q, 10, nprobe=nprobe)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(ts, js, **TOL)


def test_full_probe_is_brute_force_and_rows_live_once(corpus):
    emb, q = corpus
    idx = IVFIndex().build(emb, n_clusters=16, capacity_factor=1.05, iters=4, device="cpu")
    rows = np.concatenate([idx.list_rows.numpy().ravel(), idx.overflow.numpy()])
    rows = rows[rows >= 0]
    np.testing.assert_array_equal(np.sort(rows), np.arange(len(emb)))  # exactly once
    # spill choices keep the pool small; single choice does not
    single = IVFIndex().build(emb, n_clusters=16, capacity_factor=1.05, iters=4,
                              spill_choices=1, device="cpu")
    assert idx.overflow.shape[0] < min(single.overflow.shape[0] // 2, 0.03 * len(emb))
    brute = q @ emb.T
    want = np.argsort(-brute, axis=1, kind="stable")[:, :10]
    s, r = idx.search(q, 10, nprobe=16)
    np.testing.assert_array_equal(r, want)
    np.testing.assert_allclose(s, np.take_along_axis(brute, want, 1), **TOL)
    # a seeded build repeats exactly
    again = IVFIndex().build(emb, n_clusters=16, capacity_factor=1.05, iters=4, device="cpu")
    assert torch.equal(again.list_rows, idx.list_rows) and torch.equal(again.centroids, idx.centroids)


def test_append_matches_jax(corpus, tmp_path):
    emb, q = corpus
    new = _normed(emb[:150] + 0.01 * np.random.default_rng(2).standard_normal((150, 32)))
    for layout in ("build-f32", "device-int8-packed"):
        jidx = _jax_index(layout, emb[:1800])
        jidx.save(tmp_path / "a.npz")
        tidx = IVFIndex.load(tmp_path / "a.npz", device="cpu")
        o0 = tidx._overflow_size
        np.testing.assert_array_equal(tidx.append(new), jidx.append(new))
        assert tidx._overflow_size > o0  # the appended rows spilled into the pool too
        for nprobe in (2, 16):
            js, jr = jidx.search(q, 10, nprobe=nprobe)
            ts, tr = tidx.search(q, 10, nprobe=nprobe)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_allclose(ts, js, **TOL)


def test_jax_searches_a_port_built_index(corpus, tmp_path):
    emb, q = corpus
    for name, idx in (
        ("build", IVFIndex().build(emb, n_clusters=16, iters=4, device="cpu")),
        ("packed", IVFIndex().build_device(torch.from_numpy(emb), n_clusters=16, iters=4,
                                           dtype="float32", train_rows=1024)),
        ("int8", IVFIndex().build_device(torch.from_numpy(emb), n_clusters=16, iters=4,
                                         dtype="int8", packed=False, train_rows=1024)),
    ):
        idx.save(tmp_path / f"{name}.npz")
        jidx = JIVF.load(tmp_path / f"{name}.npz")
        for nprobe in (3, 16):
            ts, tr = idx.search(q, 8, nprobe=nprobe)
            js, jr = jidx.search(q, 8, nprobe=nprobe)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_allclose(ts, js, **TOL)


def test_validation():
    x = np.ones((10, 8), np.float32)
    with pytest.raises(ValueError, match="n_clusters=11"):
        IVFIndex().build(x, n_clusters=11, device="cpu")
    with pytest.raises(ValueError, match="storage dtype"):
        IVFIndex().build(x, n_clusters=2, dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="row_scales"):
        IVFIndex().build_device(torch.zeros((10, 8), dtype=torch.int8), n_clusters=2, dtype="int8")
    with pytest.raises(ValueError, match="before build"):
        IVFIndex().search(x, 3, nprobe=1)
    idx = IVFIndex().build(x, n_clusters=2, device="cpu")
    with pytest.raises(ValueError, match=r"append rows must be \(M, 8\)"):
        idx.append(np.ones((3, 5), np.float32))
