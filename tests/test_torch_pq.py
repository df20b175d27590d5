"""The PQ tier of the PyTorch port (``evr_tpu_torch.index.pq``) against the JAX
package's (``evr_tpu.index.pq``).

``kmeans_l2_from_init`` is held to JAX ``kmeans_l2`` given JAX's own init
rows (centroids within 1e-5, assignments equal), single and batched over
subspaces. A JAX-built ``PQIndex`` (plain and OPQ) is loaded by the port from
its ``.npz`` and searched with and without re-rank: rows equal to JAX's,
scores within 1e-5 (ADC tables differ only in the order of their sums); its
reconstructions equal JAX's. A port-built index is searched by JAX with the
same rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.index.pq import PQIndex as JPQ
from evr_tpu.index.pq import kmeans_l2 as jkmeans_l2
from evr_tpu_torch.index import PQIndex
from evr_tpu_torch.index.pq import kmeans_l2_from_init

TOL = dict(rtol=1e-5, atol=1e-5)


def _normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    centers = _normed(rng.standard_normal((12, 32)))
    emb = _normed(centers[rng.integers(0, 12, 1500)] + 0.25 * rng.standard_normal((1500, 32)))
    q = _normed(emb[rng.integers(0, 1500, 5)] + 0.05 * rng.standard_normal((5, 32)))
    return emb, q


def test_kmeans_l2_from_init_matches_jax(corpus):
    emb, _ = corpus
    x = emb[:, :8]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jc, ja, inits = [], [], []
    for i, key in enumerate(keys):
        xs = emb[:, 8 * i : 8 * i + 8]
        c, a = jkmeans_l2(key, jnp.asarray(xs), 32, iters=5)
        jc.append(np.asarray(c))
        ja.append(np.asarray(a))
        inits.append(xs[np.asarray(jax.random.choice(key, len(xs), (32,), replace=False))])
    tc, ta = kmeans_l2_from_init(torch.from_numpy(x), torch.from_numpy(inits[0]), iters=5)
    np.testing.assert_allclose(tc.numpy(), jc[0], **TOL)
    np.testing.assert_array_equal(ta.numpy(), ja[0])
    # batched over a leading subspace axis, as the PQ training runs it
    xs = torch.from_numpy(np.stack([emb[:, :8], emb[:, 8:16]]))
    bc, ba = kmeans_l2_from_init(xs, torch.from_numpy(np.stack(inits)), iters=5)
    np.testing.assert_allclose(bc.numpy(), np.stack(jc), **TOL)
    np.testing.assert_array_equal(ba.numpy(), np.stack(ja))


@pytest.mark.parametrize("opq_iters", [0, 2], ids=["pq", "opq"])
def test_port_searches_a_jax_built_index(opq_iters, corpus, tmp_path):
    emb, q = corpus
    jidx = JPQ().build(emb, n_subspaces=8, n_centroids=32, iters=4, opq_iters=opq_iters)
    jidx.save(tmp_path / "pq.npz")
    tidx = PQIndex.load(tmp_path / "pq.npz", device="cpu")
    assert (tidx.rotation is not None) == (opq_iters > 0)
    for rerank in (None, 40):
        js, jr = jidx.search(q, 10, rerank=rerank)
        ts, tr = tidx.search(q, 10, rerank=rerank)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(ts, js, **TOL)
    rows = np.array([0, 7, 1499])
    np.testing.assert_allclose(tidx.reconstruct(rows), jidx.reconstruct(rows), **TOL)


def test_jax_searches_a_port_built_index(corpus, tmp_path):
    emb, q = corpus
    for opq_iters in (0, 2):
        idx = PQIndex().build(emb, n_subspaces=8, n_centroids=32, iters=4, opq_iters=opq_iters,
                              device="cpu")
        assert idx.codes.dtype == torch.uint8 and idx.code_bytes == len(emb) * 8
        idx.save(tmp_path / f"p{opq_iters}.npz")
        jidx = JPQ.load(tmp_path / f"p{opq_iters}.npz")
        for rerank in (None, 40):
            ts, tr = idx.search(q, 10, rerank=rerank)
            js, jr = jidx.search(q, 10, rerank=rerank)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_allclose(ts, js, **TOL)
        # re-rank returns the exact cosines of the rows it names
        s, r = idx.search(q, 10, rerank=60)
        np.testing.assert_allclose(s, np.einsum("bd,bkd->bk", q, emb[r]), **TOL)
        # a seeded build repeats exactly
        again = PQIndex().build(emb, n_subspaces=8, n_centroids=32, iters=4, opq_iters=opq_iters,
                                device="cpu")
        assert torch.equal(again.codes, idx.codes)


def test_validation(corpus):
    emb, q = corpus
    with pytest.raises(ValueError, match="not divisible"):
        PQIndex().build(emb, n_subspaces=5, device="cpu")
    with pytest.raises(ValueError, match=r"\[1, 256\]"):
        PQIndex().build(emb, n_subspaces=8, n_centroids=300, device="cpu")
    with pytest.raises(ValueError, match="n_centroids=64 > n_rows=40"):
        PQIndex().build(emb[:40], n_subspaces=8, n_centroids=64, device="cpu")
    with pytest.raises(ValueError, match="before build"):
        PQIndex().search(q, 3)
    lean = PQIndex().build(emb, n_subspaces=8, n_centroids=16, iters=2, keep_originals=False,
                           device="cpu")
    with pytest.raises(ValueError, match="keep_originals"):
        lean.search(q, 3, rerank=10)
