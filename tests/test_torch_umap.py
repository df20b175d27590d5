"""The port's UMAP (``viz/umap.py``) against the JAX package's
(``viz/umap_jax.py``).

Deterministic stages are held to JAX's on the same inputs within 1e-5:
``find_ab_params``, ``knn_graph`` (distances; neighbours equal except where
two distances lie within the tolerance), ``smooth_knn_weights``,
``fuzzy_simplicial_set`` and its sparse tier, ``spectral_init`` and
``pca_init``. The layout without negatives is deterministic in both
packages: every one of 20 epochs, started from JAX's layout of the epoch
before, must land within 1e-4 of JAX's, and 5 epochs run freely too (run
freely for 20 epochs the two drift apart: the first epochs' steps of up to
±4 per edge amplify fp32 rounding differences, such as where XLA fuses a
multiply-add). The full layout, whose negatives ``jax.random`` and a
``torch.Generator`` draw differently, is held to the JAX tests' quality bars
(``tests/test_umap_jax.py``) and to the same coordinates for one seed.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from evr_tpu.viz import umap_jax as J
from torch_threads import one_torch_thread  # noqa: F401

T = importlib.import_module("evr_tpu_torch.viz.umap")
torch = pytest.importorskip("torch")

TOL = 1e-5
LAYOUT_TOL = 1e-4


@pytest.fixture(scope="module")
def clusters():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(3, 32)) * 5
    x = np.concatenate([c + rng.normal(size=(60, 32)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(3), 60)


@pytest.fixture(scope="module")
def spread():
    """Unclustered rows: kNN distances far apart, so fp32 product noise
    stays well under the tolerance through the calibration."""
    return np.random.default_rng(1).normal(size=(120, 16)).astype(np.float32)


def _same_neighbours(ti, td, ji, jd):
    np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
    swapped = ti != ji
    # a neighbour may differ only where its distance ties another's
    for r, c in zip(*np.nonzero(swapped)):
        assert abs(jd[r, c] - jd[r, c - 1 if c else c + 1]) <= TOL or \
            abs(jd[r, c] - jd[r, min(c + 1, jd.shape[1] - 1)]) <= TOL, (r, c)
    assert swapped.mean() < 0.01


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_and_weights_match_jax(clusters, metric):
    x, _ = clusters
    assert T.find_ab_params(1.0, 0.1) == J.find_ab_params(1.0, 0.1)
    ji, jd = map(np.asarray, J.knn_graph(x, 15, metric=metric))
    ti, td = T.knn_graph(torch.as_tensor(x), 15, metric=metric)
    scale = 1.0 if metric == "cosine" else float(jd.max())
    _same_neighbours(ti.numpy(), td.numpy() / scale, ji, jd / scale)
    # the calibration alone, from JAX's distances
    jw = np.asarray(J.smooth_knn_weights(jnp.asarray(jd)))
    np.testing.assert_allclose(T.smooth_knn_weights(torch.tensor(jd)).numpy(), jw, atol=TOL)
    assert np.allclose(jw.sum(axis=1), np.log2(15), atol=0.05)


def test_fuzzy_set_and_spectral_init_match_jax(spread):
    jw = J.fuzzy_simplicial_set(spread, 10)
    tw = T.fuzzy_simplicial_set(spread, 10, device="cpu")
    np.testing.assert_allclose(tw, jw, atol=TOL)
    assert np.array_equal(tw != 0, jw != 0)
    np.testing.assert_allclose(T.spectral_init(jw, 2), J.spectral_init(jw, 2), atol=TOL)
    np.testing.assert_allclose(T.spectral_init(tw, 2), J.spectral_init(jw, 2), atol=TOL * 10)


def test_sparse_tier_matches_jax(spread, clusters):
    jh, jt, jw = J.fuzzy_simplicial_set_edges(spread, 10, chunk=32)
    th, tt, tw = T.fuzzy_simplicial_set_edges(spread, 10, chunk=32, device="cpu")
    assert np.array_equal(th, jh) and np.array_equal(tt, jt)
    np.testing.assert_allclose(tw, jw, atol=TOL)
    # the sparse edge set is the dense graph's
    dense = T.fuzzy_simplicial_set(spread, 10, device="cpu")
    assert set(zip(*np.nonzero(dense))) == set(zip(th.tolist(), tt.tolist()))
    x, _ = clusters
    np.testing.assert_allclose(T.pca_init(x, device="cpu"), J.pca_init(x), atol=TOL)


def _layout_inputs(x, n_neighbors=10, min_dist=0.1):
    w = J.fuzzy_simplicial_set(x, n_neighbors)
    heads, tails = np.nonzero(w)
    a, b = J.find_ab_params(1.0, min_dist)
    return J.spectral_init(w), heads, tails, w[heads, tails].astype(np.float32), a, b


def _jax_layout(y0, heads, tails, weights, a, b, n_epochs):
    return np.asarray(J.optimize_layout(
        jnp.asarray(y0), jnp.asarray(heads, jnp.int32), jnp.asarray(tails, jnp.int32),
        jnp.asarray(weights), jax.random.PRNGKey(0), a, b, n_epochs=n_epochs,
        negative_sample_rate=0))


@pytest.mark.parametrize("n,d,seed", [(20, 8, 0), (60, 32, 1)])
def test_layout_without_negatives_matches_jax(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    y0, heads, tails, weights, a, b = _layout_inputs(x)
    y_j = y0
    for epoch in range(20):
        ref = _jax_layout(y_j, heads, tails, weights, a, b, 1)
        got = T.optimize_layout(y_j, heads, tails, weights, None, a, b, n_epochs=1,
                                negative_sample_rate=0, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, atol=LAYOUT_TOL, err_msg=f"epoch {epoch}")
        y_j = ref
    free = T.optimize_layout(y0, heads, tails, weights, None, a, b, n_epochs=5,
                             negative_sample_rate=0, device="cpu").numpy()
    np.testing.assert_allclose(free, _jax_layout(y0, heads, tails, weights, a, b, 5), atol=LAYOUT_TOL)


def _intra_inter(y, labels):
    from scipy.spatial.distance import cdist

    k = labels.max() + 1
    intra = np.mean([cdist(y[labels == i], y[labels == i]).mean() for i in range(k)])
    inter = np.mean([cdist(y[labels == i], y[labels == j]).mean()
                     for i in range(k) for j in range(k) if i != j])
    return intra, inter


def test_layout_quality_bars(clusters):
    """``tests/test_umap_jax.py``'s bars: clusters apart, min_dist's meaning,
    trustworthiness above PCA's and 0.85, the same coordinates twice. Its
    t-SNE bar needs the reference fixture's embeddings (not in the repo; on
    these clusters both packages' t-SNE beat their UMAP), so the port's
    trustworthiness is held to JAX's UMAP's on the same rows instead."""
    from scipy.spatial.distance import cdist
    from sklearn.decomposition import PCA
    from sklearn.manifold import trustworthiness

    x, labels = clusters
    y = T.umap(x, metric="euclidean", device="cpu")
    assert y.shape == (len(x), 2) and np.isfinite(y).all()
    intra, inter = _intra_inter(y, labels)
    assert inter > 3 * intra, (intra, inter)
    t_umap = trustworthiness(x, y, n_neighbors=10)
    t_pca = trustworthiness(x, PCA(2).fit_transform(x), n_neighbors=10)
    t_jax = trustworthiness(x, J.umap(x, metric="euclidean"), n_neighbors=10)
    assert t_umap > max(t_pca, 0.85), (t_umap, t_pca)
    assert t_umap > t_jax - 0.01, (t_umap, t_jax)

    def mean_nn(yv):
        d = cdist(yv, yv)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1).mean()

    tight = T.umap(x, min_dist=0.01, metric="euclidean", n_epochs=200, device="cpu")
    loose = T.umap(x, min_dist=0.99, metric="euclidean", n_epochs=200, device="cpu")
    assert mean_nn(tight) < mean_nn(loose)
    y1 = T.umap(x[:60], n_epochs=50, random_state=7, device="cpu")
    assert np.array_equal(y1, T.umap(x[:60], n_epochs=50, random_state=7, device="cpu"))
    assert not np.array_equal(y1, T.umap(x[:60], n_epochs=50, random_state=8, device="cpu"))


def test_sparse_tier_layout_and_tiny_inputs():
    from sklearn.manifold import trustworthiness

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(6, 24)) * 5
    x = np.concatenate([c + rng.normal(size=(120, 24)) for c in centers]).astype(np.float32)
    y = T.umap(x, metric="euclidean", dense_threshold=100, n_epochs=150, device="cpu")
    assert y.shape == (720, 2)
    assert trustworthiness(x, y, n_neighbors=10) > 0.8
    assert T.umap(np.random.default_rng(0).normal(size=(2, 8)), device="cpu").shape == (2, 2)
    y = T.umap(np.random.default_rng(0).normal(size=(5, 8)), n_neighbors=15, device="cpu")
    assert y.shape == (5, 2) and np.isfinite(y).all()


def test_segment_sums_in_a_fixed_order():
    """The layout's scatter: each point's edges summed in edge order, equal
    to a plain loop and the same however often it runs."""
    rng = np.random.default_rng(4)
    index = torch.as_tensor(rng.integers(0, 7, 200))
    values = torch.as_tensor(rng.normal(size=(200, 2)).astype(np.float32))
    seg = T._SegmentSum(index, 9)
    out = seg(values)
    ref = torch.zeros(9, 2)
    for i, v in zip(index.tolist(), values):
        ref[i] += v
    assert torch.equal(out, ref) and torch.equal(out, seg(values))
    assert torch.equal(out[7:], torch.zeros(2, 2))  # points without edges
