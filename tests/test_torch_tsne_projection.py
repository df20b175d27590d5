"""The port's t-SNE (``viz/tsne.py``) and projection layer
(``viz/projection.py``) against the JAX package's.

t-SNE starts from numpy's seeded generator in both packages, so the
affinities (1e-5) and 10 iterations of the layout (1e-4 of the layout's
extent, from JAX's affinities) must agree; the full run is held to the JAX
test's separation bar. The bound is relative because the exaggerated phase
(×12 at learning rate 100) throws a 1e-2 start out to about ±120 in ten
iterations, so each package's fp32 rounding grows with it: from the same
affinities the two lie 2e-5 of the extent apart, from their own 4e-4. The projection API keeps
JAX's method strings; its PCA runs without sklearn in the port and must
equal sklearn's (JAX's) within 1e-5, and ``generate_visualization``'s
payload must equal JAX's field for field, coordinates within 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from evr_tpu.index import FrameIndex as JIndex
from evr_tpu.query import MetadataStore as JStore
from evr_tpu.viz import projection as jproj
from evr_tpu.viz import tsne_jax as jtsne
from evr_tpu_torch.index import FrameIndex as TIndex
from evr_tpu_torch.query import MetadataStore as TStore
from evr_tpu_torch.viz import projection as tproj
from evr_tpu_torch.viz import tsne as ttsne
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")
TOL = 1e-5


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    centers = np.eye(3, 16) * 8
    labels = np.repeat(np.arange(3), 40)
    return (centers[labels] + rng.normal(size=(120, 16)) * 0.3).astype(np.float32), labels


def test_affinities_match_jax(blobs):
    x, _ = blobs
    jd2 = np.asarray(jtsne._pairwise_sq_dists(jnp.asarray(x)))
    td2 = ttsne._pairwise_sq_dists(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(td2, jd2, rtol=TOL, atol=TOL * float(jd2.max()))
    jp = np.asarray(jtsne._calibrate_p(jnp.asarray(jd2), 15.0))
    tp = ttsne._calibrate_p(torch.tensor(jd2), 15.0).numpy()
    np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL * float(jp.max()))


def test_ten_iterations_match_jax(blobs):
    x, _ = blobs
    jp = jtsne._calibrate_p(jtsne._pairwise_sq_dists(jnp.asarray(x)), 15.0)
    y0 = (np.random.default_rng(42).normal(size=(len(x), 2)) * 1e-2).astype(np.float32)
    ref = np.asarray(jtsne._tsne_optimize(jp, jnp.asarray(y0), n_iter=10))
    got = ttsne._tsne_optimize(torch.tensor(np.asarray(jp)), torch.tensor(y0), n_iter=10).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()))
    # the entry point: the same start, metric handling and perplexity clamp
    for metric in ("euclidean", "cosine"):
        ref = jtsne.tsne(x[:40], n_iter=1, metric=metric)
        got = ttsne.tsne(x[:40], n_iter=1, metric=metric, device="cpu")
        np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()))


def test_full_run_separates_clusters(blobs):
    x, labels = blobs
    y = ttsne.tsne(x, perplexity=15, n_iter=300, metric="euclidean", device="cpu")
    assert y.shape == (120, 2) and np.isfinite(y).all()

    def mean_dist(a, b):
        return float(np.linalg.norm(a[:, None] - b[None, :], axis=-1).mean())

    intra = np.mean([mean_dist(y[labels == c], y[labels == c]) for c in range(3)])
    inter = np.mean([mean_dist(y[labels == a], y[labels == b]) for a in range(3) for b in range(3) if a != b])
    assert inter > 2.0 * intra, (intra, inter)
    d = np.linalg.norm(y[:, None] - y[None, :], axis=-1) + np.eye(120) * 1e9
    assert float((labels[d.argmin(axis=1)] == labels).mean()) > 0.9


@pytest.mark.parametrize("shape", [(50, 12), (300, 16), (3, 8)])
def test_pca_without_sklearn_matches_jax(shape):
    x = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    for metric in ("cosine", "euclidean"):
        ref, ref_used = jproj.project_embeddings(x, method="pca", metric=metric)
        got, used = tproj.project_embeddings(x, method="pca", metric=metric, device="cpu")
        assert used == ref_used == "pca" and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, float(np.abs(ref).max())))


def test_method_strings_as_jax(blobs):
    x, _ = blobs
    for method in ("auto", "umap", "umap_jax"):
        coords, used = tproj.project_embeddings(x[:50], method=method, n_neighbors=10, device="cpu")
        assert used == "umap" and coords.shape == (50, 2) and np.isfinite(coords).all()
    again, _ = tproj.project_embeddings(x[:50], method="umap", n_neighbors=10, device="cpu")
    assert np.array_equal(coords, again)
    coords, used = tproj.project_embeddings(x[:50], method="tsne_jax", device="cpu")
    assert used == "tsne_jax" and coords.shape == (50, 2)
    ref, ref_used = jproj.project_embeddings(x[:50], method="tsne")  # sklearn in both
    got, used = tproj.project_embeddings(x[:50], method="tsne", device="cpu")
    assert used == ref_used == "tsne"
    np.testing.assert_allclose(got, ref, atol=TOL)
    with pytest.raises(ImportError):
        tproj.project_embeddings(x[:10], method="umap-learn", device="cpu")


def _root(index_cls, store_cls, n, **index_kwargs):
    rng = np.random.default_rng(2)
    index, store = index_cls(embed_dim=16, pad_multiple=32, **index_kwargs), store_cls()
    for v, count in (("v1", n), ("v2", n // 2)):
        index.add_video(v, rng.normal(size=(count, 16)).astype(np.float32), [f"{i}.jpg" for i in range(count)])
        store.add_video(v, [{
            "frameidx": i, "frameid": f"{i}.jpg", "video": f"videos/{v}.mp4",
            "filepath": f"frames/{v}/{i}.jpg", "tags": [], "metadata": {},
            "text_detections": {"detections": [{"label": "EXIT", "confidence": 0.5}] if i % 3 else []},
            "object_detections": {"detections": [{"label": "car", "confidence": 0.7}] if i % 4 == 0 else []},
        } for i in range(count)], fps=25.0)
    return index, store


@pytest.mark.parametrize("max_points", [None, 100])
def test_generate_visualization_matches_jax(max_points, tmp_path):
    j = jproj.generate_visualization(*_root(JIndex, JStore, 120), method="pca", max_points=max_points)
    t = tproj.generate_visualization(*_root(TIndex, TStore, 120, device="cpu"), method="pca",
                                     max_points=max_points, device="cpu")
    assert set(t) == set(j)
    for key in j:
        if key == "coordinates":
            np.testing.assert_allclose(np.array(t[key]), np.array(j[key]), atol=TOL)
        else:
            assert t[key] == j[key], key
    assert len(t["coordinates"]) == (max_points or 180)
    assert tproj.generate_visualization(TIndex(embed_dim=16, device="cpu"), TStore(), device="cpu") is None
    png = tproj.render_scatter(t, tmp_path / "scatter.png")
    assert png is None or (tmp_path / "scatter.png").stat().st_size > 0
