"""The IVF-PQ tier of the PyTorch port (``evr_tpu_torch.index.ivfpq``) against
the JAX package's (``evr_tpu.index.ivfpq``).

k-means inits differ between the packages, so whole indexes cross through the
shared ``.npz`` layout. A JAX index of every layout (``build``; ``build_device``
packed, unpacked and with OPQ; ``build_device_streamed``, paired) is loaded by
the port and searched with ``adc_impl="xla"`` and ``"pallas"`` (kernel K7's
plain version on the CPU; JAX's Pallas kernel in interpret mode), with and
without re-rank (fp32 originals or the int8 host store): rows equal to JAX's,
scores within 1e-5 (ADC tables and residual sums differ only in the order of
their fp32 sums). A port-built index is searched by JAX with the same rows.
Also held: the pool's reconstruction against its ADC decomposition (as
``tests/test_adc_pallas.py`` holds JAX's), the host store's exact re-rank at
a full probe, appends past the pool against JAX's, a seeded build repeating
exactly, and every row living in exactly one place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.index.ivfpq import IVFPQIndex as JIVFPQ
from evr_tpu_torch.index import IVFPQIndex

TOL = dict(rtol=1e-5, atol=1e-5)
N, D = 2000, 32


def _normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31)
    centers = _normed(rng.standard_normal((16, D)))
    emb = _normed(centers[rng.integers(0, 16, N)] + 0.2 * rng.standard_normal((N, D)))
    q = _normed(emb[rng.integers(0, N, 5)] + 0.05 * rng.standard_normal((5, D)))
    scales = np.maximum(np.abs(emb).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    rows8 = np.clip(np.round(emb / scales[:, None]), -127, 127).astype(np.int8)
    return emb, q, rows8, scales


KW = dict(n_clusters=16, n_subspaces=8, n_centroids=32, coarse_iters=4, pq_iters=4)
DEV_KW = dict(KW, train_rows=N, slab_rows=700, capacity_factor=1.05)


def _jax_index(layout, emb):
    x = jnp.asarray(emb)
    if layout == "build":
        return JIVFPQ().build(emb, capacity_factor=1.1, **KW)
    if layout == "streamed":
        return JIVFPQ().build_device_streamed(
            lambda s, m: x[s : s + m], len(emb), D, slab_rows=700, assign_sub_rows=300,
            capacity_factor=1.05, **KW)
    return JIVFPQ().build_device(x, packed=layout != "device-unpacked",
                                 opq_iters=2 if layout == "device-opq" else 0, **DEV_KW)


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("layout", ["build", "device-packed", "device-unpacked", "device-opq",
                                    "streamed"])
def test_port_searches_a_jax_built_index(layout, corpus, tmp_path):
    emb, q, rows8, scales = corpus
    jidx = _jax_index(layout, emb)
    assert int(jidx.overflow.shape[0]) > 0  # a tight capacity: a real pool
    jidx.save(tmp_path / "j.npz")
    tidx = IVFPQIndex.load(tmp_path / "j.npz", device="cpu")
    assert (tidx.packed, tidx._paired, tidx.n_rows) == (jidx.packed, jidx._paired, jidx.n_rows)
    if layout != "build":  # no originals kept: re-rank from the int8 host store
        jidx.attach_host_store(rows8, scales)
        tidx.attach_host_store(rows8, scales)
    for nprobe, rerank in ((2, None), (16, None), (4, 20)):
        want = jidx.search(q, 10, nprobe=nprobe, rerank=rerank, adc_impl="xla")
        _same(tidx.search(q, 10, nprobe=nprobe, rerank=rerank, adc_impl="xla"), want)
        _same(tidx.search(q, 10, nprobe=nprobe, rerank=rerank, adc_impl="pallas"), want)
    if tidx.packed:
        want = jidx.search(q, 10, nprobe=4, adc_impl="pallas")
        _same(tidx.search(q, 10, nprobe=4, adc_impl="pallas"), want)


def test_jax_searches_a_port_built_index(corpus, tmp_path):
    emb, q, _, _ = corpus
    x = torch.from_numpy(emb)
    built = {
        "build": IVFPQIndex().build(emb, capacity_factor=1.1, device="cpu", **KW),
        "packed": IVFPQIndex().build_device(x, opq_iters=2, **DEV_KW),
        "streamed": IVFPQIndex().build_device_streamed(
            lambda s, m: x[s : s + m], N, D, slab_rows=700, capacity_factor=1.05, **KW),
    }
    for name, idx in built.items():
        idx.save(tmp_path / f"{name}.npz")
        jidx = JIVFPQ.load(tmp_path / f"{name}.npz")
        for nprobe in (3, 16):
            _same(idx.search(q, 10, nprobe=nprobe, adc_impl="pallas"),
                  jidx.search(q, 10, nprobe=nprobe, adc_impl="xla"))
        if name == "build":
            _same(idx.search(q, 10, nprobe=4, rerank=30), jidx.search(q, 10, nprobe=4, rerank=30))


def test_pool_recon_equals_pool_adc(corpus):
    """q·recon of an overflow row equals its ADC decomposition q·c_assign +
    Σ_s q_s·book_s[code_s]."""
    emb, q, _, _ = corpus
    idx = IVFPQIndex().build_device(torch.from_numpy(emb), **dict(DEV_KW, capacity_factor=1.0))
    recon = idx._pool_recon().numpy()
    o = int(idx.overflow.shape[0])
    assert o > 0 and recon.shape == (o, D)
    books = idx.codebooks.numpy()
    s, _, ds = books.shape
    codes = idx.overflow_codes.numpy().astype(np.int64)
    tables = np.einsum("bsd,skd->bsk", q.reshape(len(q), s, ds), books)
    adc = q @ idx.centroids.numpy()[idx._overflow_assign.numpy()].T + np.stack(
        [tables[:, si, codes[:, si]] for si in range(s)]).sum(axis=0)
    np.testing.assert_allclose(q @ recon.T, adc, rtol=1e-4, atol=1e-5)


def test_host_store_rerank_is_exact_at_full_probe(corpus):
    emb, q, rows8, scales = corpus
    idx = IVFPQIndex().build(emb, capacity_factor=1.1, keep_originals=False, device="cpu", **KW)
    with pytest.raises(ValueError, match="attach_host_store"):
        idx.search(q, 5, nprobe=16, rerank=40)
    with pytest.raises(ValueError, match="int8"):
        idx.attach_host_store(rows8.astype(np.int16), scales)
    idx.attach_host_store(rows8, scales)
    s, r = idx.search(q, 10, nprobe=16, rerank=N)
    deq = rows8.astype(np.float32) * scales[:, None]
    exact = q @ deq.T
    want = np.argsort(-exact, axis=1)[:, :10]
    np.testing.assert_array_equal(r, want)
    np.testing.assert_allclose(s, np.take_along_axis(exact, want, 1), **TOL)


def test_append_past_the_pool_matches_jax(corpus, tmp_path):
    emb, q, _, _ = corpus
    # new rows near old ones but no near-duplicates: a pool row scored by its
    # reconstruction and a list row with the same codes scored by ADC differ
    # by fp32 rounding only, and such a near-tie may order either way
    new = _normed(emb[:200] + 0.15 * np.random.default_rng(4).standard_normal((200, D)))
    for layout in ("build", "device-packed"):
        jidx = _jax_index(layout, emb[:1800])
        jidx.save(tmp_path / "a.npz")
        tidx = IVFPQIndex.load(tmp_path / "a.npz", device="cpu")
        o0 = int(tidx.overflow.shape[0])
        recon0 = tidx._pool_recon() if tidx.packed else None
        np.testing.assert_array_equal(tidx.append(new), jidx.append(new))
        assert int(tidx.overflow.shape[0]) > o0  # the appended rows reached the pool
        if tidx.packed:
            assert tidx._pool_recon().shape[0] > recon0.shape[0]  # the cache follows the pool
        for nprobe in (2, 16):
            want = jidx.search(q, 10, nprobe=nprobe, adc_impl="xla")
            _same(tidx.search(q, 10, nprobe=nprobe, adc_impl="pallas"), want)
        _, rows = tidx.search(new[:6], 1, nprobe=16, rerank=None if tidx.packed else 20)
        assert (rows[:, 0] >= 1800).sum() >= 4  # appended rows find themselves


def test_seeded_build_repeats_and_rows_live_once(corpus):
    emb, q, _, _ = corpus
    x = torch.from_numpy(emb)
    a = IVFPQIndex().build_device(x, **DEV_KW)
    b = IVFPQIndex().build_device(x, **DEV_KW)
    assert torch.equal(a.codes_lists, b.codes_lists) and torch.equal(a.id_lists, b.id_lists)
    ids = a.id_lists.numpy()
    placed = np.concatenate([ids[ids >= 0], a.overflow.numpy()])
    np.testing.assert_array_equal(np.sort(placed), np.arange(N))
    assert a.overflow.shape[0] < 0.03 * N  # the spill keeps the pool small
    assert a._capacity % 8 == 0 and a.code_bytes == N * 8


def test_validation_and_paired_append(corpus):
    emb, q, _, _ = corpus
    with pytest.raises(ValueError, match="not divisible"):
        IVFPQIndex().build(emb, n_clusters=4, n_subspaces=5, device="cpu")
    with pytest.raises(ValueError, match="int8 x_dev and row_scales"):
        IVFPQIndex().build_device(torch.zeros((50, D), dtype=torch.int8), n_clusters=4,
                                  n_subspaces=8)
    with pytest.raises(ValueError, match="n_rows=10 < n_clusters=16"):
        IVFPQIndex().build_device_streamed(lambda s, m: None, 10, D, n_clusters=16, n_subspaces=8)
    with pytest.raises(ValueError, match="before build"):
        IVFPQIndex().search(q, 3, nprobe=1)
    x = torch.from_numpy(emb)
    paired = IVFPQIndex().build_device_streamed(lambda s, m: x[s : s + m], N, D, **KW)
    with pytest.raises(ValueError, match="unknown adc_impl"):
        paired.search(q, 3, nprobe=2, adc_impl="faiss")
    with pytest.raises(NotImplementedError, match="paired"):
        paired.append(emb[:4])
