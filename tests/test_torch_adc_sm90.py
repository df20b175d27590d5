"""K7 over probed lists read where they lie (``ops.adc.adc_probe_scores``),
its plan mirror, and the packed IVF-PQ search that hands it list ids.

On the CPU ``adc_probe_scores`` takes its plain version: the probed lists
gathered and scored by ``adc_list_scores_plain``. It is held to
``evr_tpu.ops.adc_pallas.adc_list_scores`` run in interpret mode on the same
gathered blocks at rtol/atol 1e-6 (every term one exact fp32 table read, so
only the order of the sum over S differs), and bit for bit to a numpy oracle
that sums in the kernel's order. ``adc_plan`` mirrors the kernel's choice of
walk (``make_plan`` in ``csrc/adc_list.cu``; ``chip_smoke.py`` and
``tools.adc_bench`` check the two agree on the card). The search's launches
are observed through a monkeypatched ``_launch`` (``_on_card`` forced), which
scores with the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops.adc_pallas import adc_list_scores as jadc
from evr_tpu_torch.index import IVFPQIndex, ivf
from evr_tpu_torch.ops import adc

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed, n_lists, c, s, k, ids):
    """Seeded codes [L, C, S] uint8, list ids [B, n] and tables [B, S, K]
    at 1/sqrt(S), a unit query's ADC table scale."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(ids, np.int64)
    codes = rng.integers(0, k, (n_lists, c, s)).astype(np.uint8)
    tables = (rng.standard_normal((ids.shape[0], s, k)) / np.sqrt(s)).astype(np.float32)
    return codes, ids, tables


def _oracle(codes, ids, tables):
    """Each probed row's lookup summed over s in order from 0 in fp32, as
    the kernel sums."""
    b, n = ids.shape
    blocks = codes[ids]  # [B, n, C, S]
    out = np.zeros(blocks.shape[:3], np.float32)
    for j in range(codes.shape[2]):
        out = out + np.take_along_axis(tables[:, None, j, :], blocks[..., j].reshape(b, n, -1).astype(np.int64),
                                       axis=2).reshape(out.shape)
    return out


CASES = {
    # repeated and unordered ids, several probes per query
    "repeated-unordered": (7, 20, 40, 8, 16, [[5, 2, 5, 19], [0, 19, 0, 3]]),
    # C off every tile size
    "ragged-C": (8, 6, 517, 32, 64, [[4, 1, 3], [2, 2, 5], [0, 5, 1]]),
    # the direct walk's shape (S % 16 != 0)
    "S-20-K-100": (9, 9, 129, 20, 100, [[8, 0, 4], [4, 4, 1]]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_probe_plain_matches_jax_kernel(name):
    seed, n_lists, c, s, k, ids = CASES[name]
    codes, ids, tables = _case(seed, n_lists, c, s, k, ids)
    b, n = ids.shape
    blocks = codes[ids].reshape(b * n, c, s)
    want = np.asarray(jadc(jnp.asarray(blocks), jnp.asarray(tables), nprobe=n, chunk=128, interpret=True))
    got = adc.adc_probe_scores(torch.from_numpy(codes), torch.from_numpy(ids), torch.from_numpy(tables))
    assert got.shape == (b, n, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(b * n, c), want, **TOL)


def test_probe_plain_bit_equal_to_oracle():
    for seed, (n_lists, c, s, k, ids) in enumerate([
        (12, 300, 64, 256, [[11, 3, 3, 7, 0], [1, 2, 3, 4, 5]]),
        (5, 77, 20, 100, [[4], [4], [0]]),
        (30, 65, 32, 16, [[29, 0, 15, 15, 2, 9]]),
    ]):
        codes, ids, tables = _case(seed, n_lists, c, s, k, ids)
        got = adc.adc_probe_scores_plain(torch.from_numpy(codes), torch.from_numpy(ids), torch.from_numpy(tables))
        np.testing.assert_array_equal(got.numpy(), _oracle(codes, ids, tables))
        # the JAX-signature entry on the gathered blocks gives the same bits
        b, n = ids.shape
        blocks = torch.from_numpy(codes[ids].reshape(b * n, c, s))
        assert torch.equal(adc.adc_list_scores(blocks, torch.from_numpy(tables), n), got.view(b * n, c))


def test_plan_takes_the_ring_or_the_direct_walk_by_shape():
    ring, direct = adc.RING, adc.DIRECT
    # the large tier's probe (B 8 x nprobe 32) and its full probe: four rows
    # a lane (tiles of 128), two stages a warp beside the 64 KB table
    p = adc.adc_plan(2048, 3072, 64, 256, 256)
    assert (p.walk, p.g, p.tiles, p.stages, p.grid) == (ring, 4, 24, 2, 131)
    assert p.per * p.grid >= 256 * 24 > p.per * (p.grid - 1)
    assert adc.adc_plan(2048, 3072, 64, 256, 8 * 2048)[:2] == (ring, 4)
    # one query (B 1 x 32): smaller tiles so every warp of the grid gets one
    p = adc.adc_plan(2048, 3072, 64, 256, 32)
    assert (p.walk, p.g, p.stages) == (ring, 2, 4) and p.tiles * 32 >= adc.TARGET_BLOCKS * adc.WARPS
    # S of 32, 96, 128 ride the ring; a 128 KB table leaves room for g = 1
    for s in (32, 96, 128):
        assert adc.adc_plan(64, 3072, s, 256, 8).walk == ring
    assert adc.adc_plan(64, 3072, 128, 256, 8)[:2] == (ring, 1)
    # S off the ring's set, or an unaligned base: the direct walk, 256-row tiles
    for s in (16, 20, 48, 8, 256):
        p = adc.adc_plan(9, 517, s, 100, 6)
        assert (p.walk, p.tiles, p.smem) == (direct, 3, 4 * s * 100)
    p = adc.adc_plan(2048, 3072, 64, 256, 256, aligned=False)
    assert (p.walk, p.tiles, p.smem) == (direct, 12, 65536)
    # every ring plan fits one block's shared memory with two or more stages
    for s in adc.RING_SUBSPACES:
        for k in (16, 100, 256):
            for p_lists in (1, 7, 256, 4096):
                p = adc.adc_plan(100, 1000, s, k, p_lists)
                assert p.walk == ring and 2 <= p.stages <= adc.MAX_STAGES and p.smem <= adc.SMEM_LIMIT
                assert p.per * p.grid >= p_lists * p.tiles and p.grid <= adc.TARGET_BLOCKS


def test_refusals_raise_before_any_library_loads(monkeypatch):
    def no_library(name):
        raise AssertionError(f"a library was loaded ({name}) for a call that must be refused")

    monkeypatch.setattr(adc.build, "load", no_library)
    monkeypatch.setattr(adc, "_on_card", lambda t: True)
    codes = torch.zeros((4, 16, 8), dtype=torch.uint8)
    tables = torch.zeros((2, 8, 16))
    for bad in ([[0, 4]], [[-1, 0]]):
        with pytest.raises(ValueError, match="outside the 4 lists"):
            adc.adc_probe_scores(codes, torch.tensor(bad * 2), tables)
    with pytest.raises(ValueError, match="uint8"):
        adc.adc_probe_scores(codes.int(), torch.tensor([[0], [1]]), tables)
    with pytest.raises(ValueError, match=r"K=300 centroids"):
        adc.adc_probe_scores(codes, torch.tensor([[0], [1]]), torch.zeros((2, 8, 300)))
    with pytest.raises(ValueError, match="232448 bytes"):
        adc.adc_probe_scores(torch.zeros((1, 4, 240), dtype=torch.uint8), torch.tensor([[0]]),
                             torch.zeros((1, 240, 256)))
    with pytest.raises(ValueError, match="232448 bytes"):
        adc.adc_plan(1, 4, 240, 256, 1)


def test_probe_shape_errors():
    codes = torch.zeros((4, 16, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="subspace mismatch"):
        adc.adc_probe_scores(codes, torch.tensor([[0]]), torch.zeros((1, 4, 16)))
    with pytest.raises(ValueError, match="B=2 queries, tables for B=1"):
        adc.adc_probe_scores(codes, torch.tensor([[0], [1]]), torch.zeros((1, 8, 16)))
    with pytest.raises(ValueError, match=r"must be \[L, C, S\]"):
        adc.adc_probe_scores(codes, torch.tensor([0, 1]), torch.zeros((1, 8, 16)))
    with pytest.raises(ValueError, match="integer ids"):
        adc.adc_probe_scores(codes, torch.tensor([[0.0]]), torch.zeros((1, 8, 16)))


def test_adc_list_scores_launches_over_arange_ids(monkeypatch):
    """The JAX-signature entry goes through the same launch: the blocks as
    lists, ids arange(P) viewed [B, nprobe]."""
    calls = []

    def recording(codes_lists, list_ids, tables):
        calls.append((codes_lists, list_ids.clone()))
        return adc.adc_probe_scores_plain(codes_lists, list_ids, tables)

    monkeypatch.setattr(adc, "_on_card", lambda t: True)
    monkeypatch.setattr(adc, "_launch", recording)
    codes, ids, tables = _case(3, 6, 40, 8, 16, [[0, 1, 2], [3, 4, 5]])
    blocks = torch.from_numpy(codes)
    got = adc.adc_list_scores(blocks, torch.from_numpy(tables), 3)
    assert len(calls) == 1 and calls[0][0] is blocks
    assert torch.equal(calls[0][1], torch.arange(6).view(2, 3))
    assert torch.equal(got, adc.adc_list_scores_plain(blocks, torch.from_numpy(tables), 3))


def _index(layout):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((700, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    kw = dict(n_clusters=8, n_subspaces=8, n_centroids=16, coarse_iters=3, pq_iters=3)
    if layout == "packed":
        idx = IVFPQIndex().build_device(torch.from_numpy(emb), train_rows=700, slab_rows=700, **kw)
    else:
        x = torch.from_numpy(emb)
        idx = IVFPQIndex().build_device_streamed(lambda s, m: x[s : s + m], 700, 32, train_rows=700,
                                                 slab_rows=300, assign_sub_rows=100, **kw)
    assert idx.packed and idx._paired == (layout == "paired")
    return idx, emb[:3]


@pytest.mark.parametrize("layout", ["packed", "paired"])
def test_search_hands_the_kernel_lists_in_place(layout, monkeypatch):
    """``search(adc_impl="pallas")`` launches K7 on ``codes_lists`` viewed
    [n_lists, C, S] (the index's own bytes, no gathered copy) with the
    probed list ids, one launch per chunk of probes; its rows are the "xla"
    search's."""
    idx, q = _index(layout)
    calls = []

    def recording(codes_lists, list_ids, tables):
        calls.append((codes_lists.shape, codes_lists.data_ptr(), list_ids.clone()))
        return adc.adc_probe_scores_plain(codes_lists, list_ids, tables)

    monkeypatch.setattr(adc, "_on_card", lambda t: True)
    monkeypatch.setattr(adc, "_launch", recording)
    got = idx.search(q, 5, nprobe=6, adc_impl="pallas")
    assert len(calls) == 1  # 6 probes of 3 queries: one chunk
    shape, ptr, ids = calls[0]
    assert shape == (idx.n_clusters, idx._capacity, 8) and ptr == idx.codes_lists.data_ptr()
    with torch.no_grad():
        cids = ivf.probe_lists(torch.from_numpy(q), idx.centroids, 6)[2]
    assert torch.equal(ids, cids)
    want = idx.search(q, 5, nprobe=6, adc_impl="xla")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_chunk_bound_counts_the_kernels_fp32_scores(monkeypatch):
    """A chunk holds ``ivf.CHUNK_BYTES`` at 17 bytes a probed row (K7's fp32
    scores [B, n, C], the rows' int32 ids, their mask, the fp32 sum and its
    masked copy): launches per search = ceil(nprobe / chunk_rows(17 B C)),
    every probe scored once."""
    idx, q = _index("packed")
    calls = []

    def recording(codes_lists, list_ids, tables):
        calls.append(list_ids.clone())
        return adc.adc_probe_scores_plain(codes_lists, list_ids, tables)

    monkeypatch.setattr(adc, "_on_card", lambda t: True)
    monkeypatch.setattr(adc, "_launch", recording)
    want = idx.search(q, 5, nprobe=7, adc_impl="pallas")
    assert len(calls) == 1
    # room for two probes' rows of 3 queries: 4 launches over 7 probes
    monkeypatch.setattr(ivf, "CHUNK_BYTES", 2 * 3 * idx._capacity * 17)
    calls.clear()
    got = idx.search(q, 5, nprobe=7, adc_impl="pallas")
    assert [c.shape[1] for c in calls] == [2, 2, 2, 1]
    with torch.no_grad():
        cids = ivf.probe_lists(torch.from_numpy(q), idx.centroids, 7)[2]
    assert torch.equal(torch.cat(calls, dim=1), cids)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
