"""Kernel K4 of the PyTorch port (the fused streaming top-k) against the JAX
package.

On the CPU ``ops.retrieval.fused_topk`` takes its plain PyTorch version,
which is held to ``evr_tpu.ops.retrieval_pallas.fused_topk`` run in
interpret mode on the same index, queries, row range and k: the rows must
be equal, the scores within 1e-5 (fp32 rows) or 1e-3 (int8 and bf16 rows,
whose scores both sides take from bf16 operands with fp32 sums in another
order). ``FrameIndex(search_impl="pallas")`` is held to the JAX index of the
same name. The CUDA kernel itself is compared with the plain version on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.index import FrameIndex as JFrameIndex
from evr_tpu.ops.retrieval_pallas import fused_topk as jfused_topk
from evr_tpu_torch.index import FrameIndex as TFrameIndex
from evr_tpu_torch.ops import retrieval
from evr_tpu_torch.ops.topk import cosine_topk
from evr_tpu_torch.parallel import get_mesh

SCORE_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "int8": 1e-3}
N, D, Q = 3072, 64, 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    idx = rng.normal(size=(N, D)).astype(np.float32)
    idx[200:240] = idx[200]  # a block of duplicated rows: ties
    idx /= np.linalg.norm(idx, axis=1, keepdims=True)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    q[1] = idx[200] * 3.0  # a query whose best rows are the tied block
    scales = (np.abs(idx).max(axis=1) / 127.0).astype(np.float32)
    qi = np.clip(np.round(idx / scales[:, None]), -127, 127).astype(np.int8)
    return idx, q, scales, qi


def _index(data, dtype):
    idx, _, scales, qi = data
    if dtype == "int8":
        return jnp.asarray(qi), torch.from_numpy(qi), jnp.asarray(scales), torch.from_numpy(scales)
    if dtype == "bfloat16":
        return jnp.asarray(idx).astype(jnp.bfloat16), torch.from_numpy(idx).bfloat16(), None, None
    return jnp.asarray(idx), torch.from_numpy(idx), None, None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,start,end", [(7, 3, 2900), (1100, 150, 3070)])
def test_plain_matches_jax_kernel(data, dtype, k, start, end):
    """Q = 5; the second case asks for more rows than a tile holds (k > 1024
    tile rows) over a sub-range that does not start at 0."""
    _, q, _, _ = data
    jidx, tidx, jsc, tsc = _index(data, dtype)
    ref_s, ref_r = jfused_topk(jidx, jnp.asarray(q), jnp.int32(start), jnp.int32(end), k,
                               row_scales=jsc, tile_n=1024, interpret=True)
    before = retrieval.fused_topk.launches
    got_s, got_r = retrieval.fused_topk(tidx, torch.from_numpy(q), start, end, k, row_scales=tsc)
    assert retrieval.fused_topk.launches == before  # CPU tensor: no kernel launch
    assert got_r.dtype == torch.int64 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=SCORE_TOL[dtype], rtol=0)
    assert got_r.min() >= start and got_r.max() < end
    # the tied block comes back lowest row first
    tied = got_r[1][(got_r[1] >= 200) & (got_r[1] < 240)].numpy()
    assert np.array_equal(tied, np.sort(tied)) and len(tied) == min(k, 40)


def test_plain_takes_a_ragged_row_count(data):
    """Any row count: 2,500 rows are two full tiles and a ragged one; the
    result equals the GEMM-and-sort search on fp32 rows."""
    idx, q, _, _ = data
    t = torch.from_numpy(idx[:2500])
    for k in (1, 30, 600):
        got_s, got_r = retrieval.fused_topk(t, torch.from_numpy(q), 0, 2500, k)
        ref_s, ref_r = cosine_topk(t, torch.from_numpy(q), 0, 2500, k)
        np.testing.assert_array_equal(got_r.numpy(), ref_r.numpy())
        np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_frameindex_pallas_matches_jax(dtype):
    """``FrameIndex(search_impl="pallas")`` with ``pad_multiple=1024``
    against the JAX index (``tests/test_pallas.py`` holds the JAX one to its
    XLA search), over the whole index and one video's rows."""
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(700, 64)).astype(np.float32)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    jix = JFrameIndex(embed_dim=64, pad_multiple=1024, device_dtype=dtype, search_impl="pallas")
    tix = TFrameIndex(embed_dim=64, pad_multiple=1024, device_dtype=dtype, search_impl="pallas",
                      device="cpu")
    for ix in (jix, tix):
        ix.add_video("a", emb[:400])
        ix.add_video("b", emb[400:])
    for video, k in ((None, 7), ("b", 5)):
        s1, r1 = jix.search_raw(q, k, video_name=video)
        s2, r2 = tix.search_raw(q, k, video_name=video)
        np.testing.assert_array_equal(r2, r1)
        np.testing.assert_allclose(s2, s1, atol=SCORE_TOL[dtype], rtol=0)
    # and the port's two search implementations agree
    xla = TFrameIndex(embed_dim=64, pad_multiple=1024, device_dtype=dtype, device="cpu")
    xla.add_video("a", emb[:400])
    xla.add_video("b", emb[400:])
    np.testing.assert_array_equal(xla.search_raw(q, 9)[1], tix.search_raw(q, 9)[1])


def test_search_impl_values():
    ix = TFrameIndex(embed_dim=8, search_impl="pallas", device="cpu")
    assert ix.search_impl == "pallas" and ix.pad_multiple == 1024
    assert TFrameIndex(embed_dim=8, device="cpu").search_impl == "xla"
    # the ANN tiers construct and search, on one device and under a mesh
    emb = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    for impl in ("ivf", "ivfpq"):
        ann = TFrameIndex(embed_dim=8, search_impl=impl, ivf_clusters=4, ivf_nprobe=4,
                          device="cpu")
        ann.add_video("v", emb)
        s, r = ann.search_raw(emb[:2], 3)
        assert r.shape == (2, 3) and (r[:, 0] == [0, 1]).all() and np.isfinite(s).all()
        sharded = TFrameIndex(embed_dim=8, search_impl=impl, ivf_clusters=4, ivf_nprobe=4,
                              mesh=get_mesh(2, device="cpu"))
        sharded.add_video("v", emb)
        assert (sharded.search_raw(emb[:2], 3)[1][:, 0] == [0, 1]).all()
    with pytest.raises(ValueError, match="unknown search_impl"):
        TFrameIndex(embed_dim=8, search_impl="faiss", device="cpu")
    # rows are padded to pad_multiple with 25% headroom
    small = TFrameIndex(embed_dim=8, pad_multiple=64, device="cpu")
    small.add_video("v", np.ones((60, 8), np.float32))
    small.build()
    assert small._device_index.shape[0] == 128


def test_topk_inputs_are_checked_before_launch(data):
    """k, the row range, the scales' shape and the index's dtype are checked
    before any launch, on every device."""
    idx, q, scales, qi = data
    t, tq = torch.from_numpy(idx), torch.from_numpy(q)
    with pytest.raises(ValueError, match="k=0"):
        retrieval.fused_topk(t, tq, 0, N, 0)
    with pytest.raises(ValueError, match="k=3073"):
        retrieval.fused_topk(t, tq, 0, N, N + 1)
    with pytest.raises(ValueError, match="row range"):
        retrieval.fused_topk(t, tq, 10, N + 1, 5)
    with pytest.raises(ValueError, match="row_scales"):
        retrieval.fused_topk(torch.from_numpy(qi), tq, 0, N, 5, torch.from_numpy(scales[:-1]))
    with pytest.raises(ValueError, match="dtype torch.float16"):
        retrieval.fused_topk(t.half(), tq, 0, N, 5)
    # what only the kernel reads through raw pointers, checked before a launch
    retrieval._check_kernel_inputs(t, tq, None)
    with pytest.raises(ValueError, match="contiguous"):
        retrieval._check_kernel_inputs(t.T.contiguous().T, tq, None)
    with pytest.raises(ValueError, match="width 24"):
        retrieval._check_kernel_inputs(t[:, :24].contiguous(), tq[:, :24], None)
    with pytest.raises(ValueError, match="queries of shape"):
        retrieval._check_kernel_inputs(t, tq[:, :32], None)
    with pytest.raises(ValueError, match="queries of shape"):
        retrieval._check_kernel_inputs(t, tq.to("meta"), None)
    with pytest.raises(ValueError, match="row_scales must be"):
        retrieval._check_kernel_inputs(torch.from_numpy(qi), tq, torch.from_numpy(scales).double())
