"""Kernel K7 of the PyTorch port (the PQ table-lookup scorer) against the JAX
package.

On the CPU ``ops.adc.adc_list_scores`` takes its plain PyTorch version, which
is held to ``evr_tpu.ops.adc_pallas.adc_list_scores`` run in interpret mode
(as ``tests/test_adc_pallas.py`` runs it) at rtol/atol 1e-6, every term being
one exact fp32 table read so that only the order of the sum over S differs,
and bit for bit to a numpy oracle that sums in the kernel's order. The CUDA
kernel itself is compared with the plain version on the card by
``chip_smoke.py``. On a CUDA tensor the wrapper
launches the kernel or raises, and the IVF-PQ search lets that error through
(the JAX package demotes the index to its "xla" path instead).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evr_tpu.ops.adc_pallas import adc_list_scores as jadc
from evr_tpu_torch.index import IVFPQIndex
from evr_tpu_torch.ops import adc

TOL = dict(rtol=1e-6, atol=1e-6)


def _case(seed, p, c, s, k, b):
    """Codes and tables; the tables' entries have standard deviation
    1/sqrt(S), so a row's sum has unit scale, as a unit query's ADC table
    sums do (their terms are q_s·c over the S subspaces)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, k, (p, c, s)).astype(np.uint8)
    tables = (rng.standard_normal((b, s, k)) / np.sqrt(s)).astype(np.float32)
    return blocks, tables


def _oracle(blocks, tables, nprobe):
    """The lookup summed over s in order from 0 in fp32, as the kernel sums."""
    p, c, s = blocks.shape
    owner = np.arange(p) // nprobe
    out = np.zeros((p, c), np.float32)
    for j in range(s):
        out = out + tables[owner[:, None], j, blocks[:, :, j].astype(np.int64)]
    return out


@pytest.mark.parametrize(
    "p,c,s,k,nprobe,chunk",
    [(6, 40, 8, 16, 2, 16), (4, 24, 8, 16, 2, 32), (3, 129, 20, 256, 3, 128), (8, 64, 64, 256, 1, 128)],
    ids=["oracle-shape", "ragged-C", "S-not-16", "S64-K256"],
)
def test_plain_matches_jax_kernel(p, c, s, k, nprobe, chunk):
    blocks, tables = _case(p * c, p, c, s, k, p // nprobe)
    want = np.asarray(jadc(jnp.asarray(blocks), jnp.asarray(tables), nprobe=nprobe, chunk=chunk,
                           interpret=True))
    got = adc.adc_list_scores(torch.from_numpy(blocks), torch.from_numpy(tables), nprobe, chunk=chunk)
    assert got.shape == (p, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version sums in the kernel's order: bit-equal to the oracle
    np.testing.assert_array_equal(got.numpy(), _oracle(blocks, tables, nprobe))


def test_fused_variant_gives_the_same_values():
    blocks, tables = _case(1, 4, 32, 8, 16, 2)
    jf = np.asarray(jadc(jnp.asarray(blocks), jnp.asarray(tables), nprobe=2, chunk=16, fused=True,
                         interpret=True))
    tb, tt = torch.from_numpy(blocks), torch.from_numpy(tables)
    got = adc.adc_list_scores(tb, tt, 2, chunk=16, fused=True)
    np.testing.assert_allclose(got.numpy(), jf, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, adc.adc_list_scores(tb, tt, 2, chunk=16, fused=False))


def test_shape_errors_and_kernel_limits():
    blocks = torch.zeros((4, 16, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"P=4 != B=3 \* nprobe=2"):
        adc.adc_list_scores(blocks, torch.zeros((3, 8, 16)), nprobe=2)
    with pytest.raises(ValueError, match="subspace mismatch"):
        adc.adc_list_scores(blocks, torch.zeros((2, 4, 16)), nprobe=2)
    # what the kernel takes is checked before a launch: a table above the
    # 227 KB of shared memory a block may hold is refused, never demoted
    with pytest.raises(ValueError, match="232448 bytes"):
        adc.check_kernel_inputs(torch.zeros((1, 4, 240), dtype=torch.uint8),
                                torch.zeros((1, 240, 256)))
    with pytest.raises(ValueError, match="uint8"):
        adc.check_kernel_inputs(blocks.int(), torch.zeros((2, 8, 16)))
    adc.check_kernel_inputs(torch.zeros((1, 4, 64), dtype=torch.uint8), torch.zeros((1, 64, 256)))


def test_cpu_calls_do_not_count_as_launches():
    blocks, tables = _case(2, 2, 16, 8, 16, 1)
    before = adc.adc_list_scores.launches
    adc.adc_list_scores(torch.from_numpy(blocks), torch.from_numpy(tables), 2)
    assert adc.adc_list_scores.launches == before


def test_kernel_failure_propagates_out_of_search(monkeypatch):
    """A call the wrapper dispatches to the card (``_on_card``) whose launch
    fails raises out of ``IVFPQIndex.search(adc_impl="pallas")``: no demotion
    to the gather-sum, and the index keeps no broken flag."""
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((600, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = IVFPQIndex().build_device(
        torch.from_numpy(emb), n_clusters=8, n_subspaces=8, n_centroids=16,
        coarse_iters=3, pq_iters=3, train_rows=600, slab_rows=600,
    )
    assert idx.packed
    q = emb[:3]
    ref = idx.search(q, 5, nprobe=8, adc_impl="xla")
    calls = []

    def failing_launch(codes_lists, list_ids, tables):
        calls.append((tuple(codes_lists.shape), tuple(list_ids.shape)))
        raise RuntimeError("adc_list_scores: CUDA launch failed with error code 1")

    monkeypatch.setattr(adc, "_on_card", lambda t: True)
    monkeypatch.setattr(adc, "_launch", failing_launch)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        idx.search(q, 5, nprobe=8, adc_impl="pallas")
    # the launch was handed the lists in place and the probed ids
    assert calls and calls[0] == ((idx.n_clusters, idx._capacity, 8), (3, 8))
    assert not hasattr(idx, "_pallas_broken")
    # the xla path is untouched by the failure
    np.testing.assert_array_equal(idx.search(q, 5, nprobe=8, adc_impl="xla")[1], ref[1])
