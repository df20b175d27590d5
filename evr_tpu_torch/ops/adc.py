"""ADC (product-quantisation table lookup) over probed lists: CUDA kernel K7.

Counterpart of ``evr_tpu/ops/adc_pallas.py`` (``adc_list_scores``), the
kernel of the packed IVF-PQ search with ``adc_impl="pallas"``. Two entries,
one kernel (``csrc/adc_list.cu``):

    adc_probe_scores(codes_lists [L, C, S], list_ids [B, n], tables [B, S, K])
        out[b, j, c] = sum_s tables[b, s, codes_lists[list_ids[b, j], c, s]]

reads each probed list where it lies in the index (the search's path), and
``adc_list_scores(blocks [P, C, S], tables, nprobe)``, the JAX signature, is
the case ``codes_lists = blocks``, ``list_ids = arange(P).view(B, nprobe)``.
Every term is one exact fp32 table read, so only the order of the sum over S
is free: the kernel and the plain versions both sum s = 0, 1, ..., S-1 in
order, from 0, and agree to the bit. Any ``C`` is taken (the ragged last tile
is masked). ``chunk`` and ``fused`` are the TPU wrapper's tiling and
MXU-matvec knobs; they are accepted for parity and do not change the values.

``adc_plan`` mirrors the kernel's plan (``make_plan`` in the source): the ring
walk (a TMA ring over the lists in place, for S of 32, 64, 96 or 128 and a
16-byte-aligned ``codes_lists``) or the direct walk (every other shape); both
take the tables code-major, [B, K, S]. A CUDA tensor launches the kernel or
raises, with no fallback; a CPU tensor takes the plain version. Every launch,
from either entry, adds one to ``adc_list_scores.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build
from .block_fused import refuse_grad

# shared memory a block may hold on sm_90 (227 KB); the direct walk stages
# one query's [S, K] fp32 table there
SMEM_LIMIT = MAX_TABLE_BYTES = 232448
SM_SHARED_BYTES = 233472  # shared memory of one SM
TARGET_BLOCKS = 132  # one block on each SM of an H100
WARPS = 8  # warps of a block
MAX_STAGES = 4  # ring stages a warp, at most
DIRECT_ROWS = 256  # rows of a direct-walk tile
RING_SUBSPACES = (32, 64, 96, 128)
DIRECT, RING = 0, 1


class AdcPlan(NamedTuple):
    """The kernel's plan of a call (``evr_adc_plan`` returns the same
    fields): the walk, the rows of each lane in a ring tile (tile rows 32 g),
    tiles of one list, tiles of each block's run, blocks, ring stages a warp
    and dynamic shared-memory bytes."""

    walk: int
    g: int
    tiles: int
    per: int
    grid: int
    stages: int
    smem: int


def _ring_smem(s: int, k: int, g: int, stages: int) -> int:
    return 4 * k * s + WARPS * stages * 32 * g * s + 8 * (WARPS * stages + 1)


@functools.lru_cache(maxsize=256)
def adc_plan(n_lists: int, c: int, s: int, k: int, p: int, aligned: bool = True) -> AdcPlan:
    """The plan of K7 for ``p`` probed lists of ``c`` rows of ``s`` codes
    out of ``n_lists``, ``k`` centroids; ``aligned``: the codes' base is
    16-byte aligned. The ring walk takes the largest g of 4, 2, 1 that gives
    every warp of the grid a tile (or g = 1) and fits two or more stages
    beside the table; any other shape takes the direct walk. Raises
    ``ValueError`` for a shape neither takes."""
    if min(n_lists, c, s, p) < 1 or not 1 <= k <= 256:
        raise ValueError(f"adc_plan: no plan for L={n_lists} C={c} S={s} K={k} P={p}")
    if s in RING_SUBSPACES and aligned:
        for g in (4, 2, 1):
            tiles = -(-c // (32 * g))
            total = p * tiles
            if g > 1 and total < TARGET_BLOCKS * WARPS:
                continue
            stages = next((st for st in range(MAX_STAGES, 1, -1)
                           if _ring_smem(s, k, g, st) <= SMEM_LIMIT), 0)
            if stages < 2 or total >= 2 ** 31:
                continue
            per = -(-total // TARGET_BLOCKS)
            return AdcPlan(RING, g, tiles, per, -(-total // per), stages, _ring_smem(s, k, g, stages))
    _check_table(s, k)
    table = 4 * s * k
    tiles = -(-c // DIRECT_ROWS)
    total = p * tiles
    if total >= 2 ** 31:
        raise ValueError(f"adc_plan: {total} tiles of {DIRECT_ROWS} rows exceed the kernel's int range")
    per_sm = max(1, min(8, SM_SHARED_BYTES // (table + 1024)))
    per = -(-total // (TARGET_BLOCKS * per_sm))
    return AdcPlan(DIRECT, 0, tiles, per, -(-total // per), 0, table)


def _check_shapes(blocks: torch.Tensor, tables: torch.Tensor, nprobe: int) -> None:
    if blocks.dim() != 3 or tables.dim() != 3:
        raise ValueError(
            f"adc_list_scores: blocks {tuple(blocks.shape)} must be [P, C, S] and "
            f"tables {tuple(tables.shape)} [B, S, K]"
        )
    p, _, s = blocks.shape
    b, s2, _ = tables.shape
    if s2 != s:
        raise ValueError(f"subspace mismatch: blocks S={s}, tables S={s2}")
    if p != b * nprobe:
        raise ValueError(f"P={p} != B={b} * nprobe={nprobe}")


def _check_probe_shapes(codes_lists: torch.Tensor, list_ids: torch.Tensor, tables: torch.Tensor) -> None:
    if codes_lists.dim() != 3 or list_ids.dim() != 2 or tables.dim() != 3:
        raise ValueError(
            f"adc_probe_scores: codes_lists {tuple(codes_lists.shape)} must be [L, C, S], list_ids "
            f"{tuple(list_ids.shape)} [B, n] and tables {tuple(tables.shape)} [B, S, K]"
        )
    if tables.shape[1] != codes_lists.shape[2]:
        raise ValueError(f"subspace mismatch: codes_lists S={codes_lists.shape[2]}, tables S={tables.shape[1]}")
    if list_ids.shape[0] != tables.shape[0]:
        raise ValueError(f"list_ids for B={list_ids.shape[0]} queries, tables for B={tables.shape[0]}")
    if list_ids.dtype.is_floating_point or list_ids.dtype == torch.bool:
        raise ValueError(f"adc_probe_scores: list_ids of dtype {list_ids.dtype} (integer ids)")


def _check_ids(list_ids: torch.Tensor, n_lists: int) -> None:
    """Every id in [0, L): out of range, the plain version would wrap (or
    index past the lists). On a CUDA tensor this reads the ids' range back,
    a synchronisation; the kernel checks CUDA ids itself."""
    if list_ids.numel() == 0:
        return
    lo, hi = torch.aminmax(list_ids)
    lo, hi = int(lo), int(hi)
    if lo < 0 or hi >= n_lists:
        raise ValueError(f"adc_probe_scores: list ids span [{lo}, {hi}], outside the {n_lists} lists [0, {n_lists})")


def check_kernel_inputs(codes: torch.Tensor, tables: torch.Tensor) -> None:
    """What the kernel reads through raw pointers: uint8 codes ([.., .., S]),
    fp32 tables on the same device, a table that fits in one block's shared
    memory, and K ≤ 256 (uint8 codes)."""
    s = codes.shape[2]
    k = tables.shape[2]
    if codes.dtype != torch.uint8:
        raise ValueError(f"adc_list_scores: blocks of dtype {codes.dtype} (the kernel takes uint8)")
    if tables.device != codes.device:
        raise ValueError(f"adc_list_scores: tables on {tables.device}, blocks on {codes.device}")
    if not 1 <= k <= 256:
        raise ValueError(f"adc_list_scores: K={k} centroids (uint8 codes take 1..256)")
    _check_table(s, k)


def _check_table(s: int, k: int) -> None:
    if s * k * 4 > MAX_TABLE_BYTES:
        raise ValueError(
            f"adc_list_scores: an [S={s}, K={k}] fp32 table is {s * k * 4} bytes, above the "
            f"{MAX_TABLE_BYTES} bytes (227 KB) of shared memory one block may hold"
        )


def adc_list_scores_plain(
    blocks: torch.Tensor,  # [P, C, S] uint8
    tables: torch.Tensor,  # [B, S, K] fp32
    nprobe: int,
    chunk: int = 128,
    fused: bool = False,
) -> torch.Tensor:
    """K7's function in plain PyTorch: [P, C] fp32, the sum over s taken in
    order from 0, one rounded add per term, as the kernel takes it."""
    _check_shapes(blocks, tables, nprobe)
    p, c, s = blocks.shape
    owner = torch.arange(p, device=blocks.device) // nprobe
    tq = tables.float()[owner]  # [P, S, K]
    acc = torch.zeros((p, c), dtype=torch.float32, device=blocks.device)
    for j in range(s):
        acc = acc + torch.gather(tq[:, j, :], 1, blocks[:, :, j].long())
    return acc


def adc_probe_scores_plain(codes_lists: torch.Tensor, list_ids: torch.Tensor,
                           tables: torch.Tensor) -> torch.Tensor:
    """K7 over lists in place, in plain PyTorch: the probed lists gathered
    ([B·n, C, S]) and scored by ``adc_list_scores_plain``; [B, n, C] fp32."""
    _check_probe_shapes(codes_lists, list_ids, tables)
    _check_ids(list_ids, codes_lists.shape[0])
    b, n = list_ids.shape
    _, c, s = codes_lists.shape
    blocks = codes_lists[list_ids.long()].view(b * n, c, s)
    return adc_list_scores_plain(blocks, tables, n).view(b, n, c)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _launch(codes_lists: torch.Tensor, list_ids: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One launch of K7 over ``list_ids`` [B, n] (each in [0, L): the
    kernel traps on another) of ``codes_lists`` [L, C, S]: [B, n, C] fp32.
    The tables go in code-major, [B, K, S]."""
    check_kernel_inputs(codes_lists, tables)
    codes_lists = codes_lists.contiguous()
    n_lists, c, s = codes_lists.shape
    b, n = list_ids.shape
    k = tables.shape[2]
    adc_plan(n_lists, c, s, k, b * n, codes_lists.data_ptr() % 16 == 0)  # refuses a shape neither walk takes
    ids = list_ids.to(device=codes_lists.device, dtype=torch.int64).contiguous()
    tables = tables.float().transpose(1, 2).contiguous()
    out = torch.empty((b, n, c), dtype=torch.float32, device=codes_lists.device)
    rc = build.load("adc_list").evr_adc_probe_scores(
        codes_lists.data_ptr(), n_lists, c, s, ids.data_ptr(), b, n, tables.data_ptr(), k,
        out.data_ptr(), torch.cuda.current_stream(codes_lists.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"adc_list_scores: CUDA launch failed with error code {rc}")
    adc_list_scores.launches += 1
    return out


def adc_probe_scores(
    codes_lists: torch.Tensor,  # [L, C, S] uint8: the index's lists
    list_ids: torch.Tensor,  # [B, n] integer: each query's probed lists
    tables: torch.Tensor,  # [B, S, K] fp32 per-query ADC tables
) -> torch.Tensor:
    """Residual ADC scores [B, n, C] fp32 of each query's probed lists,
    read where they lie: kernel K7 on a CUDA tensor, the plain version on a
    CPU one. Ids outside [0, L) raise ``ValueError`` when they lie on the
    CPU; CUDA ids are not read back (no synchronisation): the kernel traps
    on one out of range, a device fault raised at the next synchronisation,
    as torch's own indexing asserts on the card."""
    refuse_grad("adc_probe_scores", tables)
    _check_probe_shapes(codes_lists, list_ids, tables)
    if not list_ids.is_cuda:
        _check_ids(list_ids, codes_lists.shape[0])
    if not _on_card(codes_lists):
        return adc_probe_scores_plain(codes_lists, list_ids, tables)
    return _launch(codes_lists, list_ids, tables)


def adc_list_scores(
    blocks: torch.Tensor,  # [P, C, S] uint8, P = B * nprobe probed code blocks
    tables: torch.Tensor,  # [B, S, K] fp32 per-query ADC tables
    nprobe: int,
    chunk: int = 128,
    fused: bool = False,
) -> torch.Tensor:
    """Residual ADC scores [P, C] fp32 of each probed block against its
    owning query's table (block p belongs to query p // nprobe): kernel K7 on
    a CUDA tensor, the plain version on a CPU one."""
    refuse_grad("adc_list_scores", tables)
    _check_shapes(blocks, tables, nprobe)
    if not _on_card(blocks):
        return adc_list_scores_plain(blocks, tables, nprobe, chunk, fused)
    p, c, _ = blocks.shape
    ids = torch.arange(p, device=blocks.device).view(p // nprobe, nprobe)
    return _launch(blocks, ids, tables).view(p, c)


adc_list_scores.launches = 0


def adc_bytes(lists: int, c: int, s: int, k: int, b: int, p: int) -> int:
    """Bytes K7 must move at least for ``p`` probed lists of ``b`` queries:
    the codes of the ``lists`` distinct ones read once, the tables read
    once, the scores written once."""
    return lists * c * s + b * s * k * 4 + p * c * 4

