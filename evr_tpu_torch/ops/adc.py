"""ADC (product-quantisation table lookup) over probed lists: CUDA kernel K7.

Counterpart of ``evr_tpu/ops/adc_pallas.py`` (``adc_list_scores``), the
kernel of the packed IVF-PQ search with ``adc_impl="pallas"``. For each probed
code block ``p`` of ``C`` rows and the ADC table of its query ``p // nprobe``:

    out[p, c] = sum_s tables[p // nprobe, s, blocks[p, c, s]]

Every term is one exact fp32 table read, so only the order of the sum over S
is free: the kernel (``csrc/adc_list.cu``) and its plain version
(``adc_list_scores_plain``) both sum s = 0, 1, ..., S-1 in order, from 0, and
agree to the bit. Any ``C`` is taken (the kernel masks the ragged last tile).
``chunk`` and ``fused`` are the TPU wrapper's tiling and MXU-matvec knobs;
they are accepted for parity and do not change the values.

A CUDA tensor launches the kernel or raises, with no fallback; a CPU tensor
takes the plain version. Every launch adds one to ``adc_list_scores.launches``.
"""

from __future__ import annotations

import torch

from . import build
from .block_fused import refuse_grad

# shared memory a block may hold on sm_90 (227 KB); the kernel stages one
# query's [S, K] fp32 table there
MAX_TABLE_BYTES = 232448


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


def check_kernel_inputs(blocks: torch.Tensor, tables: torch.Tensor) -> None:
    """What the kernel reads through raw pointers: uint8 codes, fp32 tables
    on the same device, a table that fits in one block's shared memory, and
    K ≤ 256 (uint8 codes)."""
    _, _, s = blocks.shape
    k = tables.shape[2]
    if blocks.dtype != torch.uint8:
        raise ValueError(f"adc_list_scores: blocks of dtype {blocks.dtype} (the kernel takes uint8)")
    if tables.device != blocks.device:
        raise ValueError(f"adc_list_scores: tables on {tables.device}, blocks on {blocks.device}")
    if not 1 <= k <= 256:
        raise ValueError(f"adc_list_scores: K={k} centroids (uint8 codes take 1..256)")
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


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _launch(blocks: torch.Tensor, tables: torch.Tensor, nprobe: int) -> torch.Tensor:
    check_kernel_inputs(blocks, tables)
    p, c, s = blocks.shape
    blocks = blocks.contiguous()
    tables = tables.float().contiguous()
    out = torch.empty((p, c), dtype=torch.float32, device=blocks.device)
    rc = build.load("adc_list").evr_adc_list_scores(
        blocks.data_ptr(), tables.data_ptr(), p, c, s, tables.shape[2], nprobe,
        out.data_ptr(), torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"adc_list_scores: CUDA launch failed with error code {rc}")
    adc_list_scores.launches += 1
    return out


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
    return _launch(blocks, tables, nprobe)


adc_list_scores.launches = 0
