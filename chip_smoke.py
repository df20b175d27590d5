#!/usr/bin/env python3
"""Drive the evr_tpu_torch port on one NVIDIA GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit; it imports neither JAX nor the ``evr_tpu``
package. Phases, each fatal on failure:

1. the card: name and power limit (``nvidia-smi``); TF32 off for matmuls and
   cuDNN, so fp32 comparisons are full fp32;
2. build: every kernel of the main paths compiled from ``ops/csrc``; the
   SASS of the K1, K2, K9, K5a and K5b libraries (``cuobjdump -sass``) must
   hold ``HGMMA`` instructions, the wgmma products of ``csrc/gemm_sm90.cuh``,
   and in the K6 and K1 libraries each function of the bf16 attention
   forward (``attn_sm90_kernel``, ``csrc/attn_sm90.cuh``, head dims 64 and
   80) must hold its own; ptxas's register and spill lines are printed;
3. the bf16 GEMM under K1, K2, K9 and K5 alone (``gemm_bf16``) at ViT-H-14's
   four vision GEMMs (65,792 rows), ViT-B/32's vision and text GEMMs, a
   ragged M and one tile, against ``torch.matmul`` in fp32 rounded once,
   and in K5's layouts (Aᵀ from a [K, M] array, Wᵀ from W's [in, out]
   array; bf16 or fp32 out) at the ten backward products of
   ViT-L/14@336px's training shape and its text shape, a ragged K and split
   weight gradients, against the fp32 product of the same inputs, each timed
   against ``torch.matmul`` on the same layout; then kernel parity: K1
   (``fused_attn_block``), K2 (``fused_mlp_block``), K3a
   and K3b (``fused_attn_block_q``, ``fused_mlp_block_q``: the int8 halves)
   against their plain PyTorch versions at the ViT-B/32 main-path shapes,
   vision (B=256, T=50, W=768, H=12) and text (B=16, T=77, W=512, H=8,
   causal) and a ragged batch (B=3, T=50, W=768: 150 rows, K1 and K2), in
   bfloat16 and float32; K1's attention core alone (``attn_forward``) at
   the vision, text, ViT-L/14@336px and ViT-H-14 shapes and at two key rows
   of 1,000 (head dims 64 and 80, one causal), bf16 and fp32; and K1, K2,
   K3a and K3b at the
   ViT-L/14@336px training shape (B=32, T=577, W=1024, H=16) and at
   ViT-H-14's vision shape (B=32, T=257, W=1280, H=16: head dim 80, exact
   GELU); K4 (``fused_topk``) against
   its plain version on 1,048,576 index rows of 512 in int8, bf16 and fp32;
   K5a and K5b (``fused_attn_block_bwd``, ``fused_mlp_block_bwd``: the block
   backward) against theirs at the training shape and at ViT-L/14's causal
   text shape (B=16, T=77, W=768, H=12), and K5a at head dim 80 (B=4,
   T=577, W=1280, H=16), bf16 and fp32, every output;
4. main path, bf16 weights: ``EmbeddingEngine("ViT-B/32", device="cuda")``
   with seeded random weights embeds 1,024 synthetic frames of four videos
   at batch 256, the data root is written, ``ServingContext`` boots from it
   and ``create_app`` answers /api/search requests; the launch counts of K1
   and K2 over that run, and the kernel path's embeddings and top-10
   rankings against the plain versions' on the same frames and queries;
5. main path, int8: the same with ``params_dtype="int8"`` (K3) and an int8
   index searched by K4 (``index_dtype="int8", search_impl="pallas"``); the
   launch counts of K3a, K3b and K4 and the calls of ``cosine_topk`` (none);
   then ``auto_params_dtype`` gates a float32 engine over that data root;
6. main path, training: ``python -m evr_tpu_torch.tools.finetune`` (its
   ``main``) fine-tunes ViT-L/14@336px at full width from seeded random
   weights on a synthetic caption set (96 train and 32 val images, batch
   32, bf16, one epoch: 3 steps and 1 validation batch); the launch counts
   of K1, K2, K5a and K5b (and none of the plain backward), finite losses,
   frozen leaves bit-unchanged and trainable ones moved in the final
   checkpoint; then one step from the same params and batch through the
   kernels and through their plain versions (``attn_impl="plain_grad"``),
   held together within bands that a gradient perturbed to cosine 0.99
   fails; the step time;
7. times: each kernel, its plain version and a PyTorch library computation
   of the same function, by CUDA events at the main-path shapes; K5a split
   into its attention backward alone (``attn_backward``), its five GEMMs and
   the rest; K1's attention core alone (``attn_forward``) at ViT-H-14,
   ViT-L/14@336px, ViT-B/32 vision and text shapes against SDPA; encode
   frames/s and the p50 of a text query, bf16 and int8;
8. the ANN tiers: K7 (``adc_list_scores``) against its plain version, bit
   for bit (phase 3); the bf16 data root of phase 4 served under
   ``search_impl="ivf"`` at a full probe (served events equal to the exact
   path's) and ``"ivfpq"`` with the int8 host store (the top-1 of perturbed
   corpus frames equal to the exact path's), each /api/search p50; then
   ``IVFPQIndex.build_device`` over 4,194,304 seeded clustered unit rows of
   512 (2,048 lists, S = 64, K = 256), built twice (identical codes),
   searched by 8 queries at nprobe 32 with ``adc_impl="pallas"`` (K7) and
   ``"xla"`` (same rows), recall@10 with and without an int8 re-rank of 50,
   the query p50 of both, K7's launches over those searches against the
   count expected, K7 on the search's own probed blocks, and K7's times;
   then ``tools.index_tool`` ``build --streamed --host-store`` and
   ``query`` over a 262,144-row ``.npy``, its rows equal to a direct search;
9. the flash route: K6 (``flash_attention``: K6a ``flash_attention_full``,
   K6b ``flash_attention_blocked``) against its plain version at ViT-H-14's
   vision (B=256, H=16, T=257, d=80) and causal text (B=16, T=77, d=64)
   shapes, ViT-B/32's vision shape (T=50) and the padded route of an
   explicit ``block_q`` (B=32, T=257), bf16 and fp32 (phase 3); then
   ``EmbeddingEngine(cfg=get_model_config("ViT-H-14", attn_impl="flash"))``
   with seeded random weights serves the path of phase 4 (K6a 31 launches
   per encode batch, K6b 23 per text encode, K1 and K2 none; embeddings and
   rankings against ``attn_impl="flash_plain"``); the same weights train
   three ``make_train_step`` steps (batch 32, bf16, ``freeze_layers=8``): K6
   in every block's forward, the plain recompute backward, frozen leaves
   unchanged, a K6 step against a plain step within bands; K6's times; and
   the served path again with int8 block linears under "flash" (K6 launches
   as before, no K1-K3), unit embeddings and rankings against
   ``"flash_plain"`` within the int8 bands;
10. ViT-H-14 under its default configuration: ``EmbeddingEngine("ViT-H-14",
   params=..., device="cuda")`` with no ``cfg`` (``attn_impl="auto"``) serves
   the path of phase 4 through K1 and K2 at head dim 80 (vision, T=257,
   W=1280, exact GELU) and 64 (text), 31 launches of each per encode batch
   and 23 per text encode, K6 none, against ``attn_impl="plain"``; then with
   int8 weights through K3a and K3b, against the int8 plain route (phase 3
   holds K1, K2, K3a and K3b to their plain versions at that vision shape,
   and K5a at head dim 80, T=577; phase 7 times them there);
11. the exported ops no tower calls, as in the JAX package: K8
   (``ops.fused_layer_norm``) on 12,800 x 768, 65,792 x 1280 and 1,000 x 100
   rows, bf16 and fp32, with and without the quickGELU tail, against its
   plain version, timed against ``F.layer_norm``; K9
   (``ops.block_fused.fused_block_merged``) at ViT-B/32's vision and text
   shapes and ViT-H-14's vision shape, bf16 and fp32, bit-equal to
   ``fused_block_apply`` (K1 then K2), timed at each of those shapes
   against that pair, its plain version and the library composition. Their
   launches are counted over their own phases.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, same sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same sheet
H100_BYTES_PER_S = 3.35e12

VISION = dict(B=256, T=50, W=768, H=12, causal=False)
TEXT = dict(B=16, T=77, W=512, H=8, causal=True)
# ViT-L/14@336px at the training batch: its vision tower, which trains through
# K1/K2 and K5a/K5b, and its (causal) text tower
VITL = dict(B=32, T=577, W=1024, H=16, causal=False)
VITL_TEXT = dict(B=16, T=77, W=768, H=12, causal=True)
# ViT-H-14's vision tower (16 heads of 80, exact GELU), the widest the fused
# route takes: K1-K3 parity at a batch cut to 32 (VITH), their times at the
# serving batch (VITH_SERVE), and K5a's parity at head dim 80 and T = 577 at
# the kernel level (VITH_BWD: no registry tower with head dim 80 trains at
# T >= 512, where the fused backward runs)
VITH = dict(B=32, T=257, W=1280, H=16, causal=False, act="gelu")
VITH_SERVE = dict(VITH, B=256)
VITH_BWD = dict(B=4, T=577, W=1280, H=16, causal=False)
# A ragged row count for K1 and K2 (150 rows: one full 128-row GEMM tile and
# a part-filled one)
RAGGED = dict(B=3, T=50, W=768, H=12, causal=False)
# The bf16 GEMM under K1, K2 and K9 alone: ViT-H-14's four vision GEMMs at
# the serving batch (256 x 257 rows), ViT-B/32's vision (256 x 50 rows) and
# text (16 x 77 rows) GEMMs, a ragged M and a single 128 x 256 x 64 tile, as
# (M, N, K). Against the fp32 product of the same bf16 inputs plus the bias,
# rounded once: the two fp32 sums differ only in their order, by far less
# than a bf16 step, so a rounded output may move by one bf16 step at its own
# magnitude; the band is GEMM_TOL_STEPS bf16 steps at the output's largest
# magnitude.
GEMM_SHAPES = {
    "vith-qkv": (65792, 3840, 1280), "vith-out": (65792, 1280, 1280),
    "vith-fc": (65792, 5120, 1280), "vith-proj": (65792, 1280, 5120),
    "vitb-qkv": (12800, 2304, 768), "vitb-out": (12800, 768, 768),
    "vitb-fc": (12800, 3072, 768), "vitb-proj": (12800, 768, 3072),
    "text-qkv": (1232, 1536, 512), "text-out": (1232, 512, 512),
    "text-fc": (1232, 2048, 512), "text-proj": (1232, 512, 2048),
    "ragged": (150, 768, 768), "one-tile": (128, 256, 64),
}
GEMM_TOL_STEPS = 1
# The same GEMM in the layouts and outputs of K5's ten products, as (M, N,
# K, a_t, w_t, out_dtype, bias): aᵀ read from a [K, M] array for the weight
# gradients, wᵀ from W's [in, out] array for the input gradients. At
# ViT-L/14@336px's training shape (18,464 rows, W 1,024, hidden 4,096) and
# its causal text shape (1,232 rows, W 768, hidden 3,072), a ragged K below
# one 64-row step, and a weight gradient split into four slices of rows
# (dW_out at W 1,024: 32 output tiles; it is timed in one pass too). K5b's
# two activation epilogues are run here in their layouts with
# the plain bf16 output (h_pre: the forward layout; dh: wᵀ); K5b's parity
# checks the epilogues themselves. Against the fp32 product of the same bf16
# inputs (torch.matmul on the transposed views): bf16 outputs within
# GEMM_TOL_STEPS bf16 steps as above; fp32 outputs within BWD_GEMM_F32_REL
# of the output's largest entry. Only the order of the fp32 sums differs
# (over up to 18,464 rows, and the slice order of a split): the largest such
# error was 2.47e-5 (dW_proj at the training shape, one pass over 18,464
# rows; 5.1e-6 for the split dW_out) in this script's run on an H100 80GB
# HBM3 (700 W), and the band is about twice that. Each run shows it
# rejecting an output whose largest entry moved by one bf16 step (about
# 6e-3 of it).
def _bwd_gemms(tag: str, R: int, W: int, hid: int) -> dict:
    bf, f32 = "bfloat16", "float32"
    return {
        f"{tag}-K5a-qkv": (R, 3 * W, W, False, False, bf, True),
        f"{tag}-K5a-do": (R, W, W, False, True, bf, False),
        f"{tag}-K5a-dW_qkv": (W, 3 * W, R, True, False, f32, False),
        f"{tag}-K5a-dy": (R, W, 3 * W, False, True, f32, False),
        f"{tag}-K5a-dW_out": (W, W, R, True, False, f32, False),
        f"{tag}-K5b-h_pre": (R, hid, W, False, False, bf, True),
        f"{tag}-K5b-dW_proj": (hid, W, R, True, False, f32, False),
        f"{tag}-K5b-dh": (R, hid, W, False, True, bf, False),
        f"{tag}-K5b-dW_fc": (W, hid, R, True, False, f32, False),
        f"{tag}-K5b-dy": (R, W, hid, False, True, f32, False),
    }


BWD_GEMM_SHAPES = {
    **_bwd_gemms("vitl", 32 * 577, 1024, 4096),
    **_bwd_gemms("text", 16 * 77, 768, 3072),
    "ragged-k": (256, 512, 40, True, False, "float32", False),
}
BWD_GEMM_F32_REL = 5e-5
# K1's attention core alone (``ops.block_fused.attn_forward``, no path calls
# it) on the packed qkv [B, T, 3W]: held to its plain version at the block
# halves' shapes (tolerances as for K1) and at two key rows longer than the
# kernel's resident k slots (T 1,000, head dims 64 and 80, one causal), so
# that k streams through both walks; timed at ATTN_CORE_TIMED against SDPA on
# q, k, v views of the same qkv
ATTN_CORE_SHAPES = {
    "vith": VITH_SERVE, "vitl": VITL, "vitb": VISION, "text": TEXT,
    "long-d64": dict(B=2, T=1000, W=512, H=8, causal=False),
    "long-d80": dict(B=2, T=1000, W=640, H=8, causal=True),
}
ATTN_CORE_TIMED = ("vith", "vitl", "vitb", "text")
# the libraries whose bf16 GEMMs run on csrc/gemm_sm90.cuh's wgmma kernel
HGMMA_LIBS = ("block_attn", "block_mlp", "block_merged", "block_attn_bwd", "block_mlp_bwd")
# the libraries whose bf16 attention forward runs on csrc/attn_sm90.cuh's
# wgmma kernel (K6; K1, and through it the core of K3a and K9), and that
# kernel's function name: its own SASS function must hold HGMMA instructions
ATTN_HGMMA_LIBS = ("flash_attn", "block_attn")
ATTN_KERNEL = "attn_sm90_kernel"
FP32_TOL = 2e-4  # max abs, fp32 kernel vs plain version (accumulation order only)
BF16_TOL = 3e-2  # max abs on unit-variance activations: about 2 bf16 ulps below 4
BF16_MIN_COS = 0.9999  # per output row, bf16
EMBED_MIN_COS = 0.999  # kernel-path vs plain-path frame embeddings, per row
# A frame may cross the top-10 cut between the kernel path and the plain
# path only where the plain path scores it this close to its own 10th score.
# Under one query vector the two frame paths' scores differed by at most
# 1.3e-3 on an H100 with this script (text queries; 2.7e-4 for frame
# queries): ONE_VECTOR_RANK_NOISE is about twice that. With each path's own
# text vectors, as /api/search ranks, they differed by up to 1.9e-3:
# SERVED_RANK_NOISE is about twice that.
ONE_VECTOR_RANK_NOISE = 2.5e-3
SERVED_RANK_NOISE = 4e-3
# K3 against its plain version. Both share every rounding point; a LayerNorm
# or head output that differs in its last bit (sums in another order) can
# move one activation across a quantisation step, which changes an output by
# one int8 step of that product: up to 3.5e-3 in fp32 in a probe run on an
# H100 (7.8e-3 / 1.6e-2 in bf16, one and two bf16 steps below 4). The limits
# are about three times that in fp32 and BF16_TOL in bf16.
INT8_FP32_TOL = 1e-2
INT8_MIN_COS = 0.99999  # per output row; the probe's worst was 0.999998
# The int8 main path's kernel-vs-plain ranking bands, chosen as the bf16
# ones were: about twice the largest score difference between the int8
# kernel path and the int8 plain path, which this script measured on an
# H100 as 2.05e-3 under one query vector (text queries; 4.7e-4 for frame
# queries) and 3.83e-3 with each path's own text vectors.
INT8_ONE_VECTOR_RANK_NOISE = 4e-3
INT8_SERVED_RANK_NOISE = 8e-3
# ViT-H-14 on int8 weights (the default route through K3, and "flash"): on
# random weights its 32 vision blocks leave the frame embeddings so alike
# that the int8 bands hold nearly every frame around each top-10 cut (all
# 1,024 for frame queries in a probe run on an H100 80GB HBM3 at 700 W), so
# the ranking check cannot reject anything there. These paths are held to a
# tighter row-cosine band instead: the int8 kernel path's unit rows against
# the plain path's were at least 0.999676 (text) and 0.999782 (frames) in
# that run, a gap of at most 3.2e-4; the band allows about twice that, and
# still rejects rows off by cosine 0.999.
VITH_INT8_MIN_COS = 0.99935
# K4 on an index of TOPK_ROWS x TOPK_DIM: rows must be equal; scores within
# 1e-5 (fp32 rows) or 1e-3 (int8/bf16), though the plain version sums in the
# kernel's order and so should agree to the bit.
TOPK_ROWS, TOPK_DIM = 1 << 20, 512
TOPK_SCORE_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "int8": 1e-3}
# K5a/K5b against their plain versions (cotangents of 0.01 x unit scale).
# fp32: only the order of sums differs; the largest error relative to the
# output's largest entry was 6.4e-6 (K5b's dW_proj at the ViT-L/14@336px
# vision shape, where each weight gradient sums 18,464 rows) in this
# script's run on an H100 80GB HBM3 (700 W). bf16: both round at the same
# points, so an output differs where a sum in another order rounds the
# other way: dx by one bf16 step (6.6e-3 of its largest entry), a parameter
# gradient by up to 8.1e-4 of its largest entry; every output's cosine was
# at least 0.999999 (per dx row, per gradient leaf). Each band is about
# twice the measurement.
BWD_FP32_REL = 1.5e-5
BWD_BF16_DX_REL = 1.6e-2  # two bf16 steps
BWD_BF16_GRAD_REL = 2e-3
BWD_MIN_COS = 0.999998
BWD_OUTPUTS = {
    "fused_attn_block_bwd": ("dx", "ln_1.scale", "ln_1.bias", "qkv.kernel", "qkv.bias",
                             "out.kernel", "out.bias"),
    "fused_mlp_block_bwd": ("dx", "ln_2.scale", "ln_2.bias", "fc.kernel", "fc.bias",
                            "proj.kernel", "proj.bias"),
}
TRAIN_MODEL, TRAIN_BATCH, N_TRAIN, N_VAL = "ViT-L/14@336px", 32, 96, 32
# One step from the same params and batch through the kernels (K1/K2,
# K5b/K5a on the vision tower) and through attn_impl="plain_grad" (their
# plain versions there, the composition on the text tower in both): bands on
# the relative differences of the loss and the gradient norm and on the
# least gradient-leaf cosine. This script measured on an H100 80GB HBM3
# (700 W), two runs alike: fp32 6.4e-8, 1.3e-7 and 0.9999998 over all 434
# trainable leaves; bf16 9.3e-5, 1.6e-3 and 0.99839 over the vision blocks'
# 286 leaves (0.9875 for the classifier's fc1, whose gradient is a
# near-cancelling sum over the batch). Each band is about twice the
# measurement; a gradient perturbed to cosine 0.99 must fail the leaf check.
STEP_FP32_BANDS = (1.5e-7, 3e-7, 0.9999995)
STEP_BF16_BANDS = (2e-4, 3e-3, 0.9968)
# K7 against its plain version: both sum each row over s in order, so they
# should agree to the bit; the band is 1e-6 of the output's largest entry.
ADC_REL_TOL = 1e-6
# The large IVF-PQ tier: ANN_ROWS unit rows of ANN_DIM (4,194,304 x 512 fp32,
# 8 GB: about 1,165 hours of video at one frame a second), ANN_CENTRES seeded
# centres with ANN_NOISE per dimension, 2,048 lists (capacity 1.5 x 2,048 =
# 3,072 rows), searched by ANN_B queries (corpus rows perturbed by a noise
# vector of norm ANN_QUERY_PERTURB) at nprobe ANN_NPROBE, timed over
# ANN_TIMED searches per impl.
ANN_ROWS, ANN_DIM, ANN_CENTRES, ANN_NOISE = 1 << 22, 512, 8192, 0.05
ANN_LISTS, ANN_CAPACITY, ANN_B, ANN_NPROBE, ANN_TIMED = 2048, 3072, 8, 32, 20
ANN_QUERY_PERTURB = 0.3
TOOL_ROWS = 1 << 18  # the .npy that tools.index_tool builds from
# Serving under the ANN tiers: at a full probe IVF scores the same rows as
# the exact path, in another order of sums (fp32): a served frame may differ
# only within ANN_FULL_PROBE_NOISE of the exact 10th score. IVF-PQ's top-1
# on corpus frames perturbed by noise of norm ANN_FRAME_PERTURB is the exact
# path's, or scored by the exact path within ANN_INT8_NOISE of its top-1
# (the int8 host store re-ranks: one quantisation step of a unit row moves a
# score by up to about 4e-3).
ANN_FULL_PROBE_NOISE = 1e-5
ANN_FRAME_PERTURB = 0.05
ANN_INT8_NOISE = 4e-3
# K6 (``ops.attention``) at the flash route's shapes: ViT-H-14's vision
# tower (K6a, head dim 80), ViT-B/32's vision tower under "flash" (K6a, the
# shape the TPU kernel packs four sequences to a tile), ViT-H-14's causal text
# tower (K6b) and the padded non-causal route that an explicit block_q takes
# (K6b). Inputs of unit variance; tolerances as for K1 (FP32_TOL, BF16_TOL,
# BF16_MIN_COS).
FLASH_SHAPES = {
    "vith-vision": dict(B=256, H=16, T=257, d=80, causal=False, block_q=None),
    "vitb-vision": dict(B=256, H=12, T=50, d=64, causal=False, block_q=None),
    "vith-text": dict(B=16, H=16, T=77, d=64, causal=True, block_q=None),
    "vith-vision-block_q": dict(B=32, H=16, T=257, d=80, causal=False, block_q=128),
}
# the shape each K6 route is timed and reported at: the ViT-H-14 main path's
FLASH_MAIN_SHAPE = {"flash_attention_full": "vith-vision", "flash_attention_blocked": "vith-text"}
# The flash route's main path: ViT-H-14 served and trained under
# attn_impl="flash" (FLASH_TRAIN_STEPS steps of make_train_step at batch
# TRAIN_BATCH). Its bands against the same path with K6's plain version,
# chosen as the bf16 ones were: about twice the largest difference this
# script measured on an H100 80GB HBM3 (700 W). Served scores differed by
# 1.27e-3 under one query vector (1.5e-4 for frame queries) and 1.74e-3 with
# each path's own text vectors, so the ViT-B/32 bands fit. A K6 step and a
# plain step from the same params and batch: fp32 0, 0 and a least leaf
# cosine of 0.9999998 over all 674 trainable leaves (STEP_FP32_BANDS fit);
# bf16 2.0e-4, 7.8e-3 and 0.99694 over the 662 block leaves of both towers.
# A gradient perturbed to cosine 0.99 must fail the leaf band.
FLASH_MODEL, FLASH_TRAIN_STEPS = "ViT-H-14", 3
FLASH_ONE_VECTOR_RANK_NOISE = ONE_VECTOR_RANK_NOISE
FLASH_SERVED_RANK_NOISE = SERVED_RANK_NOISE
FLASH_STEP_FP32_BANDS = STEP_FP32_BANDS
FLASH_STEP_BF16_BANDS = (4e-4, 1.6e-2, 0.9939)
# K8 (``ops.fused_layer_norm``) on the rows of the towers' LayerNorms:
# ViT-B/32's vision blocks at the serving batch (256 x 50 rows of 768),
# ViT-H-14's (256 x 257 rows of 1280), and a ragged case (1,000 rows of 100,
# not a multiple of 32 or 8); timed at ViT-H-14's rows. Tolerances as for K1.
LN_CASES = {"vitb-vision": (12800, 768), "vith-vision": (65792, 1280), "ragged": (1000, 100)}
LN_MAIN_CASE = "vith-vision"
# K9 (``fused_block_merged``) at ViT-B/32's vision and causal text shapes
# (quickGELU) and ViT-H-14's vision shape (head dim 80, exact GELU, the
# parity batch of VITH); bit-equal to fused_block_apply, and within the K1/K2
# tolerances of its plain version
MERGED_SHAPES = {"vision": VISION, "text": TEXT, "vith": VITH}
MODEL = "ViT-B/32"
N_FRAMES, N_VIDEOS, BATCH = 1024, 4, 256
N_FRAME_QUERIES = 8
QUERIES = (
    "a red car on a street", "people walking in a park", "a dog running",
    "a crowd at a concert", "a boat on the water", "text on a sign",
)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. the card -------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- shared helpers ----------------------------------------------------------


def block_params(torch, W: int, gen, device):
    """One residual block's fp32 parameters at CLIP's init scales."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    proj_std = W ** -0.5 * (2 * 12) ** -0.5
    return {
        "ln_1": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "attn": {
            "qkv": {"kernel": normal((W, 3 * W), W ** -0.5), "bias": normal((3 * W,), 0.02)},
            "out": {"kernel": normal((W, W), proj_std), "bias": normal((W,), 0.02)},
        },
        "ln_2": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "mlp": {
            "fc": {"kernel": normal((W, 4 * W), (2 * W) ** -0.5), "bias": normal((4 * W,), 0.02)},
            "proj": {"kernel": normal((4 * W, W), proj_std), "bias": normal((W,), 0.02)},
        },
    }


def unit_activations(torch, shape, gen, device):
    """Unit-variance activations, uniform on [-sqrt 3, sqrt 3]."""
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * math.sqrt(3.0)


def compare(torch, got, ref):
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    err = (g - r).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=-1).min().item()
    finite = bool(torch.isfinite(g).all().item())
    return err, cos, finite


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- 2. build ----------------------------------------------------------------


def sass_functions(sass: str) -> dict[str, int]:
    """HGMMA instructions per function of ``cuobjdump -sass`` output, split
    at each ``Function :`` header."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def phase_build():
    from evr_tpu_torch.ops import build

    t0 = time.perf_counter()
    times = build.build()
    total = time.perf_counter() - t0
    for name in build.KERNEL_SOURCES:
        path = build.library_path(name)
        check(path.exists(), f"{name}: no library after the build")
        report = path.with_suffix(".log")
        if report.exists():
            current = ""
            for line in report.read_text().splitlines():
                if "Compiling entry function" in line:
                    current = line.split("'")[1] if "'" in line else line
                if "spill" in line or "registers" in line or "C7515" in line:
                    tag = " (attention forward)" if ATTN_KERNEL in current else ""
                    log(f"  ptxas {name}{tag}: {line.strip()}")
    log(f"build: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"total {total:.1f} s (0 = already built)")
    # the bf16 GEMMs of K1, K2, K9 and K5 must be wgmma products in the binary,
    # and so must the bf16 attention forward in its own kernel function
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    counts, attn = {}, {}
    for name in sorted(set(HGMMA_LIBS) | set(ATTN_HGMMA_LIBS)):
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = sum("HGMMA" in line for line in sass.splitlines())
        if name in ATTN_HGMMA_LIBS:
            attn[name] = {f: n for f, n in sass_functions(sass).items() if ATTN_KERNEL in f}
    log(f"sass: HGMMA instructions per library {json.dumps(counts)}")
    log(f"sass: HGMMA instructions in each {ATTN_KERNEL} function {json.dumps(attn)}")
    for name in HGMMA_LIBS:
        check(counts[name] > 0, f"{name}: no HGMMA instruction in its SASS")
    for name in ATTN_HGMMA_LIBS:
        check(len(attn[name]) == 2, f"{name}: {len(attn[name])} {ATTN_KERNEL} functions, expected 2 (d 64, 80)")
        for f, n in attn[name].items():
            check(n > 0, f"{name}: no HGMMA instruction in {f}")


# -- 3. the GEMM alone, then kernel parity -----------------------------------


def phase_gemm(torch):
    """``gemm_bf16`` (the wgmma GEMM under K1, K2 and K9) at GEMM_SHAPES
    against ``gemm_bf16_plain`` (``torch.matmul`` in fp32, rounded once)
    within GEMM_TOL_STEPS bf16 steps, and timed against ``torch.matmul`` in
    bf16 by CUDA events."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    out = {}
    for tag, (M, N, K) in GEMM_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(14)
        a = unit_activations(torch, (M, K), gen, dev).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        b = (torch.randn((N,), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        before = bf.gemm_bf16.launches
        got = bf.gemm_bf16(a, w, b)
        torch.cuda.synchronize()
        check(bf.gemm_bf16.launches == before + 1, f"gemm_bf16 {tag}: the kernel did not launch")
        ref = bf.gemm_bf16_plain(a, w, b).float()
        err = (got.float() - ref).abs().max().item()
        band = GEMM_TOL_STEPS * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
        finite = bool(torch.isfinite(got.float()).all().item())
        ms = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, b)) for _ in range(2))
        lib_ms = min(cuda_ms(torch, lambda: torch.matmul(a, w)) for _ in range(2))
        flops = 2 * M * N * K
        bound = max(flops / H100_BF16_FLOPS, 2 * (M * K + K * N + N + M * N) / H100_BYTES_PER_S) * 1e3
        log(f"gemm_bf16 {tag} {M} x {N} x {K}: max_abs_err={err:.3e} (band {band:.3e}), kernel {ms:.4f} ms "
            f"{flops / ms / 1e9:.1f} TFLOP/s, torch.matmul {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s, "
            f"bound {bound:.4f} ms")
        check(finite and got.shape == (M, N), f"gemm_bf16 {tag}: {tuple(got.shape)}, finite {finite}")
        check(err <= band, f"gemm_bf16 {tag}: max abs err {err} > {band}")
        out[tag] = {"ms": ms, "library_ms": lib_ms, "tflops": flops / ms / 1e9, "flops": flops}
        del a, w, b, got, ref
    for tag, (M, N, K, a_t, w_t, out_name, has_bias) in BWD_GEMM_SHAPES.items():
        out[tag] = gemm_layout_case(torch, tag, M, N, K, a_t, w_t, getattr(torch, out_name), has_bias)
    return out


def gemm_layout_case(torch, tag, M, N, K, a_t, w_t, out_dtype, has_bias):
    """``gemm_bf16`` in one of K5's layouts against ``gemm_bf16_plain`` (the
    fp32 product of the same bf16 inputs), and timed against
    ``torch.matmul`` on the transposed views (bf16 out) by CUDA events."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    a = unit_activations(torch, (K, M) if a_t else (M, K), gen, dev).to(torch.bfloat16)
    w = (torch.randn((N, K) if w_t else (K, N), generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    b = (torch.randn((N,), generator=gen, device=dev) * 0.02).to(torch.bfloat16) if has_bias else None
    kw = dict(a_t=a_t, w_t=w_t, out_dtype=out_dtype)
    before = bf.gemm_bf16.launches
    got = bf.gemm_bf16(a, w, b, **kw)
    torch.cuda.synchronize()
    check(bf.gemm_bf16.launches == before + 1, f"gemm_bf16 {tag}: the kernel did not launch")
    ref = bf.gemm_bf16_plain(a, w, b, **kw).float()
    peak = ref.abs().max().item()
    err = (got.float() - ref).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all().item())
    check(finite and got.shape == (M, N) and got.dtype == out_dtype,
          f"gemm_bf16 {tag}: {got.dtype} {tuple(got.shape)}, finite {finite}")
    step = 2.0 ** (math.floor(math.log2(peak)) - 7)  # one bf16 step at the largest magnitude
    if out_dtype == torch.bfloat16:
        band = GEMM_TOL_STEPS * step
        verdict = f"max_abs_err={err:.3e} (band {band:.3e})"
        ok = err <= band
    else:
        rel = err / peak
        # the band must reject the output with its largest entry one bf16 step off
        moved = got.float().reshape(-1).clone()
        moved[int(ref.reshape(-1).abs().argmax().item())] += step
        moved_rel = (moved - ref.reshape(-1)).abs().max().item() / peak
        check(moved_rel > BWD_GEMM_F32_REL, f"gemm_bf16 {tag}: a one-step perturbation ({moved_rel}) passes")
        verdict = f"rel_err={rel:.3e} (band {BWD_GEMM_F32_REL:.1e}; one bf16 step off {moved_rel:.3e})"
        ok = rel <= BWD_GEMM_F32_REL
        del moved
    at, wt = (a.t() if a_t else a), (w.t() if w_t else w)
    ms = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, b, **kw)) for _ in range(2))
    lib_ms = min(cuda_ms(torch, lambda: torch.matmul(at, wt)) for _ in range(2))
    flops = 2 * M * N * K
    tiles = -(-M // 128) * (N // 256)
    splits = -(-K // bf.gemm_k_slice(M, N, K, a_t, w_t)) if out_dtype == torch.float32 else 1
    nbytes = 2 * (M * K + K * N) + out_dtype.itemsize * M * N
    bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
    log(f"gemm_bf16 {tag} {M} x {N} x {K} a_t={int(a_t)} w_t={int(w_t)} {str(out_dtype)[6:]} "
        f"({tiles} tiles x {splits} slices): {verdict}, kernel {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s, "
        f"torch.matmul {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} ms")
    check(ok, f"gemm_bf16 {tag}: outside its band ({verdict})")
    rec = {"ms": ms, "library_ms": lib_ms, "tflops": flops / ms / 1e9, "tiles": tiles, "flops": flops}
    if splits > 1:  # what the split buys: the same product in one pass over K
        one = bf.gemm_bf16(a, w, k_slice=K, **kw)
        one_rel = (one.float() - ref).abs().max().item() / peak
        check(one_rel <= BWD_GEMM_F32_REL, f"gemm_bf16 {tag} in one pass: relative err {one_rel}")
        rec["one_pass_ms"] = min(cuda_ms(torch, lambda: bf.gemm_bf16(a, w, k_slice=K, **kw)) for _ in range(2))
        log(f"gemm_bf16 {tag} in one pass over K ({tiles} tiles): rel_err={one_rel:.3e}, kernel "
            f"{rec['one_pass_ms']:.4f} ms {flops / rec['one_pass_ms'] / 1e9:.1f} TFLOP/s; the {splits} slices "
            f"{rec['one_pass_ms'] / ms:.2f}x faster")
    return rec


def phase_parity(torch):
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block": 0.0, "fused_mlp_block": 0.0}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("ragged", RAGGED), ("vitl", VITL),
                          ("vith", VITH)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            cast = lambda args: [a.to(dt) for a in args]  # noqa: E731
            for name, kern, plain, kw, args in (
                ("fused_attn_block", bf.fused_attn_block, bf.fused_attn_block_plain,
                 dict(n_heads=s["H"], causal=s["causal"]), attn_args),
                ("fused_mlp_block", bf.fused_mlp_block, bf.fused_mlp_block_plain,
                 dict(activation=s.get("act", "quick_gelu")), mlp_args),
            ):
                got = kern(x, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, *cast(args), **kw)
                err, cos, finite = compare(torch, got, ref)
                tag = f"{name} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                if dt == torch.float32:
                    check(err <= FP32_TOL, f"{tag}: max abs err {err} > {FP32_TOL}")
                else:
                    check(err <= BF16_TOL, f"{tag}: max abs err {err} > {BF16_TOL}")
                    check(cos >= BF16_MIN_COS, f"{tag}: row cosine {cos} < {BF16_MIN_COS}")
                    if shape_name == "vision":
                        worst[name] = max(worst[name], err)
        # GELU variant of K2 (OpenCLIP towers), checked at the vision width
        if shape_name == "vision":
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(dt)
                got = bf.fused_mlp_block(x, *mlp_args, activation="gelu")
                ref = bf.fused_mlp_block_plain(x, *[a.to(dt) for a in mlp_args], activation="gelu")
                err, cos, finite = compare(torch, got, ref)
                tag = f"fused_mlp_block gelu vision {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                tol = FP32_TOL if dt == torch.float32 else BF16_TOL
                check(err <= tol, f"{tag}: max abs err {err} > {tol}")
    return worst


def core_inputs(torch, s: dict, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return unit_activations(torch, (s["B"], s["T"], 3 * s["W"]), gen, "cuda")


def phase_parity_core(torch):
    """K1's attention core alone (``attn_forward``) against
    ``attn_forward_plain`` at ATTN_CORE_SHAPES, bf16 (the TMA + wgmma kernel
    of csrc/attn_sm90.cuh) and fp32 (flash.cuh's flash_fwd_kernel), one
    launch a call."""
    from evr_tpu_torch.ops import block_fused as bf

    worst = 0.0
    for tag, s in ATTN_CORE_SHAPES.items():
        qkv32 = core_inputs(torch, s, seed=10)
        for dt in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dt)
            before = bf.attn_forward.launches
            got = bf.attn_forward(qkv, s["H"], s["causal"])
            torch.cuda.synchronize()
            ref = bf.attn_forward_plain(qkv, s["H"], s["causal"])
            err, cos, finite = compare(torch, got, ref)
            name = f"attn_forward {tag} {str(dt).split('.')[-1]} (T {s['T']}, d {s['W'] // s['H']})"
            log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
            check(bf.attn_forward.launches == before + 1, f"{name}: not one launch")
            check(got.dtype == dt and got.shape == ref.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
            check(finite, f"{name}: non-finite output")
            if dt == torch.float32:
                check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
            else:
                check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
                check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
                worst = max(worst, err)
            del got, ref
    return worst


def bwd_compare(torch, got, ref, is_dx: bool):
    """(max abs err, err relative to ref's largest entry, cosine): per row
    (the least) for dx, over the whole leaf for a parameter gradient."""
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    rel = err / max(r.abs().max().item(), 1e-30)
    if is_dx:
        cos = torch.nn.functional.cosine_similarity(
            g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1]), dim=-1).min().item()
    else:
        cos = torch.nn.functional.cosine_similarity(g.reshape(1, -1), r.reshape(1, -1)).item()
    return err, rel, cos, bool(torch.isfinite(g).all().item())


def phase_parity_bwd(torch):
    """K5a and K5b against their plain versions at ViT-L/14@336px's training
    shapes, vision and causal text, bf16 and fp32, quickGELU; exact GELU
    for K5b at the vision shape; K5a at head dim 80 (VITH_BWD). Every
    output is checked."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block_bwd": 0.0, "fused_mlp_block_bwd": 0.0}
    for shape_name, s in (("vitl", VITL), ("vitl-text", VITL_TEXT), ("vith", VITH_BWD)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        g32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev) * 0.01
        cases = [("fused_attn_block_bwd", bf.fused_attn_block_bwd, bf.fused_attn_block_bwd_plain,
                  dict(n_heads=s["H"], causal=s["causal"]), attn_args)]
        if shape_name != "vith":  # K5a alone at head dim 80
            cases.append(("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                          dict(activation="quick_gelu"), mlp_args))
        if shape_name == "vitl":
            cases.append(("fused_mlp_block_bwd", bf.fused_mlp_block_bwd, bf.fused_mlp_block_bwd_plain,
                          dict(activation="gelu"), mlp_args))
        for dt in (torch.bfloat16, torch.float32):
            x, g = x32.to(dt), g32.to(dt)
            for name, kern, plain, kw, args in cases:
                got = kern(x, g, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, g, *[a.to(dt) for a in args], **kw)
                tag = f"{name} {kw.get('activation', '')} {shape_name} {str(dt).split('.')[-1]}"
                for out_name, u, v in zip(BWD_OUTPUTS[name], got, ref):
                    is_dx = out_name == "dx"
                    err, rel, cos, finite = bwd_compare(torch, u, v, is_dx)
                    log(f"parity {tag} {out_name}: max_abs_err={err:.3e} rel={rel:.3e} "
                        f"{'min_row_cos' if is_dx else 'leaf_cos'}={cos:.7f}")
                    check(finite, f"{tag} {out_name}: non-finite output")
                    check(u.dtype == (dt if is_dx else torch.float32), f"{tag} {out_name}: dtype {u.dtype}")
                    if dt == torch.float32:
                        check(rel <= BWD_FP32_REL, f"{tag} {out_name}: relative err {rel} > {BWD_FP32_REL}")
                    else:
                        tol = BWD_BF16_DX_REL if is_dx else BWD_BF16_GRAD_REL
                        check(rel <= tol, f"{tag} {out_name}: relative err {rel} > {tol}")
                        check(cos >= BWD_MIN_COS, f"{tag} {out_name}: cosine {cos} < {BWD_MIN_COS}")
                        if shape_name == "vitl":
                            worst[name] = max(worst[name], err)
                del got, ref
    return worst


def quantized_block(p):
    """A block's params with its four linears quantized (``models.quant``)."""
    from evr_tpu_torch.models.quant import quantize_linear_params

    return {**p,
            "attn": {n: quantize_linear_params(v) for n, v in p["attn"].items()},
            "mlp": {n: quantize_linear_params(v) for n, v in p["mlp"].items()}}


def phase_parity_int8(torch):
    """K3a and K3b against their plain versions, bf16 and fp32, at the
    serving shapes, at T = 577 (ViT-L/14@336px's vision tower), quickGELU,
    and at ViT-H-14's vision shape (head dim 80, exact GELU); exact GELU
    also at the ViT-B/32 vision width."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block_q": 0.0, "fused_mlp_block_q": 0.0}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("vitl", VITL), ("vith", VITH)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn, mlp = bf.quant_block_half_params(quantized_block(block_params(torch, s["W"], gen, dev)))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        cases = [("fused_attn_block_q", bf.fused_attn_block_q, bf.fused_attn_block_q_plain,
                  dict(n_heads=s["H"], causal=s["causal"]), attn),
                 ("fused_mlp_block_q", bf.fused_mlp_block_q, bf.fused_mlp_block_q_plain,
                  dict(activation=s.get("act", "quick_gelu")), mlp)]
        if shape_name == "vision":
            cases.append(("fused_mlp_block_q", bf.fused_mlp_block_q, bf.fused_mlp_block_q_plain,
                          dict(activation="gelu"), mlp))
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            for name, kern, plain, kw, args in cases:
                got = kern(x, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, *bf.cast_quant_args(dt, args), **kw)
                err, cos, finite = compare(torch, got, ref)
                tag = f"{name} {kw.get('activation', '')} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                tol = INT8_FP32_TOL if dt == torch.float32 else BF16_TOL
                check(err <= tol, f"{tag}: max abs err {err} > {tol}")
                check(cos >= INT8_MIN_COS, f"{tag}: row cosine {cos} < {INT8_MIN_COS}")
                if shape_name == "vision" and dt == torch.bfloat16:
                    worst[name] = max(worst[name], err)
    return worst


def topk_index(torch, dtype: str):
    """(index, row scales) of TOPK_ROWS seeded unit rows with a block of 64
    duplicated rows (ties), stored as ``FrameIndex`` stores ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((TOPK_ROWS, TOPK_DIM), generator=gen, device="cuda")
    emb[5000:5064] = emb[5000]
    emb = emb / emb.norm(dim=1, keepdim=True)
    if dtype == "int8":
        scales = (emb.abs().amax(1) / 127.0).clamp_min(1e-12)
        return torch.clamp(torch.round(emb / scales[:, None]), -127, 127).to(torch.int8), scales
    return emb.to(getattr(torch, dtype)), None


def phase_parity_topk(torch):
    """K4 against its plain version: Q in {1, 5, 32}, k in {1, 30, 300}, a
    row range that starts past 0 and ends before the last tile, a query on
    the tied block."""
    from evr_tpu_torch.ops.retrieval import fused_topk, fused_topk_plain

    worst, start, end = 0.0, 17, TOPK_ROWS - 4099
    for dtype in ("int8", "bfloat16", "float32"):
        index, scales = topk_index(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(4)
        for nq in (1, 5, 32):
            q = torch.randn((nq, TOPK_DIM), generator=gen, device="cuda")
            q[0] = index[5000].float()
            for k in (1, 30, 300):
                got_s, got_r = fused_topk(index, q, start, end, k, scales)
                torch.cuda.synchronize()
                ref_s, ref_r = fused_topk_plain(index, q, start, end, k, scales)
                err = (got_s - ref_s).abs().max().item()
                same = bool(torch.equal(got_r, ref_r))
                tag = f"fused_topk {dtype} Q={nq} k={k}"
                log(f"parity {tag}: rows equal {same}, max_abs_err={err:.3e}")
                check(same, f"{tag}: rows differ from the plain version")
                check(err <= TOPK_SCORE_TOL[dtype], f"{tag}: score err {err}")
                tied = got_r[0][(got_r[0] >= 5000) & (got_r[0] < 5064)]
                check(bool(torch.equal(tied, tied.sort().values)), f"{tag}: ties not lowest row first")
                worst = max(worst, err)
        del index, scales
    return worst


def flash_route(s: dict) -> str:
    from evr_tpu_torch.ops.attention import whole_sequence_route

    full = whole_sequence_route(s["T"], s["causal"], s["block_q"])
    return "flash_attention_full" if full else "flash_attention_blocked"


def flash_inputs(torch, s: dict, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (s["B"], s["H"], s["T"], s["d"])
    return [unit_activations(torch, shape, gen, "cuda") for _ in range(3)]


def phase_parity_flash(torch):
    """K6 (``flash_attention``) against its plain version at FLASH_SHAPES,
    bf16 and fp32, each through the route the JAX rule picks (one launch of
    that route's kernel per call)."""
    from evr_tpu_torch.ops import attention as fa

    worst = {"flash_attention_full": 0.0, "flash_attention_blocked": 0.0}
    for tag, s in FLASH_SHAPES.items():
        route = flash_route(s)
        q32, k32, v32 = flash_inputs(torch, s, seed=8)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            before = getattr(fa, route).launches
            got = fa.flash_attention(q, k, v, causal=s["causal"], block_q=s["block_q"])
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, s["causal"])
            err, cos, finite = compare(torch, got, ref)
            name = f"{route} {tag} {str(dt).split('.')[-1]}"
            log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f} "
                f"(max |o| {ref.float().abs().max().item():.3f})")
            check(getattr(fa, route).launches == before + 1, f"{name}: not one launch of {route}")
            check(got.dtype == dt and got.shape == q.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
            check(finite, f"{name}: non-finite output")
            if dt == torch.float32:
                check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
            else:
                check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
                check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
                worst[route] = max(worst[route], err)
            del got, ref
    return worst


# -- 4. main path ------------------------------------------------------------


def synthetic_frames(torch, n: int, size: int, patch: int):
    """Frames as uint8 [n, size, size, 3], each its own scene: a random
    colour per patch, a horizontal gradient and seeded pixel noise."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = size // patch
    layout = torch.randint(0, 256, (n, g, g, 3), generator=gen, device="cuda").float()
    layout = layout.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    ramp = torch.linspace(-30, 30, size, device="cuda")
    noise = torch.randn((n, size, size, 3), generator=gen, device="cuda") * 1.5
    frames = layout + ramp[None, :, None, None] + noise
    return frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


def rank_check(got, ref, got_q, ref_q, noise: float, k: int = 10):
    """Hold the kernel path's top-k to the plain path's, query by query.

    ``got``/``ref`` are the two paths' unit frame embeddings, ``got_q``/
    ``ref_q`` their query vectors. A frame in one top-k and not the other is
    a violation unless the plain path scores it within ``noise`` of its own
    k-th score. Returns (violations, overlaps, frames within the noise
    band of the cut, largest score difference between the paths)."""
    import numpy as np

    violations, overlaps, band, diff = 0, [], [], 0.0
    for gq, rq in zip(got_q, ref_q):
        s_got, s_ref = got @ gq, ref @ rq
        top_got = set(np.argsort(-s_got, kind="stable")[:k].tolist())
        top_ref_order = np.argsort(-s_ref, kind="stable")[:k]
        top_ref = set(top_ref_order.tolist())
        cut = s_ref[top_ref_order[-1]]
        violations += int(sum(abs(s_ref[j] - cut) > noise for j in top_got ^ top_ref))
        overlaps.append(len(top_got & top_ref))
        band.append(int((np.abs(s_ref - cut) <= noise).sum()))
        diff = max(diff, float(np.abs(s_got - s_ref).max()))
    return violations, overlaps, band, diff


def write_video(path: pathlib.Path, n_frames: int) -> None:
    """A small real video file: boot keeps only videos whose file exists."""
    import cv2
    import numpy as np

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for i in range(n_frames):
        writer.write(np.full((64, 64, 3), i % 256, np.uint8))
    writer.release()


def write_data_root(root: pathlib.Path, names, embeddings_per_video, frames_per_video):
    """The JAX package's data-root layout: per video an .npy of embeddings,
    metadata JSON, the frames as JPEGs (the int8 gate samples them), a
    small video file, and the registry entry."""
    import cv2
    import numpy as np

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import VideoRegistry

    cfg = DataRootConfig(root).ensure()
    registry = VideoRegistry(cfg.mapping_path)
    for name, emb, frames in zip(names, embeddings_per_video, frames_per_video):
        np.save(cfg.embedding_dir / f"{name}_embeddings.npy", emb)
        frames_dir = cfg.frames_dir / name
        frames_dir.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            cv2.imwrite(str(frames_dir / f"{i}.jpg"), np.ascontiguousarray(f[:, :, ::-1]))
        video = cfg.video_dir / f"{name}.mp4"
        write_video(video, len(emb))
        records = [
            {
                "id": f"{name}-{i}", "media_type": "image",
                "filepath": str(frames_dir / f"{i}.jpg"), "tags": [],
                "metadata": {}, "video": f"videos/{name}.mp4",
                "frameid": f"{i}.jpg", "frameidx": i,
                "text_detections": {"detections": []},
                "object_detections": {"detections": []},
            }
            for i in range(len(emb))
        ]
        meta = cfg.metadata_dir / f"{name}_metadata.json"
        meta.write_text(json.dumps(records))
        registry.add(
            name, metadata_file=meta, embeddings_file=cfg.embedding_dir / f"{name}_embeddings.npy",
            video_path=video, frames_dir=frames_dir, embedding_model="original",
        )
    return cfg


def serve_counted(torch, engine, frames, root: pathlib.Path, counted, **ctx_kwargs):
    """The main path once, through the entry points a user calls: encode the
    frames, write the data root, boot ``ServingContext`` from it and answer
    the /api/search requests. Every count in ``counted`` (objects with a
    ``launches`` attribute) is set to 0 just before and read just after.
    Returns (embeddings, context, encode seconds, request ms, launches)."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.serving import ServingContext, create_app

    engine.encode_staged_images(frames[:BATCH])  # first call: kernel libraries load
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    emb = engine.encode_staged_images(frames)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    check(emb.shape == (N_FRAMES, engine.cfg.embed_dim), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite frame embeddings")
    names = [f"video{v}" for v in range(N_VIDEOS)]
    per = N_FRAMES // N_VIDEOS
    cfg = write_data_root(root, names, [emb[v * per:(v + 1) * per] for v in range(N_VIDEOS)],
                          [frames[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
    ctx = ServingContext(cfg, engine=engine, **ctx_kwargs)
    loaded = ctx.boot()
    check(loaded == names, f"boot loaded {loaded}")
    client = Client(create_app(ctx))
    check(client.get("/health").status_code == 200, "/health")
    check(client.get("/api/videos").status_code == 200, "/api/videos")
    request_ms = []
    for i, q in enumerate(QUERIES):
        body = {"query": q, "search_type": "text", "top_k": 10, "adaptive_threshold": -1.0,
                "search_method": "text_clip" if i % 2 == 0 else "text_adaptive"}
        if i == len(QUERIES) - 1:
            body["videoId"] = "video-2"
        t1 = time.perf_counter()
        resp = client.post("/api/search", json=body)
        request_ms.append((time.perf_counter() - t1) * 1e3)
        check(resp.status_code == 200, f"/api/search {q!r}: HTTP {resp.status_code}")
        events = json.loads(resp.get_data(as_text=True))["events"]
        check(len(events) > 0, f"/api/search {q!r}: no events")
        check(all(math.isfinite(e["clip_similarity"]) for e in events), "non-finite score")
        log(f"search {body['search_method']:13s} {q!r}: HTTP 200, {len(events)} events, "
            f"top {events[0]['videoId']}/{events[0]['id']} "
            f"score {events[0]['clip_similarity']:.4f}, {request_ms[-1]:.1f} ms")
    launches = {fn.__name__: fn.launches for fn in counted}
    return emb, ctx, encode_s, request_ms, launches


def check_against_plain(torch, engine, frames, emb, one_noise: float, served_noise: float,
                        what: str, plain_impl: str = "plain", min_cos: float = EMBED_MIN_COS) -> dict:
    """The kernel path's embeddings and top-10 rankings against the plain
    versions' (``attn_impl=plain_impl``: "plain", or "flash_plain" for the
    flash route) on the same frames and queries: unit rows within ``min_cos``
    and rankings within the noise bands. Then the check must reject frame
    embeddings off by row cosine EMBED_MIN_COS: through the rankings, or,
    where ``min_cos`` is tighter than that (a path whose rankings are too
    flat for the bands to reject anything), through the row cosines, row by
    row. Returns the least row cosines and the largest score difference of
    each ranking case."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models.clip import encode_staged_u8, encode_text

    plain_cfg = dataclasses.replace(engine.cfg, attn_impl=plain_impl)
    with torch.inference_mode():
        ref = []
        for i in range(0, N_FRAMES, BATCH):
            staged = torch.from_numpy(frames[i:i + BATCH]).cuda()
            ref.append(encode_staged_u8(engine.params, plain_cfg, staged, dtype=engine.compute_dtype))
        ref = torch.cat(ref).float().cpu().numpy()
    got_n = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    ref_n = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    cos = (got_n * ref_n).sum(1)
    log(f"{what}: frame embeddings, kernel path vs plain path: min row cos {cos.min():.6f}")
    check(cos.min() >= min_cos, f"{what}: embedding cosine {cos.min()} < {min_cos}")
    tokens = torch.from_numpy(engine.tokenizer(list(QUERIES))).cuda()
    with torch.inference_mode():
        txt_ref = encode_text(engine.params, plain_cfg, tokens, dtype=engine.compute_dtype,
                              eot_fast_final=True).float().cpu().numpy()
    txt_ref /= np.linalg.norm(txt_ref, axis=1, keepdims=True)
    txt = engine.encode_texts(list(QUERIES))
    tcos = (txt * txt_ref).sum(1)
    log(f"{what}: text embeddings, kernel path vs plain path: min row cos {tcos.min():.6f}")
    check(tcos.min() >= min_cos, f"{what}: text embedding cosine {tcos.min()} < {min_cos}")

    # rankings: the frame paths under the plain path's text vectors and
    # under its vectors of a few frames; then the served ranking, each text
    # query through each path's own towers
    out = {"frame_cos": float(cos.min()), "text_cos": float(tcos.min())}
    picks = np.linspace(0, N_FRAMES - 1, N_FRAME_QUERIES).astype(int)
    cases = (
        ("text queries, one query vector", txt_ref, txt_ref, one_noise),
        ("frame queries, one query vector", ref_n[picks], ref_n[picks], one_noise),
        ("text queries, each path's own", txt, txt_ref, served_noise),
    )
    for kind, got_q, ref_q, noise in cases:
        bad, overlaps, band, diff = rank_check(got_n, ref_n, got_q, ref_q, noise)
        log(f"{what}: top-10 rankings, {kind}, kernel vs plain path: overlap {overlaps}, "
            f"frames within {noise} of the 10th score {band}, largest score "
            f"difference {diff:.2e}, violations {bad}")
        out[kind] = diff
        check(bad == 0, f"{what}, {kind}: {bad} top-10 swaps wider than {noise}")
    # the check must reject frame embeddings off by the row-cosine tolerance
    # (0.999): seeded noise of that size on the kernel path's frames
    noise = np.random.default_rng(0).standard_normal(got_n.shape).astype(np.float32)
    off = got_n + noise * math.sqrt((1 / EMBED_MIN_COS**2 - 1) / got_n.shape[1])
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    bad_off = sum(rank_check(off, ref_n, q, q, one_noise)[0] for q in (txt_ref, ref_n[picks]))
    off_cos = (off * ref_n).sum(1)
    log(f"{what}: the one-vector ranking checks on frame embeddings off by row cosine "
        f"{float((off * got_n).sum(1).mean()):.5f}: {bad_off} violations; their row cosines "
        f"against the plain path {float(off_cos.min()):.5f} to {float(off_cos.max()):.5f}")
    if min_cos > EMBED_MIN_COS:
        check(bad_off > 0 or bool((off_cos < min_cos).all()),
              f"{what}: neither the ranking check nor the row-cosine band {min_cos} rejects "
              "embeddings off by row cosine 0.999")
    else:
        check(bad_off > 0, f"{what}: the ranking check passes embeddings off by row cosine 0.999")
    return out


def text_query_p50_ms(engine, ctx) -> float:
    """Encode + search of a fresh query (no result cache), p50 of 20."""
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        vec = engine.encode_texts([f"query number {i} about a scene"])
        ctx.index.search(vec, 10)
        lat.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(lat)


def phase_main_path(torch, frames, then=None):
    """bf16 weights through K1 and K2, an fp32 index searched by cosine_topk;
    ``then(engine, data_root)`` runs next, over the same engine and data
    root."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import block_fused as bf

    t0 = time.perf_counter()
    engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
    log(f"engine: {MODEL} random weights (seed 0), {engine.compute_dtype}, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), [bf.fused_attn_block, bf.fused_mlp_block])
        n_batches, n_text = -(-N_FRAMES // BATCH), len(QUERIES)
        n_blocks = engine.cfg.vision.layers - 1  # the last block is the pooled-row one
        expected = n_blocks * n_batches + (engine.cfg.text.layers - 1) * n_text
        log(f"launches over the bf16 main path: {launches} (expected {expected} each: "
            f"11 per encode batch per tower, {n_batches} frame batches, {n_text} text encodes)")
        for name, n in launches.items():
            check(n == expected > 0, f"{name}: {n} launches, expected {expected}")
        check_against_plain(torch, engine, frames, emb, ONE_VECTOR_RANK_NOISE, SERVED_RANK_NOISE,
                            "bf16")
        p50 = text_query_p50_ms(engine, ctx)
        after = then(engine, ctx.data_root.root) if then else None
    return {
        "launches": launches,
        "encode_frames_per_s": N_FRAMES / encode_s,
        "text_query_p50_ms": p50,
        "request_p50_ms": statistics.median(request_ms),
        "then": after,
    }


def phase_main_path_int8(torch, frames):
    """int8 weights through K3a and K3b, an int8 index searched by K4; then
    the boot gate (``--params-dtype auto``) over the same data root."""
    from evr_tpu_torch.index import EmbeddingEngine, store
    from evr_tpu_torch.models.quant_gate import auto_params_dtype
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.retrieval import fused_topk

    engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0,
                             params_dtype="int8")
    log(f"engine: {MODEL} random weights (seed 0), int8 block linears, {engine.compute_dtype}")
    # independent counts beside the kernels': index searches, and calls of
    # the GEMM-and-sort search that the fused path must not make
    searches, xla_search = counting(store.FrameIndex._search_raw_locked), counting(store.cosine_topk)
    store.FrameIndex._search_raw_locked, store.cosine_topk = searches, xla_search
    try:
        with tempfile.TemporaryDirectory() as tmp:
            emb, ctx, encode_s, request_ms, launches = serve_counted(
                torch, engine, frames, pathlib.Path(tmp),
                [bf.fused_attn_block_q, bf.fused_mlp_block_q, fused_topk, searches, xla_search],
                index_dtype="int8", search_impl="pallas")
            n_batches, n_text = -(-N_FRAMES // BATCH), len(QUERIES)
            expected = (engine.cfg.vision.layers - 1) * n_batches + (engine.cfg.text.layers - 1) * n_text
            log(f"launches over the int8 main path: {launches} (expected {expected} of each K3 "
                f"half, {n_text} index searches, each one fused_topk launch, no cosine_topk)")
            for name in ("fused_attn_block_q", "fused_mlp_block_q"):
                check(launches[name] == expected > 0, f"{name}: {launches[name]} launches, expected {expected}")
            check(launches["_search_raw_locked"] == n_text, f"{launches['_search_raw_locked']} index searches")
            check(launches["fused_topk"] == n_text, f"fused_topk: {launches['fused_topk']} launches")
            check(launches["cosine_topk"] == 0, f"cosine_topk ran {launches['cosine_topk']} times")
            check(ctx.index._device_index.dtype == torch.int8, "the served index is not int8")
            check_against_plain(torch, engine, frames, emb, INT8_ONE_VECTOR_RANK_NOISE,
                                INT8_SERVED_RANK_NOISE, "int8")
            p50 = text_query_p50_ms(engine, ctx)
            root = ctx.data_root
            del engine, ctx

            # --params-dtype auto: a float32 engine, gated over the data root
            gated = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
            report = auto_params_dtype(gated, root)
            log(f"int8 gate (auto_params_dtype) on random weights: {json.dumps(report.as_dict())} "
                f"-> serving {gated.params_dtype}")
            check(gated.params_dtype == ("int8" if report.passed else "bfloat16"),
                  f"gate passed={report.passed} but the engine serves {gated.params_dtype}")
            check(report.n_frames == min(256, N_FRAMES), f"the gate sampled {report.n_frames} frames")
    finally:
        store.FrameIndex._search_raw_locked = searches.__wrapped__
        store.cosine_topk = xla_search.__wrapped__
    launches = {k: v for k, v in launches.items() if k not in ("_search_raw_locked", "cosine_topk")}
    return {
        "launches": launches,
        "encode_frames_per_s": N_FRAMES / encode_s,
        "text_query_p50_ms": p50,
        "request_p50_ms": statistics.median(request_ms),
        "gate": report.as_dict(),
    }


def counting(fn):
    """``fn`` with a ``launches`` count of its calls."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)

    wrapper.launches = 0
    return wrapper


# -- 6. training -------------------------------------------------------------


def write_caption_set(root: pathlib.Path, size: int, patch: int):
    """A synthetic caption set in the reference trainer's layout: JPEGs of
    size² (seeded scenes, as ``synthetic_frames``) and two JSONs keyed by
    relative path with caption and category. Returns (train json, val json)."""
    import cv2
    import numpy as np
    import torch

    frames = synthetic_frames(torch, N_TRAIN + N_VAL, size, patch)
    cats = ["Violence", "NonViolence", "Sensitive content"]
    rng = np.random.default_rng(11)
    meta = []
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / f"img{i}.jpg"), np.ascontiguousarray(f[:, :, ::-1]))
        words = rng.choice(["a", "red", "car", "crowd", "street", "dog", "boat", "sign", "night",
                            "people", "running", "park", "fight", "water"], size=6)
        meta.append((f"img{i}.jpg", {"caption": " ".join(words), "category": cats[i % 3]}))
    paths = []
    for name, part in (("train.json", meta[:N_TRAIN]), ("val.json", meta[N_TRAIN:])):
        (root / name).write_text(json.dumps(dict(part)))
        paths.append(root / name)
    return paths


def leaf_cosines(torch, grads_k, grads_p) -> dict:
    """Cosine of each gradient leaf between two steps (leaves zero in both
    are left out)."""
    out = {}
    for k in grads_k:
        a, b = grads_k[k].float().flatten(), grads_p[k].float().flatten()
        if a.norm().item() == 0.0 and b.norm().item() == 0.0:
            continue
        out[k] = torch.nn.functional.cosine_similarity(a[None], b[None]).item()
    return out


def vision_block_leaf(key: str) -> bool:
    return key.startswith("clip/visual/blocks/")


def step_compare(torch, tag, m_k, m_p, grads_k, grads_p, check_leaves):
    """A kernel step against a plain step: the loss and the gradient norm
    (relative differences), the least cosine of the leaves ``check_leaves``
    selects, and that least cosine once the kernel's gradients are
    perturbed to cosine 0.99. Prints the worst leaves of each group."""
    from evr_tpu_torch.training.finetune import global_norm

    loss_k, loss_p = m_k["total_loss"].item(), m_p["total_loss"].item()
    norm_k, norm_p = global_norm(grads_k.values()).item(), global_norm(grads_p.values()).item()
    check(math.isfinite(loss_k) and math.isfinite(norm_k), f"{tag}: non-finite kernel step")
    cos = leaf_cosines(torch, grads_k, grads_p)
    checked = {k: c for k, c in cos.items() if check_leaves(k)}
    for group, sel in (("vision blocks", vision_block_leaf),
                       ("other leaves", lambda k: not vision_block_leaf(k))):
        worst = sorted((c, k) for k, c in cos.items() if sel(k))[:3]
        log(f"{tag}: {group}: least leaf cosines {[(k, round(c, 7)) for c, k in worst]}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    off = {}
    for k in checked:
        g = grads_k[k].float()
        noise = torch.randn(g.shape, generator=gen, device=g.device)
        noise -= (noise.flatten() @ g.flatten()) / max(g.norm().item() ** 2, 1e-30) * g
        off[k] = g + noise * (g.norm() * math.tan(math.acos(0.99)) / max(noise.norm().item(), 1e-30))
    out = {"loss_rel": abs(loss_k - loss_p) / abs(loss_p), "norm_rel": abs(norm_k - norm_p) / norm_p,
           "least_leaf_cos": min(checked.values()), "leaves": len(checked),
           "perturbed_least_cos": min(leaf_cosines(torch, off, {k: grads_p[k] for k in off}).values())}
    log(f"{tag}: loss {loss_k:.6f} / {loss_p:.6f}, grad norm {norm_k:.6f} / {norm_p:.6f}: "
        f"{json.dumps(out)}")
    return out


def step_check(tag, got, bands) -> None:
    """The bands (loss rel, grad norm rel, least leaf cosine); the leaf
    band must reject the gradients perturbed to cosine 0.99."""
    check(got["loss_rel"] <= bands[0], f"{tag}: losses apart by {got['loss_rel']} > {bands[0]}")
    check(got["norm_rel"] <= bands[1], f"{tag}: gradient norms apart by {got['norm_rel']} > {bands[1]}")
    check(got["least_leaf_cos"] >= bands[2], f"{tag}: leaf cosine {got['least_leaf_cos']} < {bands[2]}")
    check(got["perturbed_least_cos"] < bands[2],
          f"{tag}: the leaf check passes gradients perturbed to cosine 0.99")


def phase_train(torch):
    """The training path through ``tools.finetune.main`` (counted), the
    checkpoint against the initial weights, the kernel step against the
    plain step, and the time of a step."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params, params_from_numpy
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.tools import finetune as cli
    from evr_tpu_torch.training import (
        CaptionDataset, TrainConfig, TrainState, make_grad_fn, make_optimizer, make_train_step,
        param_group_labels,
    )
    from evr_tpu_torch.training.finetune import flat_leaves

    cfg = get_model_config(TRAIN_MODEL)
    seed = 0
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, val_json = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size)
        plain_attn, plain_mlp = counting(bf.fused_attn_block_bwd_plain), counting(bf.fused_mlp_block_bwd_plain)
        bf.fused_attn_block_bwd_plain, bf.fused_mlp_block_bwd_plain = plain_attn, plain_mlp
        counted = [bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd,
                   bf.fused_mlp_block_bwd, plain_attn, plain_mlp]
        try:
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            result = cli.main([
                "--train-json", str(train_json), "--val-json", str(val_json), "--data-dir", str(root),
                "--model", TRAIN_MODEL, "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
                "--seed", str(seed), "--save-dir", str(root / "ckpt"), "--device", "cuda",
            ])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
        finally:
            bf.fused_attn_block_bwd_plain = plain_attn.__wrapped__
            bf.fused_mlp_block_bwd_plain = plain_mlp.__wrapped__
        blocks = cfg.vision.layers
        steps, val_batches = N_TRAIN // TRAIN_BATCH, N_VAL // TRAIN_BATCH
        log(f"training launches: {launches} (expected K1 = K2 = {blocks} x {steps + val_batches}, "
            f"K5a = K5b = {blocks} x {steps}, plain backward 0); fit {fit_s:.1f} s")
        check(launches["fused_attn_block"] == launches["fused_mlp_block"] == blocks * (steps + val_batches),
              f"K1/K2 launches {launches}")
        check(launches["fused_attn_block_bwd"] == launches["fused_mlp_block_bwd"] == blocks * steps,
              f"K5 launches {launches}")
        check(launches["fused_attn_block_bwd_plain"] == launches["fused_mlp_block_bwd_plain"] == 0,
              f"plain backward ran: {launches}")
        row = result["history"][0]
        log(f"training epoch: {json.dumps({k: v for k, v in row.items()})}")
        check(row["train_batches"] == steps and row["val_batches"] == val_batches, f"batches {row}")
        for key in ("train_total_loss", "train_grad_norm", "val_total_loss", "train_contrastive_loss"):
            check(math.isfinite(row[key]), f"{key} = {row[key]}")
        saves = dict(result["checkpoint_seconds"])
        ckpt = root / "ckpt" / "final_checkpoint.pt"
        log(f"checkpoint saves: {json.dumps(saves)} s, final {ckpt.stat().st_size / 1e9:.2f} GB")

        # frozen leaves bit-unchanged, trainable ones moved
        init = {"clip": init_clip_params(seed, cfg),
                "classifier": init_classifier_params(seed + 1, ClassifierConfig(embed_dim=cfg.embed_dim))}
        final = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
        labels = flat_leaves(param_group_labels(final, 8))
        want, got = flat_leaves(init), flat_leaves(final)
        frozen = [k for k in labels if labels[k] == "frozen"]
        stale = [k for k in labels if labels[k] != "frozen" and torch.equal(got[k], torch.from_numpy(np.asarray(want[k])))]
        moved = [k for k in frozen if not torch.equal(got[k], torch.from_numpy(np.asarray(want[k])))]
        log(f"final checkpoint: {len(frozen)} frozen leaves, {len(moved)} of them moved; "
            f"{len(labels) - len(frozen)} trainable leaves, {len(stale)} of them unmoved")
        check(len(frozen) == 16 and not moved, f"frozen leaves moved: {moved}")
        check(not stale, f"trainable leaves did not move: {stale[:5]}")
        del final, got

        # one step from the same params and batch: kernels against plain
        params = params_from_numpy(init, "cuda")
        batch = next(iter(CaptionDataset(train_json, root).batches(TRAIN_BATCH, cfg.vision.image_size, seed=seed)))
    cls_cfg = ClassifierConfig(embed_dim=cfg.embed_dim)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain_grad")
    compared = {}
    for dtype in ("float32", "bfloat16"):
        tc = TrainConfig(seed=seed, batch_size=TRAIN_BATCH, epochs=1, compute_dtype=dtype)
        fn_k, fn_p = make_grad_fn(cfg, cls_cfg, tc), make_grad_fn(plain_cfg, cls_cfg, tc)
        m_k, grads_k = fn_k(params, batch, torch.Generator(device="cuda").manual_seed(1))
        m_p, grads_p = fn_p(params, batch, torch.Generator(device="cuda").manual_seed(1))
        # fp32: every leaf; bf16: the vision blocks' leaves, which the kernels
        # compute (a leaf elsewhere whose gradient is a near-cancelling sum
        # over the batch, such as the classifier's, moves with bf16 noise)
        compared[dtype] = step_compare(
            torch, f"kernel step vs plain step, {dtype}", m_k, m_p, grads_k, grads_p,
            (lambda k: True) if dtype == "float32" else vision_block_leaf)
        del grads_k, grads_p
    for dtype, bands in (("float32", STEP_FP32_BANDS), ("bfloat16", STEP_BF16_BANDS)):
        step_check(f"kernel step vs plain step, {dtype}", compared[dtype], bands)

    # the time of a step (bf16): forward, backward and the optimizer
    opt = make_optimizer(tc, params, N_TRAIN // TRAIN_BATCH)
    step, _ = make_train_step(cfg, cls_cfg, tc, opt)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    log(f"train step ({TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16): {[round(t, 4) for t in times]} s, "
        f"median {step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"launches": launches, "step_s": step_s, "samples_per_s": TRAIN_BATCH / step_s,
            "checkpoint_s": saves, "compared": compared}


# -- 7. times ----------------------------------------------------------------


def half_bound_ms(name: str, s: dict, elt: int) -> tuple[float, float, str]:
    """(operations time, bytes time, description) of one call at the card's
    peaks: each input read once, each output written once. The int8 halves
    count their GEMMs at the int8 rate and the attention at the bf16 rate."""
    rows, W = s["B"] * s["T"], s["W"]
    attn_flops = 4 * s["B"] * s["T"] * s["T"] * W
    if name.endswith("_bwd"):  # the backward halves: x and g in, dx and fp32 grads out
        if name == "fused_attn_block_bwd":  # QKV recompute, do, dW_out, dW_qkv, dy; 6 T^2 products
            gemm, attn, n_par = 22 * rows * W * W, 3 * attn_flops, 4 * W * W + 6 * W
        else:  # fc recompute, dW_proj, dh, dW_fc, dy
            gemm, attn, n_par = 40 * rows * W * W, 0, 8 * W * W + 7 * W
        nbytes = 3 * rows * W * elt + n_par * elt + n_par * 4
        desc = f"{gemm / 1e9:.2f} GFLOP GEMM, {attn / 1e9:.2f} GFLOP attention, {nbytes / 1e6:.1f} MB"
        return (gemm + attn) / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc
    if name in ("fused_attn_block", "fused_attn_block_q"):
        gemm = 2 * rows * W * 3 * W + 2 * rows * W * W
        weights, vectors, attn = 4 * W * W, 4 * W, attn_flops
    else:
        gemm = 2 * 2 * rows * W * 4 * W
        weights, vectors, attn = 8 * W * W, 5 * W, 0
    if name.endswith("_q"):  # int8 kernels; fp32 scales and biases
        t_ops = gemm / H100_INT8_OPS + attn / H100_BF16_FLOPS
        nbytes = 2 * rows * W * elt + weights + 2 * vectors * 4 + 2 * W * elt
    else:
        t_ops = (gemm + attn) / H100_BF16_FLOPS
        nbytes = (2 * rows * W + weights + vectors + 2 * W) * elt
    desc = f"{gemm / 1e9:.2f} G GEMM ops, {attn / 1e9:.2f} GFLOP attention, {nbytes / 1e6:.1f} MB"
    return t_ops * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc


def time_case(torch, name, tag, kern, plain, lib, t_ops, t_bytes, desc, counted):
    """Kernel, plain version and library yardstick by CUDA events, in the
    order plain, kernel, kernel, plain so the pairs share a clock; the
    timing launches are taken back out of the main-path counts."""
    saved = [c.launches for c in counted]
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kern, kern, plain))
    lib_ms = cuda_ms(torch, lib)
    for c, n in zip(counted, saved):
        c.launches = n
    rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log(f"time {name} {tag}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {desc})")
    return rec


def library_act(torch, act: str):
    """The activation of a library yardstick: quickGELU, or exact GELU."""
    if act == "quick_gelu":
        return lambda h: h * torch.sigmoid(1.702 * h)
    return torch.nn.functional.gelu


def library_halves(torch, a, m, s: dict):
    """The library yardsticks of K1 and K2, which the port never calls:
    ``F.layer_norm`` + ``F.linear`` + ``F.scaled_dot_product_attention`` +
    ``F.linear``, and LN + linear + activation + linear, over the halves'
    parameters ``a`` and ``m`` in the compute dtype. Returns two functions
    of x."""
    import torch.nn.functional as F

    B, T, W, H = s["B"], s["T"], s["W"], s["H"]
    act_fn = library_act(torch, s.get("act", "quick_gelu"))
    qkv_t, out_t = a[2].t().contiguous(), a[4].t().contiguous()
    fc_t, pr_t = m[2].t().contiguous(), m[4].t().contiguous()

    def attn(x):
        y = F.layer_norm(x, (W,), a[0], a[1], 1e-5)
        q, k, v = F.linear(y, qkv_t, a[3]).view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"])
        return x + F.linear(o.transpose(1, 2).reshape(B, T, W), out_t, a[5])

    def mlp(x):
        h = F.linear(F.layer_norm(x, (W,), m[0], m[1], 1e-5), fc_t, m[3])
        return x + F.linear(act_fn(h), pr_t, m[5])

    return attn, mlp


def phase_times(torch):
    """K1, K2, K3a and K3b at the ViT-B/32 serving shapes (vision, text) and
    at ViT-H-14's vision shape (VITH_SERVE, exact GELU), bf16."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops.int8 import quantize_rows

    dev = torch.device("cuda")
    counted = (bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q)
    out = {}
    for shape_name, s in (("vision", VISION), ("text", TEXT), ("vith", VITH_SERVE)):
        act = s.get("act", "quick_gelu")
        act_fn = library_act(torch, act)
        gen = torch.Generator(device=dev).manual_seed(2)
        fp = block_params(torch, s["W"], gen, dev)
        attn_args, mlp_args = bf.block_half_params(fp)
        dt = torch.bfloat16
        x = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev).to(dt)
        a = [t.to(dt) for t in attn_args]
        m = [t.to(dt) for t in mlp_args]
        B, T, W, H = s["B"], s["T"], s["W"], s["H"]
        qa, qm = bf.quant_block_half_params(quantized_block(fp))
        qa_args = bf.cast_quant_args(dt, qa)
        qm_args = bf.cast_quant_args(dt, qm)
        lib_attn_of, lib_mlp_of = library_halves(torch, a, m, s)

        # int8 yardsticks: the library's int8 GEMM (torch._int_mm, weights
        # column-major as its int8 path takes them) around the same
        # per-token quantisation and dequantisation
        def int_mm(y32, kq_cm, ks, b):
            yq, ys = quantize_rows(y32)
            return torch._int_mm(yq, kq_cm).float() * ys * ks + b

        qkv_cm, outq_cm = (qa_args[i].t().contiguous().t() for i in (2, 5))
        fc_cm, prq_cm = (qm_args[i].t().contiguous().t() for i in (2, 5))

        def lib_attn_q():
            y = F.layer_norm(x.float(), (W,), qa_args[0].float(), qa_args[1].float(), 1e-5)
            qkv = int_mm(y.view(-1, W), qkv_cm, qa_args[3], qa_args[4]).to(dt)
            q, k, v = qkv.view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"])
            o = o.transpose(1, 2).reshape(-1, W).float()
            return (x.view(-1, W).float() + int_mm(o, outq_cm, qa_args[6], qa_args[7])).to(dt)

        def lib_mlp_q():
            y = F.layer_norm(x.float(), (W,), qm_args[0].float(), qm_args[1].float(), 1e-5)
            h = int_mm(y.view(-1, W), fc_cm, qm_args[3], qm_args[4])
            o = int_mm(act_fn(h), prq_cm, qm_args[6], qm_args[7])
            return (x.view(-1, W).float() + o).to(dt)

        cases = (
            ("fused_attn_block", lambda: bf.fused_attn_block(x, *a, n_heads=H, causal=s["causal"]),
             lambda: bf.fused_attn_block_plain(x, *a, n_heads=H, causal=s["causal"]), lambda: lib_attn_of(x)),
            ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *m, activation=act),
             lambda: bf.fused_mlp_block_plain(x, *m, activation=act), lambda: lib_mlp_of(x)),
            ("fused_attn_block_q",
             lambda: bf.fused_attn_block_q(x, *qa, n_heads=H, causal=s["causal"]),
             lambda: bf.fused_attn_block_q_plain(x, *qa_args, n_heads=H, causal=s["causal"]),
             lib_attn_q),
            ("fused_mlp_block_q", lambda: bf.fused_mlp_block_q(x, *qm, activation=act),
             lambda: bf.fused_mlp_block_q_plain(x, *qm_args, activation=act), lib_mlp_q),
        )
        for name, kern, plain, lib in cases:
            t_ops, t_bytes, desc = half_bound_ms(name, s, 2)
            out[(name, shape_name)] = time_case(torch, name, f"{shape_name} bf16", kern, plain, lib,
                                                t_ops, t_bytes, desc, counted)
    return out


def phase_times_train(torch, gemm):
    """K1, K2, K5a and K5b at the ViT-L/14@336px training shape (bf16). The
    yardsticks: the forward composition of ``phase_times`` for K1/K2, and
    its forward and backward under torch.autograd for K5a/K5b (the kernels
    recompute their half's forward too). Then K5a split: its attention
    backward alone (``attn_backward``) and the sum of its five GEMMs as the
    GEMM phase timed them (``gemm``), the rest being the LN passes and the
    column sums."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    s = VITL
    B, T, W, H = s["B"], s["T"], s["W"], s["H"]
    gen = torch.Generator(device=dev).manual_seed(2)
    attn_args, mlp_args = bf.block_half_params(block_params(torch, W, gen, dev))
    dt = torch.bfloat16
    x = unit_activations(torch, (B, T, W), gen, dev).to(dt)
    g = (unit_activations(torch, (B, T, W), gen, dev) * 0.01).to(dt)
    a = [t.to(dt) for t in attn_args]
    m = [t.to(dt) for t in mlp_args]
    la = [a[0], a[1], a[2].t().contiguous(), a[3], a[4].t().contiguous(), a[5]]
    lm = [m[0], m[1], m[2].t().contiguous(), m[3], m[4].t().contiguous(), m[5]]

    def lib_attn(xr, p):
        y = F.layer_norm(xr, (W,), p[0], p[1], 1e-5)
        q, k, v = F.linear(y, p[2], p[3]).view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return xr + F.linear(o.transpose(1, 2).reshape(B, T, W), p[4], p[5])

    def lib_mlp(xr, p):
        h = F.linear(F.layer_norm(xr, (W,), p[0], p[1], 1e-5), p[2], p[3])
        return xr + F.linear(h * torch.sigmoid(1.702 * h), p[4], p[5])

    def fwd_bwd(fn, p):
        def run():
            leaves = [t.detach().requires_grad_() for t in (x, *p)]
            return torch.autograd.grad(fn(leaves[0], leaves[1:]), leaves, g)
        return run

    counted = (bf.fused_attn_block, bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd)
    cases = (
        ("fused_attn_block", lambda: bf.fused_attn_block(x, *a, n_heads=H),
         lambda: bf.fused_attn_block_plain(x, *a, n_heads=H), lambda: lib_attn(x, la)),
        ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *m),
         lambda: bf.fused_mlp_block_plain(x, *m), lambda: lib_mlp(x, lm)),
        ("fused_attn_block_bwd", lambda: bf.fused_attn_block_bwd(x, g, *a, n_heads=H),
         lambda: bf.fused_attn_block_bwd_plain(x, g, *a, n_heads=H), fwd_bwd(lib_attn, la)),
        ("fused_mlp_block_bwd", lambda: bf.fused_mlp_block_bwd(x, g, *m),
         lambda: bf.fused_mlp_block_bwd_plain(x, g, *m), fwd_bwd(lib_mlp, lm)),
    )
    out = {}
    for name, kern, plain, lib in cases:
        t_ops, t_bytes, desc = half_bound_ms(name, s, 2)
        out[(name, "vitl")] = time_case(torch, name, "vitl bf16", kern, plain, lib, t_ops, t_bytes,
                                        desc, counted)
    # K5a's attention backward alone, on qkv and do from the kernel's own GEMMs
    y = bf.ln_rows_plain(x, a[0], a[1]).reshape(-1, W)
    qkv = bf.gemm_bf16(y, a[2], a[3]).reshape(B, T, 3 * W)
    dout = bf.gemm_bf16(g.reshape(-1, W), a[4], w_t=True).reshape(B, T, W)
    before = bf.attn_backward.launches
    o, dqkv, dqkv_r = bf.attn_backward(qkv, dout, H)
    torch.cuda.synchronize()
    check(bf.attn_backward.launches == before + 1, "attn_backward: the kernel did not launch")
    check(bool(torch.isfinite(dqkv).all().item()), "attn_backward: non-finite dqkv")
    check(torch.equal(dqkv_r, dqkv.to(dt)), "attn_backward: round(dqkv) is not dqkv rounded")
    o_p, dqkv_p = bf.attn_backward_plain(qkv, dout, H)
    err, rel, cos, _ = bwd_compare(torch, dqkv, dqkv_p, False)
    o_err = (o.float() - o_p.float()).abs().max().item()
    attn_ms = min(cuda_ms(torch, lambda: bf.attn_backward(qkv, dout, H)) for _ in range(2))
    gemm_ms = sum(gemm[tag]["ms"] for tag in gemm if tag.startswith("vitl-K5a-"))
    k5a = out[("fused_attn_block_bwd", "vitl")]["ms"]
    out["k5a_split"] = {"ms": k5a, "attention_ms": attn_ms, "gemm_ms": gemm_ms,
                        "rest_ms": k5a - attn_ms - gemm_ms}
    log(f"K5a split at vitl bf16: {k5a:.4f} ms = attention backward {attn_ms:.4f} ms "
        f"({attn_ms / k5a:.1%}) + five GEMMs {gemm_ms:.4f} ms ({gemm_ms / k5a:.1%}; gemm_bf16 at the same "
        f"shapes and layouts) + the rest {k5a - attn_ms - gemm_ms:.4f} ms; attention backward against its "
        f"plain version: dqkv rel {rel:.3e} cos {cos:.7f}, o max abs {o_err:.3e}")
    return out


def phase_times_core(torch):
    """K1's attention core alone (``attn_forward``, bf16) at ATTN_CORE_TIMED,
    against its plain version and ``F.scaled_dot_product_attention`` on q, k,
    v views of the same qkv (which the port never calls). The bound counts
    qkv read once and o written once, and 4·d operations per (query, key)
    pair the mask keeps."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf

    out = {}
    for tag in ATTN_CORE_TIMED:
        s = ATTN_CORE_SHAPES[tag]
        B, T, W, H, causal = s["B"], s["T"], s["W"], s["H"], s["causal"]
        d = W // H
        qkv = core_inputs(torch, s, seed=11).to(torch.bfloat16)
        q, k, v = qkv.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
        pairs = T * (T + 1) // 2 if causal else T * T
        flops, nbytes = 4 * B * H * pairs * d, 4 * B * T * W * 2
        out[tag] = time_case(
            torch, "attn_forward", f"{tag} bf16 B={B} T={T} W={W} H={H}",
            lambda: bf.attn_forward(qkv, H, causal), lambda: bf.attn_forward_plain(qkv, H, causal),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB", (bf.attn_forward,))
        del qkv, q, k, v
    return out


def phase_times_topk(torch):
    """K4 at the serving shape of one text query: Q = 1, k = 30 over
    TOPK_ROWS int8 rows (the row scales applied)."""
    from evr_tpu_torch.ops.retrieval import fused_topk, fused_topk_plain

    index, scales = topk_index(torch, "int8")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((1, TOPK_DIM), generator=gen, device="cuda")
    k, n, d = 30, TOPK_ROWS, TOPK_DIM
    rows_bf16 = (index.float() * scales[:, None]).to(torch.bfloat16)
    q_bf16 = (q / q.norm()).to(torch.bfloat16)
    nbytes = n * d + 4 * n + 4 * d + k * (4 + 8)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * n * d / H100_FP32_FLOPS * 1e3
    desc = f"{nbytes / 1e6:.1f} MB, {2 * n * d / 1e9:.2f} GFLOP fp32"
    rec = time_case(
        torch, "fused_topk", f"int8 {n} x {d}, Q=1, k={k}",
        lambda: fused_topk(index, q, 0, n, k, scales),
        lambda: fused_topk_plain(index, q, 0, n, k, scales),
        lambda: torch.topk(q_bf16 @ rows_bf16.T, k), t_ops, t_bytes, desc, (fused_topk,))
    return rec


def phase_times_flash(torch):
    """K6 at each FLASH_SHAPES shape (bf16): the route's kernel, its plain
    version, and ``F.scaled_dot_product_attention`` (which the port never
    calls) as the library yardstick. The bound counts q, k, v and o once
    each, and 4·d operations per (query, key) pair the mask keeps."""
    import torch.nn.functional as F

    from evr_tpu_torch.ops import attention as fa

    counted = (fa.flash_attention_full, fa.flash_attention_blocked)
    out = {}
    for tag, s in FLASH_SHAPES.items():
        route = flash_route(s)
        q, k, v = (t.to(torch.bfloat16) for t in flash_inputs(torch, s, seed=9))
        B, H, T, d = s["B"], s["H"], s["T"], s["d"]
        pairs = T * (T + 1) // 2 if s["causal"] else T * T
        flops = 4 * B * H * pairs * d
        nbytes = 4 * B * H * T * d * 2
        desc = f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB"
        if route == "flash_attention_full":
            kern = lambda: fa.flash_attention_full(q, k, v)  # noqa: E731
        else:
            kern = lambda: fa.flash_attention_blocked(q, k, v, s["causal"])  # noqa: E731
        out[(route, tag)] = time_case(
            torch, route, f"{tag} bf16 B={B} H={H} T={T} d={d}", kern,
            lambda: fa.flash_attention_plain(q, k, v, s["causal"]),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"]),
            flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3, desc, counted)
    return out


# -- 8. the ANN tiers --------------------------------------------------------


def adc_case(torch, p: int, c: int, s: int, k: int, b: int, seed: int):
    """Seeded codes [p, c, s] uint8 and tables [b, s, k] fp32 on the card,
    the tables' entries at 1/sqrt(s) (a unit query's ADC table scale)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = torch.randint(0, k, (p, c, s), generator=gen, device="cuda", dtype=torch.uint8)
    tables = torch.randn((b, s, k), generator=gen, device="cuda") / math.sqrt(s)
    return blocks, tables


def adc_compare(torch, blocks, tables, nprobe: int, tag: str) -> float:
    """K7 against its plain version on the same inputs: expected bit-equal
    (the same order of sums), held to ADC_REL_TOL of the output's scale."""
    from evr_tpu_torch.ops.adc import adc_list_scores, adc_list_scores_plain

    got = adc_list_scores(blocks, tables, nprobe)
    torch.cuda.synchronize()
    ref = adc_list_scores_plain(blocks, tables, nprobe)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    same = bool(torch.equal(got, ref))
    log(f"parity adc_list_scores {tag}: bit-equal {same}, max_abs_err={err:.3e} "
        f"(output scale {scale:.3f})")
    check(bool(torch.isfinite(got).all().item()), f"adc_list_scores {tag}: non-finite scores")
    check(err <= ADC_REL_TOL * scale, f"adc_list_scores {tag}: err {err} above {ADC_REL_TOL} x {scale}")
    return err


def phase_parity_adc(torch) -> float:
    """K7 against its plain version: the IVF-PQ probe shape of phase 9 (P =
    B x nprobe = 256 lists of C = 3,072 rows, S = 64, K = 256), a ragged C
    with several probes per query, and an S that takes the scalar code loads."""
    worst = 0.0
    for tag, (p, c, s, k, b) in (
        ("P=256 C=3072 S=64 K=256 B=8", (ANN_B * ANN_NPROBE, ANN_CAPACITY, 64, 256, ANN_B)),
        ("P=24 C=1000 S=64 K=256 B=3", (24, 1000, 64, 256, 3)),
        ("P=6 C=517 S=20 K=100 B=2", (6, 517, 20, 100, 2)),
    ):
        blocks, tables = adc_case(torch, p, c, s, k, b, seed=p + c)
        worst = max(worst, adc_compare(torch, blocks, tables, p // b, tag))
    return worst


def clustered_unit_rows(torch, n: int, d: int, centres: int, seed: int):
    """[n, d] fp32 unit rows on the card: seeded centres plus per-row noise
    of ANN_NOISE per dimension, written slab by slab."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cents = torch.randn((centres, d), generator=gen, device="cuda")
    cents /= cents.norm(dim=1, keepdim=True)
    x = torch.empty((n, d), dtype=torch.float32, device="cuda")
    step = 1 << 20
    for lo in range(0, n, step):
        m = min(step, n - lo)
        pick = torch.randint(0, centres, (m,), generator=gen, device="cuda")
        rows = cents[pick] + ANN_NOISE * torch.randn((m, d), generator=gen, device="cuda")
        x[lo:lo + m] = rows / rows.norm(dim=1, keepdim=True)
    return x


def perturbed(torch, x, rows, scale: float, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = x[rows] + scale * torch.randn((len(rows), x.shape[1]), generator=gen, device="cuda")
    return (q / q.norm(dim=1, keepdim=True)).cpu().numpy()


def served_events(client, queries) -> tuple[list, list]:
    """/api/search (text_clip, top 10) for each query: the events' (video,
    id, score) lists and the request times in ms."""
    out, ms = [], []
    for q in queries:
        body = {"query": q, "search_type": "text", "search_method": "text_clip", "top_k": 10}
        t1 = time.perf_counter()
        resp = client.post("/api/search", json=body)
        ms.append((time.perf_counter() - t1) * 1e3)
        check(resp.status_code == 200, f"/api/search {q!r}: HTTP {resp.status_code}")
        events = json.loads(resp.get_data(as_text=True))["events"]
        check(len(events) > 0, f"/api/search {q!r}: no events")
        check(all(math.isfinite(e["clip_similarity"]) for e in events), "non-finite score")
        out.append([(e["videoId"], e["id"], e["clip_similarity"]) for e in events])
    return out, ms


def phase_ann_serving(torch, engine, root: pathlib.Path):
    """The bf16 phase's data root served under ``search_impl="ivf"`` (full
    probe) and ``"ivfpq"`` with the int8 host store, beside the exact path:
    IVF's served top-10 equals the exact path's (a frame may cross the cut
    only within ANN_FULL_PROBE_NOISE of the exact 10th score); IVF-PQ's top-1
    on perturbed corpus frames equals the exact path's. Returns the
    /api/search p50 of each tier."""
    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.serving import ServingContext, create_app

    t0 = time.perf_counter()
    exact = ServingContext(root, engine=engine)
    exact.boot()
    exact_events, _ = served_events(Client(create_app(exact)), QUERIES)
    emb = np.concatenate([exact.index.get_embeddings(v) for v in exact.index.videos]).astype(np.float32)
    picks = np.linspace(0, len(emb) - 1, 16).astype(int)
    noise = np.random.default_rng(5).standard_normal((len(picks), emb.shape[1])).astype(np.float32)
    frame_q = emb[picks] + ANN_FRAME_PERTURB * noise / math.sqrt(emb.shape[1])
    frame_q /= np.linalg.norm(frame_q, axis=1, keepdims=True)
    exact_top1 = exact.index.search_raw(frame_q, 1)[1][:, 0]
    n_lists = int(round(len(emb) ** 0.5))
    out = {}
    for impl, kw in (("ivf", {}), ("ivfpq", {"ivfpq_host_store": True})):
        ctx = ServingContext(root, engine=engine, search_impl=impl, ivf_clusters=n_lists,
                             ivf_nprobe=n_lists, **kw)
        check(ctx.boot() == exact.video_names(), f"{impl}: boot")
        events, ms = served_events(Client(create_app(ctx)), QUERIES)
        ann = ctx.index._ivf
        check(ann is not None and ctx.index.search_impl == impl, f"{impl}: no ANN index was built")
        top1 = ctx.index.search_raw(frame_q, 1)[1][:, 0]
        if impl == "ivf":
            bad = 0
            for got, ref in zip(events, exact_events):
                cut = ref[min(9, len(ref) - 1)][2]
                ref_score = {(v, i): sc for v, i, sc in ref}
                got_score = {(v, i): sc for v, i, sc in got}
                for key in set(ref_score) ^ set(got_score):
                    sc = ref_score.get(key, got_score.get(key))
                    bad += int(abs(sc - cut) > ANN_FULL_PROBE_NOISE)
                for key in set(ref_score) & set(got_score):
                    bad += int(abs(ref_score[key] - got_score[key]) > ANN_FULL_PROBE_NOISE)
            log(f"ann serving ivf ({ann.n_clusters} lists, nprobe {ctx.index.ivf_nprobe}, pool "
                f"{ann._overflow_size} rows): served events vs exact: {bad} differences beyond "
                f"{ANN_FULL_PROBE_NOISE}")
            check(bad == 0, f"ivf at a full probe: {bad} served events differ from the exact path's")
        agree = int((top1 == exact_top1).sum())
        # exact scores of each query's exact top-1 and of the tier's top-1
        exact_sc = frame_q @ emb.T
        gap = exact_sc[np.arange(len(picks)), exact_top1] - exact_sc[np.arange(len(picks)), top1]
        log(f"ann serving {impl}: top-1 of {len(picks)} perturbed frames equal to the exact "
            f"path's: {agree}, the others {gap[top1 != exact_top1].tolist()} below the exact top-1 "
            f"score; /api/search p50 {statistics.median(ms):.2f} ms")
        if impl == "ivfpq":
            check(ann._originals is None and ann._originals_int8 is not None,
                  "ivfpq host store: fp32 originals kept or no int8 store")
        band = ANN_INT8_NOISE if impl == "ivfpq" else ANN_FULL_PROBE_NOISE
        check(bool((gap <= band).all()), f"{impl}: a top-1 scored {gap.max()} below the exact top-1")
        out[impl] = statistics.median(ms)
    log(f"ann serving: {time.perf_counter() - t0:.1f} s")
    return out


def phase_ann_large(torch):
    """The large IVF-PQ tier with K7: ANN_ROWS seeded clustered unit rows of
    512 on the card, ``IVFPQIndex.build_device`` (packed, 2,048 lists, S =
    64, K = 256), built twice from the same seed (identical codes); ANN_B
    perturbed corpus rows searched at nprobe = ANN_NPROBE with K7 and with
    the gather-sum (identical rows, scores within 1e-4 / 1e-5); recall@10
    against the exact top-10, with and without an int8 host re-rank of 50;
    one full probe through K7; the query p50 of both; K7's launches over the
    phase's searches."""
    import numpy as np

    from evr_tpu_torch.index import IVFPQIndex
    from evr_tpu_torch.index.ivf import chunk_rows, probe_lists
    from evr_tpu_torch.index.pq import adc_tables
    from evr_tpu_torch.ops.adc import adc_list_scores
    from evr_tpu_torch.ops.topk import cosine_topk

    t0 = time.perf_counter()
    x = clustered_unit_rows(torch, ANN_ROWS, ANN_DIM, ANN_CENTRES, seed=11)
    torch.cuda.synchronize()
    log(f"ann large: {ANN_ROWS} x {ANN_DIM} fp32 rows ({x.numel() * 4 / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.2f} s")
    kw = dict(n_clusters=ANN_LISTS, n_subspaces=64, n_centroids=256, capacity_factor=1.5)
    builds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = IVFPQIndex().build_device(x, **kw)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0, idx))
    (build_s, idx), (build2_s, idx2) = builds
    same = bool(torch.equal(idx.codes_lists, idx2.codes_lists)) and bool(
        torch.equal(idx.id_lists, idx2.id_lists)) and bool(torch.equal(idx.centroids, idx2.centroids))
    del idx2, builds
    o = int(idx.overflow.shape[0])
    log(f"ann large build: {build_s:.2f} s and {build2_s:.2f} s; capacity {idx._capacity}, pool "
        f"{o} rows ({o / ANN_ROWS:.4%}), codes {idx.codes_lists.numel() / 1e6:.1f} MB; "
        f"second build identical: {same}")
    check(same, "a second build with the same seed gave other codes, ids or centroids")
    check(idx._capacity == ANN_CAPACITY, f"capacity {idx._capacity}, expected {ANN_CAPACITY}")

    qrows = (torch.arange(ANN_B, device="cuda") * 2 + 1) * (ANN_ROWS // (2 * ANN_B))
    q = perturbed(torch, x, qrows, ANN_QUERY_PERTURB / math.sqrt(ANN_DIM), seed=12)
    _, exact_rows = cosine_topk(x, torch.from_numpy(q).cuda(), 0, ANN_ROWS, 10)
    exact_rows = exact_rows.cpu().numpy()
    sc, scl = [], []
    for lo in range(0, ANN_ROWS, 1 << 20):
        r8, s8 = quantize_host_rows(torch, x[lo:lo + (1 << 20)])
        sc.append(r8)
        scl.append(s8)
    idx.attach_host_store(np.concatenate(sc), np.concatenate(scl))
    del sc, scl

    def recall(rows):
        return float(np.mean([len(set(r) & set(e)) / 10 for r, e in zip(rows, exact_rows)]))

    chunk = chunk_rows(ANN_B * idx._capacity * 64)  # probes per K7 launch (ivfpq.py)
    per_search = -(-ANN_NPROBE // chunk)
    adc_list_scores.launches = 0
    results = {}
    for impl in ("pallas", "xla"):
        for rerank in (None, 50):
            results[(impl, rerank)] = idx.search(q, 10, nprobe=ANN_NPROBE, rerank=rerank, adc_impl=impl)
    # a full probe: every list, ceil(lists / chunk) launches, the gathered
    # codes bounded by the chunk
    t1 = time.perf_counter()
    sf, rf = idx.search(q, 10, nprobe=ANN_LISTS, adc_impl="pallas")
    full_ms = (time.perf_counter() - t1) * 1e3
    check(bool(np.isfinite(sf).all()) and bool((rf >= 0).all()) and bool((np.diff(sf, axis=1) <= 0).all()),
          "ann large: the full-probe search returned non-finite, missing or unsorted results")
    lat = {}
    for impl in ("pallas", "xla"):
        ts = []
        for _ in range(ANN_TIMED):
            t1 = time.perf_counter()
            idx.search(q, 10, nprobe=ANN_NPROBE, adc_impl=impl)
            ts.append((time.perf_counter() - t1) * 1e3)
        lat[impl] = statistics.median(ts)
    launches = adc_list_scores.launches
    expected = (2 + ANN_TIMED) * per_search + -(-ANN_LISTS // chunk)
    (sp, rp), (sx, rx) = results[("pallas", None)], results[("xla", None)]
    err = float(np.abs(sp - sx).max())
    log(f"ann large search B={ANN_B} nprobe={ANN_NPROBE} top 10: K7 vs gather-sum rows equal "
        f"{np.array_equal(rp, rx)}, max score difference {err:.3e}; recall@10 {recall(rp):.4f} "
        f"(re-rank 50: {recall(results[('pallas', 50)][1]):.4f}); query p50 K7 {lat['pallas']:.3f} ms, "
        f"gather-sum {lat['xla']:.3f} ms; a full probe of {ANN_LISTS} lists {full_ms:.1f} ms, "
        f"recall@10 {recall(rf):.4f}; K7 launches {launches} (expected {expected}: {per_search} a "
        f"search at nprobe {ANN_NPROBE}, {2 + ANN_TIMED} such searches, {-(-ANN_LISTS // chunk)} "
        f"for the full probe)")
    check(np.array_equal(rp, rx), "ann large: the pallas (K7) and xla searches returned other rows")
    check(bool(np.allclose(sp, sx, rtol=1e-4, atol=1e-5)), f"ann large: scores differ by {err}")
    check(np.array_equal(results[("pallas", 50)][1], results[("xla", 50)][1]),
          "ann large: re-ranked rows differ between the two impls")
    check(launches == expected > 0, f"adc_list_scores: {launches} launches, expected {expected}")

    # K7 against its plain version at the path's own inputs: the probed
    # blocks and the tables of this search
    with torch.no_grad():
        qt = torch.from_numpy(q).cuda()
        cids = probe_lists(qt, idx.centroids, ANN_NPROBE)[2]
        blocks = idx.codes_lists.view(idx.n_clusters, idx._capacity, 64)[cids].reshape(
            -1, idx._capacity, 64)
        tables = adc_tables(qt, idx.codebooks)
    err_path = adc_compare(torch, blocks, tables, ANN_NPROBE, "on the search's probed blocks")
    del x, idx
    torch.cuda.empty_cache()
    return {"build_s": build_s, "build2_s": build2_s, "pool": o, "launches": launches,
            "recall": recall(rp), "recall_rerank": recall(results[("pallas", 50)][1]),
            "p50_pallas": lat["pallas"], "p50_xla": lat["xla"], "max_abs_err": err_path,
            "blocks": blocks, "tables": tables}


def quantize_host_rows(torch, rows):
    """(int8 rows, fp32 scales) on the host: the int8 re-rank store."""
    scale = (rows.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127).to(torch.int8)
    return q.cpu().numpy(), scale.cpu().numpy()


def phase_times_adc(torch, blocks, tables):
    """K7 at the path's shape (P = 256, C = 3,072, S = 64, K = 256, B = 8),
    its plain version, and a library expression of the same function: each
    block's query table expanded over C, gathered at the codes, summed."""
    from evr_tpu_torch.ops.adc import adc_list_scores, adc_list_scores_plain

    p, c, s = blocks.shape
    b, _, k = tables.shape
    nprobe = p // b
    owner = torch.arange(p, device="cuda") // nprobe

    def library():
        t = tables[owner][:, None].expand(p, c, s, k)
        return torch.gather(t, 3, blocks.long()[..., None])[..., 0].sum(dim=2)

    nbytes = p * c * s + b * s * k * 4 + p * c * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = p * c * s / H100_FP32_FLOPS * 1e3
    desc = f"{nbytes / 1e6:.1f} MB, {p * c * s / 1e6:.1f} M fp32 adds"
    return time_case(
        torch, "adc_list_scores", f"P={p} C={c} S={s} K={k} B={b}",
        lambda: adc_list_scores(blocks, tables, nprobe),
        lambda: adc_list_scores_plain(blocks, tables, nprobe), library, t_ops, t_bytes, desc,
        (adc_list_scores,))


def phase_index_tool(torch):
    """``tools.index_tool.main``: ``build --type ivfpq --streamed`` (the
    paired layout) with the int8 host store over a TOOL_ROWS-row .npy, then
    ``query`` with a re-rank; its JSON lines against a direct search of the
    same index."""
    import contextlib
    import io

    import numpy as np

    from evr_tpu_torch.index import IVFPQIndex
    from evr_tpu_torch.tools import index_tool

    x = clustered_unit_rows(torch, TOOL_ROWS, ANN_DIM, 1024, seed=21)
    q = perturbed(torch, x, torch.arange(0, TOOL_ROWS, TOOL_ROWS // 8, device="cuda"),
                  ANN_QUERY_PERTURB / math.sqrt(ANN_DIM), seed=22)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.save(tmp / "emb.npy", x.cpu().numpy())
        np.save(tmp / "q.npy", q)
        del x
        runs = {}
        for name, argv in (
            ("build", ["build", "--embeddings", str(tmp / "emb.npy"), "--type", "ivfpq",
                       "--streamed", "--out", str(tmp / "idx.npz"), "--host-store",
                       str(tmp / "store"), "--device", "cuda"]),
            ("query", ["query", "--index", str(tmp / "idx.npz"), "--type", "ivfpq",
                       "--query-embeddings", str(tmp / "q.npy"), "--top-k", "10", "--nprobe", "32",
                       "--rerank", "50", "--host-store", str(tmp / "store"), "--device", "cuda"]),
        ):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                index_tool.main(argv)
            runs[name] = ([json.loads(line) for line in buf.getvalue().splitlines()],
                          time.perf_counter() - t0)
        built = runs["build"][0][-1]
        check(built["streamed"] and built["rows"] == TOOL_ROWS, f"index_tool build: {built}")
        lines = runs["query"][0]
        check(len(lines) == len(q) + 1 and lines[-1]["queries"] == len(q),
              f"index_tool query printed {len(lines)} lines")
        idx = IVFPQIndex.load(tmp / "idx.npz", device="cuda")
        check(idx._paired, "index_tool --streamed did not give the paired layout")
        idx.attach_host_store(np.load(tmp / "store.rows.npy"), np.load(tmp / "store.scales.npy"))
        _, rows = idx.search(q, 10, nprobe=32, rerank=50)
        for qi, line in enumerate(lines[:-1]):
            check([h["row"] for h in line["hits"]] == [int(r) for r in rows[qi] if r >= 0],
                  f"index_tool query {qi}: rows differ from a direct search")
    log(f"index_tool: build {json.dumps(built)} in {runs['build'][1]:.2f} s; query of {len(q)} "
        f"in {runs['query'][1]:.2f} s ({lines[-1]['batch_ms']} ms search), rows equal to a direct "
        f"search")
    return {"build_s": runs["build"][1], "query_s": runs["query"][1]}


# -- 9. the flash route: ViT-H-14 ---------------------------------------------


def flash_params():
    """ViT-H-14 under ``attn_impl="flash"`` and its seeded random weights
    (numpy, drawn once for every ViT-H-14 phase)."""
    import numpy as np

    from evr_tpu_torch.models import get_model_config, init_clip_params

    cfg = get_model_config(FLASH_MODEL, attn_impl="flash")
    t0 = time.perf_counter()
    params = init_clip_params(np.random.default_rng(0), cfg)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return int(np.asarray(tree).size)

    log(f"{FLASH_MODEL} (attn_impl=\"flash\"): {count(params) / 1e6:.1f} M random parameters "
        f"(seed 0) drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def phase_main_path_flash(torch, cfg, np_params, params_dtype: str = "float32"):
    """The flash route served: ``EmbeddingEngine(cfg=...)`` with the seeded
    ViT-H-14 weights (or, with ``params_dtype="int8"``, their int8 block
    linears) encodes N_FRAMES synthetic 224² frames at batch BATCH, the data
    root is written, ``ServingContext(engine=...)`` boots and answers
    /api/search; K6a's and K6b's launches against the counts expected (every
    full block of both towers), K1's, K2's, K3a's and K3b's (none), and the
    unit embeddings and rankings against the same path with K6's plain
    version (``attn_impl="flash_plain"``), within the int8 bands on int8
    weights."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    vis = cfg.vision
    frames = synthetic_frames(torch, N_FRAMES, vis.image_size, vis.patch_size)
    t0 = time.perf_counter()
    engine = EmbeddingEngine(FLASH_MODEL, params=np_params, cfg=cfg, device="cuda", batch_size=BATCH,
                             params_dtype=params_dtype)
    log(f"engine: {FLASH_MODEL}, attn_impl={engine.cfg.attn_impl!r}, {params_dtype} weights, "
        f"{engine.compute_dtype}, set up in {time.perf_counter() - t0:.1f} s")
    counted = [fa.flash_attention_full, fa.flash_attention_blocked, bf.fused_attn_block,
               bf.fused_mlp_block, bf.fused_attn_block_q, bf.fused_mlp_block_q]
    what = f"{FLASH_MODEL} flash" + (" int8" if params_dtype == "int8" else "")
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), counted)
        n_batches, n_text = -(-N_FRAMES // BATCH), len(QUERIES)
        expected = {"flash_attention_full": (vis.layers - 1) * n_batches,
                    "flash_attention_blocked": (cfg.text.layers - 1) * n_text,
                    "fused_attn_block": 0, "fused_mlp_block": 0, "fused_attn_block_q": 0,
                    "fused_mlp_block_q": 0}
        log(f"launches over the {what} path: {launches} (expected {expected}: "
            f"{vis.layers - 1} full vision blocks per encode batch, {n_batches} batches; "
            f"{cfg.text.layers - 1} full text blocks per text encode, {n_text} encodes)")
        for name, n in expected.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
        if params_dtype == "int8":
            bands = (INT8_ONE_VECTOR_RANK_NOISE, INT8_SERVED_RANK_NOISE, what, "flash_plain",
                     VITH_INT8_MIN_COS)
        else:
            bands = (FLASH_ONE_VECTOR_RANK_NOISE, FLASH_SERVED_RANK_NOISE, what, "flash_plain")
        diffs = check_against_plain(torch, engine, frames, emb, *bands)
        p50 = text_query_p50_ms(engine, ctx)
        del ctx
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_frames_per_s": N_FRAMES / encode_s,
            "text_query_p50_ms": p50, "request_p50_ms": statistics.median(request_ms),
            "against_plain": diffs}


def block_leaf(key: str) -> bool:
    return key.startswith(("clip/visual/blocks/", "clip/text/blocks/"))


def phase_train_flash(torch, cfg, np_params):
    """The flash route trained: FLASH_TRAIN_STEPS steps of ``make_train_step``
    (the step ``Trainer`` runs) on ViT-H-14 at full width, batch 32, bf16,
    ``freeze_layers=8``, InfoNCE + 0.2 × CE, on a synthetic caption set. K6
    launches in the forward of every block (K6a in the vision tower, K6b in
    the causal text tower); the backward is the plain recompute
    (``xla_attention``) with no kernel and no plain forward; finite losses;
    frozen leaves bit-unchanged and trainable ones moved. Then one step from
    the same params and batch through K6 and through its plain version
    (``attn_impl="flash_plain"``), fp32 and bf16, held within bands that a
    gradient perturbed to cosine 0.99 fails; the step time."""
    import dataclasses

    import numpy as np

    from evr_tpu_torch.models import params_from_numpy
    from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.training import (
        CaptionDataset, TrainConfig, TrainState, make_grad_fn, make_optimizer, make_train_step,
        param_group_labels,
    )
    from evr_tpu_torch.training.finetune import flat_leaves

    cls_cfg = ClassifierConfig(embed_dim=cfg.embed_dim)
    init = {"clip": np_params, "classifier": init_classifier_params(1, cls_cfg)}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        train_json, _ = write_caption_set(root, cfg.vision.image_size, cfg.vision.patch_size)
        batches = list(CaptionDataset(train_json, root).batches(
            TRAIN_BATCH, cfg.vision.image_size, seed=0))[:FLASH_TRAIN_STEPS]
    check(len(batches) == FLASH_TRAIN_STEPS, f"{len(batches)} caption batches")
    tc = TrainConfig(seed=0, batch_size=TRAIN_BATCH, epochs=1, compute_dtype="bfloat16",
                     freeze_layers=8)
    params = params_from_numpy(init, "cuda")
    opt = make_optimizer(tc, params, len(batches))
    step, _ = make_train_step(cfg, cls_cfg, tc, opt)
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    recompute, plain_fwd = counting(fa.xla_attention), counting(fa.flash_attention_plain)
    fa.xla_attention, fa.flash_attention_plain = recompute, plain_fwd
    counted = [fa.flash_attention_full, fa.flash_attention_blocked, bf.fused_attn_block,
               bf.fused_mlp_block, bf.fused_attn_block_bwd, bf.fused_mlp_block_bwd, recompute,
               plain_fwd]
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in counted:
            fn.launches = 0
        times, losses = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["total_loss"].item())
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:
        fa.xla_attention, fa.flash_attention_plain = recompute.__wrapped__, plain_fwd.__wrapped__
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(batches)
    blocks = cfg.vision.layers + cfg.text.layers
    expected = {"flash_attention_full": cfg.vision.layers * n, "flash_attention_blocked": cfg.text.layers * n,
                "xla_attention": blocks * n}
    log(f"{FLASH_MODEL} flash training launches over {n} steps: {launches} (expected {expected}, "
        f"every other count 0); losses {[round(v, 6) for v in losses]}")
    for name, count in launches.items():
        check(count == expected.get(name, 0), f"{name}: {count} launches, expected {expected.get(name, 0)}")
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")

    labels = flat_leaves(param_group_labels(state.params, tc.freeze_layers))
    want, got = flat_leaves(init), flat_leaves(state.params)
    frozen = [k for k in labels if labels[k] == "frozen"]
    moved = [k for k in frozen if not torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(want[k])))]
    stale = [k for k in labels if labels[k] != "frozen"
             and torch.equal(got[k].cpu(), torch.from_numpy(np.asarray(want[k])))]
    log(f"{FLASH_MODEL} flash training: {len(frozen)} frozen leaves, {len(moved)} of them moved; "
        f"{len(labels) - len(frozen)} trainable leaves, {len(stale)} of them unmoved")
    check(len(frozen) == 16 and not moved, f"frozen leaves moved: {moved}")
    check(not stale, f"trainable leaves did not move: {stale[:5]}")
    del state, params, opt, got
    torch.cuda.empty_cache()

    # one step from the same params and batch: K6 against its plain version
    params = params_from_numpy(init, "cuda")
    plain_cfg = dataclasses.replace(cfg, attn_impl="flash_plain")
    compared = {}
    for dtype in ("float32", "bfloat16"):
        tcd = dataclasses.replace(tc, compute_dtype=dtype)
        fn_k, fn_p = make_grad_fn(cfg, cls_cfg, tcd), make_grad_fn(plain_cfg, cls_cfg, tcd)
        m_k, grads_k = fn_k(params, batches[0], torch.Generator(device="cuda").manual_seed(1))
        m_p, grads_p = fn_p(params, batches[0], torch.Generator(device="cuda").manual_seed(1))
        compared[dtype] = step_compare(
            torch, f"{FLASH_MODEL} K6 step vs plain step, {dtype}", m_k, m_p, grads_k, grads_p,
            (lambda k: True) if dtype == "float32" else block_leaf)
        del grads_k, grads_p
    del params
    torch.cuda.empty_cache()
    for dtype, bands in (("float32", FLASH_STEP_FP32_BANDS), ("bfloat16", FLASH_STEP_BF16_BANDS)):
        step_check(f"{FLASH_MODEL} K6 step vs plain step, {dtype}", compared[dtype], bands)
    step_s = statistics.median(times)
    log(f"{FLASH_MODEL} flash train step (batch {TRAIN_BATCH}, bf16): {[round(t, 4) for t in times]} s, "
        f"median {step_s:.4f} s = {TRAIN_BATCH / step_s:.2f} samples/s; peak memory {peak:.1f} GiB")
    return {"launches": launches, "step_s": step_s, "samples_per_s": TRAIN_BATCH / step_s,
            "peak_gib": peak, "compared": compared}


# -- 10. ViT-H-14 under its default route -----------------------------------


def phase_main_path_vith(torch, np_params, params_dtype: str = "float32"):
    """ViT-H-14 served under its default configuration:
    ``EmbeddingEngine(FLASH_MODEL, params=..., device="cuda")`` with no
    ``cfg``, so ``attn_impl="auto"`` sends every full block of both towers
    (vision W 1280, 16 heads of 80, exact GELU; text W 1024, 16 heads of 64)
    to K1 and K2, or with ``params_dtype="int8"`` to K3a and K3b. The path of
    phase 4 over the seeded ViT-H-14 weights; the launches of the route's
    pair against the counts expected, of the other pair and of K6 (none);
    embeddings and rankings against ``attn_impl="plain"`` within the bf16
    (int8) bands."""
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.ops import attention as fa
    from evr_tpu_torch.ops import block_fused as bf

    t0 = time.perf_counter()
    engine = EmbeddingEngine(FLASH_MODEL, params=np_params, device="cuda", batch_size=BATCH,
                             params_dtype=params_dtype)
    cfg = engine.cfg
    check(cfg.attn_impl == "auto", f"{FLASH_MODEL}'s default attn_impl is {cfg.attn_impl!r}")
    int8 = params_dtype == "int8"
    what = f"{FLASH_MODEL} auto " + ("int8" if int8 else "bf16")
    log(f"engine: {FLASH_MODEL}, default configuration (attn_impl={cfg.attn_impl!r}), {params_dtype} "
        f"weights, {engine.compute_dtype}, set up in {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames(torch, N_FRAMES, cfg.vision.image_size, cfg.vision.patch_size)
    route = [bf.fused_attn_block_q, bf.fused_mlp_block_q] if int8 else [bf.fused_attn_block, bf.fused_mlp_block]
    other = [bf.fused_attn_block, bf.fused_mlp_block] if int8 else [bf.fused_attn_block_q, bf.fused_mlp_block_q]
    counted = route + other + [fa.flash_attention_full, fa.flash_attention_blocked]
    with tempfile.TemporaryDirectory() as tmp:
        emb, ctx, encode_s, request_ms, launches = serve_counted(
            torch, engine, frames, pathlib.Path(tmp), counted)
        n_batches, n_text = -(-N_FRAMES // BATCH), len(QUERIES)
        per_route = (cfg.vision.layers - 1) * n_batches + (cfg.text.layers - 1) * n_text
        expected = {fn.__name__: per_route if fn in route else 0 for fn in counted}
        log(f"launches over the {what} path: {launches} (expected {expected}: "
            f"{cfg.vision.layers - 1} full vision blocks per encode batch, {n_batches} batches; "
            f"{cfg.text.layers - 1} full text blocks per text encode, {n_text} encodes)")
        for name, n in expected.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, expected {n}")
        if int8:
            bands = (INT8_ONE_VECTOR_RANK_NOISE, INT8_SERVED_RANK_NOISE, what, "plain", VITH_INT8_MIN_COS)
        else:
            bands = (ONE_VECTOR_RANK_NOISE, SERVED_RANK_NOISE, what, "plain")
        diffs = check_against_plain(torch, engine, frames, emb, *bands)
        p50 = text_query_p50_ms(engine, ctx)
        del ctx
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_frames_per_s": N_FRAMES / encode_s,
            "text_query_p50_ms": p50, "request_p50_ms": statistics.median(request_ms),
            "against_plain": diffs}


# -- 11. K8 and K9, the exported ops -----------------------------------------


def ln_inputs(torch, rows: int, d: int, seed: int):
    """x [rows, d] of unit variance, scale about 1 and bias about 0 (fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = unit_activations(torch, (rows, d), gen, "cuda")
    scale = 1.0 + torch.randn(d, generator=gen, device="cuda") * 0.1
    bias = torch.randn(d, generator=gen, device="cuda") * 0.1
    return x, scale, bias


def phase_layer_norm(torch):
    """K8 through the entry point a user calls, ``ops.fused_layer_norm``
    (no tower calls it, as in the JAX package): every LN_CASES case, bf16
    and fp32, with and without the quickGELU tail, its launches counted over
    that run alone; then each output against the plain version on the same
    inputs (fp32 FP32_TOL, bf16 BF16_TOL); zero rows; the times at
    LN_MAIN_CASE in bf16 against ``F.layer_norm`` (and the tail)."""
    import torch.nn.functional as F

    from evr_tpu_torch import ops
    from evr_tpu_torch.ops import layernorm as ln

    inputs = {tag: ln_inputs(torch, rows, d, seed=12) for tag, (rows, d) in LN_CASES.items()}
    cases = [(tag, dt, act) for tag in LN_CASES for dt in (torch.bfloat16, torch.float32)
             for act in ("none", "quick_gelu")]
    ln.fused_layer_norm.launches = 0
    outs = [ops.fused_layer_norm(inputs[tag][0].to(dt), *inputs[tag][1:], activation=act)
            for tag, dt, act in cases]
    torch.cuda.synchronize()
    launches = ln.fused_layer_norm.launches
    log(f"fused_layer_norm launches over its {len(cases)} calls: {launches}")
    check(launches == len(cases), f"fused_layer_norm: {launches} launches, expected {len(cases)}")
    worst = 0.0
    for (tag, dt, act), got in zip(cases, outs):
        x, scale, bias = inputs[tag]
        ref = ln.fused_layer_norm_plain(x.to(dt), scale, bias, act)
        err, cos, finite = compare(torch, got, ref)
        name = f"fused_layer_norm {tag} {act} {str(dt).split('.')[-1]}"
        log(f"parity {name}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
        check(got.dtype == dt and got.shape == x.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
        check(finite, f"{name}: non-finite output")
        tol = FP32_TOL if dt == torch.float32 else BF16_TOL
        check(err <= tol, f"{name}: max abs err {err} > {tol}")
        if dt == torch.bfloat16:
            worst = max(worst, err)
    empty = ops.fused_layer_norm(torch.empty((0, 768), device="cuda", dtype=torch.bfloat16),
                                 *inputs["vitb-vision"][1:])
    check(empty.shape == (0, 768) and ln.fused_layer_norm.launches == launches, "zero rows")
    del outs

    rows, d = LN_CASES[LN_MAIN_CASE]
    x32, scale, bias = inputs[LN_MAIN_CASE]
    x = x32.to(torch.bfloat16)
    s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    times = {}
    for act, ops_per in (("none", 8), ("quick_gelu", 13)):
        def lib(act=act):
            y = F.layer_norm(x, (d,), s16, b16, 1e-5)
            return y * torch.sigmoid(1.702 * y) if act == "quick_gelu" else y

        nbytes = 2 * rows * d * 2 + 2 * d * 4
        flops = ops_per * rows * d
        times[act] = time_case(
            torch, "fused_layer_norm", f"{LN_MAIN_CASE} {act} bf16 {rows} x {d}",
            lambda act=act: ops.fused_layer_norm(x, scale, bias, activation=act),
            lambda act=act: ln.fused_layer_norm_plain(x, scale, bias, act), lib,
            flops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3,
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP fp32", (ln.fused_layer_norm,))
    return {"launches": launches, "max_abs_err": worst, "times": times}


def phase_merged(torch):
    """K9 through the entry point a user calls, ``fused_block_merged`` (no
    tower calls it, as in the JAX package), at MERGED_SHAPES, bf16 and fp32,
    its launches counted over that run alone; each output bit-equal to
    ``fused_block_apply`` (K1 then K2) on the same inputs and within the
    K1/K2 tolerances of the plain version; the times at each shape (bf16)
    against the K1 + K2 pair, the plain version and the library composition
    of the two halves."""
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    blocks = {}
    for tag, s in MERGED_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(13)
        p = block_params(torch, s["W"], gen, dev)
        blocks[tag] = (p, unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev))
    cases = [(tag, dt) for tag in MERGED_SHAPES for dt in (torch.bfloat16, torch.float32)]

    def run(fn, tag, dt):
        s = MERGED_SHAPES[tag]
        p, x32 = blocks[tag]
        return fn(x32.to(dt), p, s["H"], s.get("act", "quick_gelu"), s["causal"])

    bf.fused_block_merged.launches = 0
    outs = [run(bf.fused_block_merged, tag, dt) for tag, dt in cases]
    torch.cuda.synchronize()
    launches = bf.fused_block_merged.launches
    log(f"fused_block_merged launches over its {len(cases)} calls: {launches}")
    check(launches == len(cases), f"fused_block_merged: {launches} launches, expected {len(cases)}")
    worst = 0.0
    for (tag, dt), got in zip(cases, outs):
        pair = run(bf.fused_block_apply, tag, dt)
        ref = run(bf.fused_block_merged_plain, tag, dt)
        err, cos, finite = compare(torch, got, ref)
        same = bool(torch.equal(got, pair))
        name = f"fused_block_merged {tag} {str(dt).split('.')[-1]}"
        log(f"parity {name}: bit-equal to fused_block_apply {same}; against the plain version "
            f"max_abs_err={err:.3e} min_row_cos={cos:.7f}")
        check(same, f"{name}: differs from fused_block_apply (K1 then K2)")
        check(finite, f"{name}: non-finite output")
        if dt == torch.float32:
            check(err <= FP32_TOL, f"{name}: max abs err {err} > {FP32_TOL}")
        else:
            check(err <= BF16_TOL, f"{name}: max abs err {err} > {BF16_TOL}")
            check(cos >= BF16_MIN_COS, f"{name}: row cosine {cos} < {BF16_MIN_COS}")
            if tag == "vision":
                worst = max(worst, err)
        del pair, ref
    del outs

    dt = torch.bfloat16
    counted = (bf.fused_block_merged, bf.fused_attn_block, bf.fused_mlp_block)
    recs, pair_ms = {}, {}
    for tag, s in MERGED_SHAPES.items():
        p32, x32 = blocks[tag]
        x = x32.to(dt)
        p = {k: {n: (v.to(dt) if torch.is_tensor(v) else {m: t.to(dt) for m, t in v.items()})
                 for n, v in g.items()} for k, g in p32.items()}
        act = s.get("act", "quick_gelu")
        attn, mlp = bf.block_half_params(p)
        lib_attn, lib_mlp = library_halves(torch, attn, mlp, s)
        saved = [c.launches for c in counted]
        pair_ms[tag] = min(cuda_ms(torch, lambda: bf.fused_block_apply(x, p, s["H"], act, s["causal"]))
                           for _ in range(2))
        for c, n in zip(counted, saved):
            c.launches = n
        t_ops = sum(half_bound_ms(n, s, 2)[0] for n in ("fused_attn_block", "fused_mlp_block"))
        nbytes = (2 * s["B"] * s["T"] * s["W"] + 12 * s["W"] ** 2 + 13 * s["W"]) * 2
        recs[tag] = time_case(
            torch, "fused_block_merged", f"{tag} bf16",
            lambda: bf.fused_block_merged(x, p, s["H"], act, s["causal"]),
            lambda: bf.fused_block_merged_plain(x, p, s["H"], act, s["causal"]), lambda: lib_mlp(lib_attn(x)),
            t_ops, nbytes / H100_BYTES_PER_S * 1e3,
            f"{t_ops:.4f} ms of K1's and K2's operations, {nbytes / 1e6:.1f} MB", counted)
        log(f"time fused_block_merged {tag} bf16: the K1 + K2 pair (fused_block_apply) {pair_ms[tag]:.4f} ms")
    return {"launches": launches, "max_abs_err": worst, "times": recs["vision"], "pair_ms": pair_ms}


# -- main --------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    try:
        from evr_tpu_torch.models import get_model_config
    except ImportError as e:
        print(f"chip_smoke: the evr_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_build()
        gemm = phase_gemm(torch)
        worst = phase_parity(torch)
        core_worst = phase_parity_core(torch)
        worst.update(phase_parity_int8(torch))
        worst["fused_topk"] = phase_parity_topk(torch)
        worst.update(phase_parity_bwd(torch))
        worst["adc_list_scores"] = phase_parity_adc(torch)
        worst.update(phase_parity_flash(torch))
        vis = get_model_config(MODEL).vision
        frames = synthetic_frames(torch, N_FRAMES, vis.image_size, vis.patch_size)
        t0 = time.perf_counter()
        main = phase_main_path(torch, frames, then=lambda e, r: phase_ann_serving(torch, e, r))
        main_q = phase_main_path_int8(torch, frames)
        train = phase_train(torch)
        times = phase_times(torch)
        times[("fused_topk", "vision")] = phase_times_topk(torch)
        times.update(phase_times_train(torch, gemm))
        core = phase_times_core(torch)
        log("K1/K2 bf16 at ViT-L/14@336px (vitl) and ViT-H-14 (vith): " + ", ".join(
            f"{n} {sh} {times[(n, sh)]['ms']:.4f} ms (library {times[(n, sh)]['library_ms']:.4f})"
            for sh in ("vitl", "vith") for n in ("fused_attn_block", "fused_mlp_block")))
        log("K1's attention core alone (attn_forward, bf16): " + ", ".join(
            f"{sh} {core[sh]['ms']:.4f} ms of K1's "
            f"{times[('fused_attn_block', 'vision' if sh == 'vitb' else sh)]['ms']:.4f} "
            f"(SDPA {core[sh]['library_ms']:.4f}, bound {core[sh]['bound_ms']:.4f})"
            for sh in ("vith", "vitl", "vitb")) + f"; text {core['text']['ms']:.4f} ms "
            f"(SDPA {core['text']['library_ms']:.4f}); parity max abs err {core_worst:.3e}")
        t1 = time.perf_counter()
        ann = phase_ann_large(torch)
        worst["adc_list_scores"] = max(worst["adc_list_scores"], ann["max_abs_err"])
        times[("adc_list_scores", "vision")] = phase_times_adc(torch, ann.pop("blocks"), ann.pop("tables"))
        tool = phase_index_tool(torch)
        ann_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        flash_cfg, flash_np = flash_params()
        main_f = phase_main_path_flash(torch, flash_cfg, flash_np)
        main_fq = phase_main_path_flash(torch, flash_cfg, flash_np, params_dtype="int8")
        train_f = phase_train_flash(torch, flash_cfg, flash_np)
        times.update(phase_times_flash(torch))
        flash_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        main_h = phase_main_path_vith(torch, flash_np)
        main_hq = phase_main_path_vith(torch, flash_np, params_dtype="int8")
        del flash_np
        vith_s = time.perf_counter() - t3
        k8 = phase_layer_norm(torch)
        k9 = phase_merged(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for tag, m in (("bf16", main), ("int8", main_q)):
        log(f"main path {tag}: encode {m['encode_frames_per_s']:.1f} frames/s "
            f"(batch {BATCH}, {N_FRAMES} frames), text query p50 "
            f"{m['text_query_p50_ms']:.2f} ms, /api/search p50 {m['request_p50_ms']:.2f} ms")
    log(f"main path training: {TRAIN_MODEL}, batch {TRAIN_BATCH}, bf16: step {train['step_s']:.4f} s, "
        f"{train['samples_per_s']:.2f} samples/s; checkpoint saves {json.dumps(train['checkpoint_s'])} s; "
        f"kernel vs plain step: {json.dumps(train['compared'])}")
    split = times["k5a_split"]
    log(f"K5 at {TRAIN_MODEL}, bf16: K5a {times[('fused_attn_block_bwd', 'vitl')]['ms']:.4f} ms (attention "
        f"backward {split['attention_ms']:.4f}, GEMMs {split['gemm_ms']:.4f}, rest {split['rest_ms']:.4f}), "
        f"K5b {times[('fused_mlp_block_bwd', 'vitl')]['ms']:.4f} ms")
    log(f"ann tiers: /api/search p50 ivf {main['then']['ivf']:.2f} ms, ivfpq (host store) "
        f"{main['then']['ivfpq']:.2f} ms; large IVF-PQ ({ANN_ROWS} x {ANN_DIM}, {ANN_LISTS} lists): "
        f"build {ann['build_s']:.2f} s, pool {ann['pool']} rows, recall@10 {ann['recall']:.4f} "
        f"(re-rank 50: {ann['recall_rerank']:.4f}), query p50 K7 {ann['p50_pallas']:.3f} ms / "
        f"gather-sum {ann['p50_xla']:.3f} ms at nprobe {ANN_NPROBE}, B {ANN_B}; index_tool build "
        f"{tool['build_s']:.2f} s, query {tool['query_s']:.2f} s; the large tier and the tool took "
        f"{ann_s:.1f} s")
    log(f"flash route, {FLASH_MODEL}: encode {main_f['encode_frames_per_s']:.1f} frames/s (batch {BATCH}, "
        f"{N_FRAMES} frames), text query p50 {main_f['text_query_p50_ms']:.2f} ms, /api/search p50 "
        f"{main_f['request_p50_ms']:.2f} ms; against K6's plain version {json.dumps(main_f['against_plain'])}; "
        f"train step (batch {TRAIN_BATCH}, bf16) {train_f['step_s']:.4f} s, {train_f['samples_per_s']:.2f} "
        f"samples/s, peak {train_f['peak_gib']:.1f} GiB; K6 step vs plain step {json.dumps(train_f['compared'])}; "
        f"the flash phases took {flash_s:.1f} s")
    log(f"flash route, {FLASH_MODEL}, int8 weights: encode {main_fq['encode_frames_per_s']:.1f} frames/s, "
        f"text query p50 {main_fq['text_query_p50_ms']:.2f} ms, /api/search p50 "
        f"{main_fq['request_p50_ms']:.2f} ms; against K6's plain version {json.dumps(main_fq['against_plain'])}")
    for tag, m in (("bf16", main_h), ("int8", main_hq)):
        log(f"default route (auto), {FLASH_MODEL}, {tag}: encode {m['encode_frames_per_s']:.1f} frames/s "
            f"(batch {BATCH}, {N_FRAMES} frames), text query p50 {m['text_query_p50_ms']:.2f} ms, "
            f"/api/search p50 {m['request_p50_ms']:.2f} ms; against the plain route "
            f"{json.dumps(m['against_plain'])}")
    log(f"the {FLASH_MODEL} default-route phases took {vith_s:.1f} s")
    log("gemm_bf16 TFLOP/s: " + ", ".join(
        f"{tag} {g['tflops']:.1f} (torch.matmul {g['flops'] / g['library_ms'] / 1e9:.1f})"
        for tag, g in gemm.items()))
    log(f"everything after the parity phases {time.perf_counter() - t0:.1f} s, "
        f"the whole script {time.perf_counter() - start:.1f} s")
    launches = {**main["launches"], **main_q["launches"]}
    launches.update({k: train["launches"][k] for k in ("fused_attn_block_bwd", "fused_mlp_block_bwd")})
    launches["adc_list_scores"] = ann["launches"]
    launches.update({k: main_f["launches"][k] for k in FLASH_MAIN_SHAPE})
    # K8 and K9 have no caller on a serving path: their launches are those of
    # their own phases, through the entry points the ops package exports
    launches["fused_layer_norm"] = k8["launches"]
    launches["fused_block_merged"] = k9["launches"]
    worst["fused_layer_norm"] = k8["max_abs_err"]
    worst["fused_block_merged"] = k9["max_abs_err"]
    times[("fused_layer_norm", LN_MAIN_CASE)] = k8["times"]["none"]
    times[("fused_block_merged", "vision")] = k9["times"]
    sources = {
        "fused_attn_block": ("evr_tpu_torch/ops/csrc/block_attn.cu", "evr_tpu/ops/block_fused.py:340"),
        "fused_mlp_block": ("evr_tpu_torch/ops/csrc/block_mlp.cu", "evr_tpu/ops/block_fused.py:1038"),
        "fused_attn_block_q": ("evr_tpu_torch/ops/csrc/block_quant.cu", "evr_tpu/ops/block_fused.py:865"),
        "fused_mlp_block_q": ("evr_tpu_torch/ops/csrc/block_quant.cu", "evr_tpu/ops/block_fused.py:894"),
        "fused_topk": ("evr_tpu_torch/ops/csrc/topk_fused.cu", "evr_tpu/ops/retrieval_pallas.py:142"),
        "fused_attn_block_bwd": ("evr_tpu_torch/ops/csrc/block_attn_bwd.cu", "evr_tpu/ops/block_fused.py:618"),
        "fused_mlp_block_bwd": ("evr_tpu_torch/ops/csrc/block_mlp_bwd.cu", "evr_tpu/ops/block_fused.py:698"),
        "adc_list_scores": ("evr_tpu_torch/ops/csrc/adc_list.cu", "evr_tpu/ops/adc_pallas.py:137"),
        "flash_attention_full": ("evr_tpu_torch/ops/csrc/flash_attn.cu", "evr_tpu/ops/attention.py:188"),
        "flash_attention_blocked": ("evr_tpu_torch/ops/csrc/flash_attn.cu", "evr_tpu/ops/attention.py:224"),
        "fused_layer_norm": ("evr_tpu_torch/ops/csrc/layernorm.cu", "evr_tpu/ops/layernorm.py:58"),
        "fused_block_merged": ("evr_tpu_torch/ops/csrc/block_merged.cu", "evr_tpu/ops/block_fused.py:293"),
    }
    kernels = []
    main_shape = {**FLASH_MAIN_SHAPE, "fused_layer_norm": LN_MAIN_CASE}
    for name, (src, replaces) in sources.items():
        shape = main_shape.get(name, "vitl" if name.endswith("_bwd") else "vision")
        t = times[(name, shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
