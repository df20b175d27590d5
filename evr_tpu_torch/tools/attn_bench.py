"""Hold the attention forward and backward, and the block halves, to their
plain versions and time them, for one or more source trees of the kernels,
on one NVIDIA GPU.

    python -m evr_tpu_torch.tools.attn_bench [--csrc DIR ...] [--parts fwd,bwd,int8,blocks] [--out FILE]

Each ``--csrc`` is an ``ops/csrc`` directory (default: this package's); give
an older tree's too to compare the two on one card in one process. For each
tree three libraries are compiled with ``ops.build``'s nvcc flags, all nvcc
processes started together: the tree's ``flash_attn.cu`` (K6, entry
``evr_flash_attention``), a shim over its ``flash.cuh`` exporting
``launch_flash_fwd``, the attention core of K1, K3a and K9 (the function of
``ops.block_fused.attn_forward``), and a shim exporting its
``flash_backward``, K5a's attention backward (the function of
``ops.block_fused.attn_backward``), so that a tree from before those entries
existed runs through the same device code as the block halves. ``--parts``
picks the forward (``fwd``: K6 and the core), the backward (``bwd``), K3
(``int8``) and K1, K2, K9, K5a and K5b (``blocks``), in any combination (default
``fwd,bwd``).

``int8`` compiles each tree's ``block_quant.cu`` and calls K3a and K3b
(``evr_fused_attn_block_q``, ``evr_fused_mlp_block_q``) through a shim per
tree: a tree whose library exports ``evr_gemm_s8`` (the wgmma int8 GEMM)
takes each int8 kernel as its K-major copy (made once, as the wrapper
does), an older one the kernels as the params hold them.
At INT8_CHECKED's shapes (``chip_smoke.py``'s phase_parity_int8: ViT-B/32's
vision and text shapes, T 577, ViT-H-14's vision shape, the tiny tower's),
bf16 and fp32, quickGELU and exact GELU, every tree that takes a shape must
give the same output bit for bit, and each within ``chip_smoke.py``'s K3
bands of ``fused_*_block_q_plain``; a tree that refuses a shape (returns
-1: the tiny tower before it was taken) is recorded as refusing it. K3a and
K3b are then timed at INT8_TIMED (ViT-B/32 vision and ViT-H-14 vision
serving, bf16), the trees in turns, beside their bound (int8 GEMM
operations at 1,979 TOP/s and the attention at 989 TFLOP/s, against x, out
and the weights at 3.35 TB/s). ``blocks`` compiles each tree's
``block_attn.cu``, ``block_mlp.cu``, ``block_merged.cu``,
``block_attn_bwd.cu`` and ``block_mlp_bwd.cu`` and runs K1, K2, K9, K5a and
K5b through the package's wrappers on each tree's library at
BLOCKS_CHECKED's registry shapes, bf16 and fp32: every tree's output (K5:
dx and every gradient) must equal the first tree's bit for bit.

The backward is checked at every shape in bf16 and fp32 against
``attn_backward_plain``: o's max abs error, and for each of the q, k and v
column blocks of the fp32 dqkv the max abs error relative to the block's
largest entry and the cosine; bf16 within BWD_BF16_O_TOL, BWD_BF16_REL and
BWD_BF16_MIN_COS, fp32 within BWD_FP32_REL. Each tree's bf16 call must
repeat bit for bit, and every tree's fp32 outputs must equal the first
tree's bit for bit (trees that route fp32 to the same kernels). It is timed
at BWD_TIMED beside ``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` on q, k, v views of the same qkv (the
forward outside the timed region) and its bound: 12·d operations per kept
(query, key) pair at 989 TFLOP/s against qkv and do read, o, the fp32 and
bf16 dqkv and the statistics written, at 3.35 TB/s.

At every shape each tree's kernels are checked against their plain versions
(``attn_forward_plain``, ``flash_attention_plain``): bf16 within a max abs
error of 3e-2 and a least row cosine of 0.9999, fp32 within 2e-4, as
``chip_smoke.py`` holds K1 and K6. The timed shapes are then timed by CUDA
events, the trees in turns (first, ..., last, last, ..., first), the better
of each tree's two runs kept, beside ``F.scaled_dot_product_attention`` on
q, k, v views of the same inputs (a yardstick the port never calls) and the
bound: q, k, v read and o written once at 3.35 TB/s against 4·d operations
per (query, key) pair the mask keeps at 989 TFLOP/s (H100 SXM data sheet).
Also printed: the ``HGMMA`` instructions in each attention kernel's own SASS
function (``cuobjdump -sass``) and ptxas's register and spill lines for it.
The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

BF16_TOL, BF16_MIN_COS, FP32_TOL = 3e-2, 0.9999, 2e-4
H100_BF16_FLOPS, H100_BYTES_PER_S = 989e12, 3.35e12

# the core on the packed qkv [B, T, 3W]: (B, T, W, H, causal)
CORE_TIMED = {
    "vith": (256, 257, 1280, 16, False),  # ViT-H-14 vision serving
    "vitl": (32, 577, 1024, 16, False),  # ViT-L/14@336px training
    "vitb": (256, 50, 768, 12, False),  # ViT-B/32 vision serving
    "text": (16, 77, 512, 8, True),  # ViT-B/32 text, causal
}
CORE_CHECKED = {  # beyond the timed ones: key rows past the resident slots, tails
    "long-d64": (2, 1000, 512, 8, False),
    "long-d80-causal": (2, 1000, 640, 8, True),
    "d80-causal": (3, 257, 1280, 16, True),
    "t65": (3, 65, 768, 12, False),
    "t1": (2, 1, 768, 12, True),
}
# K6 on [B, H, T, d]: (B, H, T, d, causal)
K6_TIMED = {
    "vith-vision": (256, 16, 257, 80, False),
    "vith-text": (16, 16, 77, 64, True),
}
# K5a's attention backward on the packed qkv [B, T, 3W] and do [B, T, W]:
# (B, T, W, H, causal), as chip_smoke.py's ATTN_BWD_SHAPES
BWD_TIMED = {
    "vitl": (32, 577, 1024, 16, False),  # ViT-L/14@336px training
    "d80-577": (4, 577, 1280, 16, False),  # head dim 80, a streamed key row
}
BWD_CHECKED = {
    "vitl-text": (16, 77, 768, 12, True),
    "d80-257": (32, 257, 1280, 16, False),
    "long-causal": (2, 1000, 512, 8, True),
}
# the backward's bands against attn_backward_plain, as chip_smoke.py's
# ATTN_BWD_O_TOL, ATTN_BWD_REL and ATTN_BWD_MIN_COS (bf16; on the same
# inputs) and BWD_FP32_REL (fp32)
BWD_BF16_O_TOL, BWD_BF16_REL, BWD_BF16_MIN_COS, BWD_FP32_REL = 8e-3, 4e-3, 0.9999999988, 1.5e-5
K6_CHECKED = {
    "vitb-vision": (256, 12, 50, 64, False),
    "long-d80-causal": (2, 4, 1000, 80, True),
    "t129-d64": (3, 5, 129, 64, False),
}
# K3 on int8 weights: (B, T, W, H, causal, activation), chip_smoke.py's
# phase_parity_int8 shapes, and its bands (INT8_FP32_TOL, BF16_TOL,
# INT8_MIN_COS)
INT8_CHECKED = {
    "vision": (256, 50, 768, 12, False, "quick_gelu"),
    "vision-gelu": (256, 50, 768, 12, False, "gelu"),
    "text": (16, 77, 512, 8, True, "quick_gelu"),
    "vitl": (32, 577, 1024, 16, False, "quick_gelu"),
    "vith": (32, 257, 1280, 16, False, "gelu"),
    "tiny": (256, 17, 64, 4, False, "quick_gelu"),
    "tiny-text-gelu": (16, 77, 64, 4, True, "gelu"),
}
INT8_TIMED = {
    "vision": (256, 50, 768, 12, False, "quick_gelu"),
    "vith": (256, 257, 1280, 16, False, "gelu"),
}
INT8_FP32_TOL, INT8_MIN_COS = 1e-2, 0.99999
H100_INT8_OPS = 1979e12
# K1, K2 and K9 at the registry shapes they ran at before the narrow tiles:
# (B, T, W, H, causal, activation)
BLOCK_LIBS = ("block_attn", "block_mlp", "block_merged", "block_attn_bwd", "block_mlp_bwd")
BLOCKS_CHECKED = {
    "vision": (256, 50, 768, 12, False, "quick_gelu"),
    "text": (16, 77, 512, 8, True, "quick_gelu"),
    "vitl": (32, 577, 1024, 16, False, "quick_gelu"),
    "vith": (32, 257, 1280, 16, False, "gelu"),
}

SHIM = r"""
#include "flash.cuh"
extern "C" int shim_flash_forward(int dtype, const void* qkv, void* o, int B, int T, int W, int H, int causal,
                                  float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return evr::launch_flash_fwd<float>(static_cast<const float*>(qkv), static_cast<float*>(o), B, T, W, H,
                                        causal, scale, s);
  return evr::launch_flash_fwd<evr::bf16>(static_cast<const evr::bf16*>(qkv), static_cast<evr::bf16*>(o), B, T,
                                          W, H, causal, scale, s);
}
"""

BWD_SHIM = r"""
#include "flash.cuh"
extern "C" int shim_flash_backward(int dtype, const void* qkv, const void* dout, void* o, void* st, void* dqkv,
                                   void* dqkv_r, int B, int T, int W, int H, int causal, float scale,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return evr::flash_backward<float>(static_cast<const float*>(qkv), static_cast<const float*>(dout),
                                      static_cast<float*>(o), static_cast<float*>(st), static_cast<float*>(dqkv),
                                      nullptr, B, T, W, H, causal, scale, s);
  return evr::flash_backward<evr::bf16>(static_cast<const evr::bf16*>(qkv), static_cast<const evr::bf16*>(dout),
                                        static_cast<evr::bf16*>(o), static_cast<float*>(st),
                                        static_cast<float*>(dqkv), static_cast<evr::bf16*>(dqkv_r), B, T, W, H,
                                        causal, scale, s);
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def build_trees(trees: list[pathlib.Path], out: pathlib.Path, parts: set[str]) -> list[dict]:
    """Compile each tree's core shim and flash_attn.cu (part ``fwd``),
    backward shim (``bwd``), block_quant.cu (``int8``) and block_attn.cu,
    block_mlp.cu, block_merged.cu, block_attn_bwd.cu and block_mlp_bwd.cu
    (``blocks``); all nvcc processes run together. Returns per tree {key:
    library path} for the parts asked for."""
    from evr_tpu_torch.ops import build

    nvcc = build.nvcc_path()
    procs, libs = [], []
    for n, csrc in enumerate(trees):
        shim, bwd_shim = out / f"core_shim{n}.cu", out / f"bwd_shim{n}.cu"
        shim.write_text(SHIM)
        bwd_shim.write_text(BWD_SHIM)
        srcs = {"core": shim, "k6": csrc / "flash_attn.cu", "bwd": bwd_shim, "int8": csrc / "block_quant.cu",
                "block_attn": csrc / "block_attn.cu", "block_mlp": csrc / "block_mlp.cu",
                "block_merged": csrc / "block_merged.cu", "block_attn_bwd": csrc / "block_attn_bwd.cu",
                "block_mlp_bwd": csrc / "block_mlp_bwd.cu"}
        keys = ((("core", "k6") if "fwd" in parts else ()) + (("bwd",) if "bwd" in parts else ())
                + (("int8",) if "int8" in parts else ())
                + (BLOCK_LIBS if "blocks" in parts else ()))
        lib = {key: out / f"lib{key}{n}.so" for key in keys}
        for key in keys:
            src = srcs[key]
            cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib[key]), str(src)]
            procs.append((f"{csrc} {key}", lib[key], subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs.append(lib)
    failed = []
    for what, path, proc in procs:
        text, _ = proc.communicate()
        path.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{what}: nvcc exit {proc.returncode}\n{text[-3000:]}")
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return libs


def attention_functions(lib: pathlib.Path) -> dict[str, dict]:
    """{mangled name: {"hgmma": n, "depbar": n, "ptxas": [lines]}} for each
    attention or int8 GEMM kernel function of a library (its name holds
    ``attn``, ``flash_fwd``, ``flash_bwd``, ``gemm_s8`` or ``igemm``): its
    HGMMA (or int8 IGMMA) instructions, its
    ``WARPGROUP.DEPBAR`` waits (one after every HGMMA where ptxas serialised
    the products, its note C7514) and ptxas's register, spill and C75xx
    lines for it."""
    from evr_tpu_torch.ops import build

    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"hgmma": 0, "depbar": 0, "ptxas": []}
        elif name is not None and ("HGMMA" in line or "IGMMA" in line):
            funcs[name]["hgmma"] += 1
        elif name is not None and "WARPGROUP.DEPBAR" in line:
            funcs[name]["depbar"] += 1
    funcs = {k: v for k, v in funcs.items()
             if "attn" in k or "flash_fwd" in k or "flash_bwd" in k or "gemm_s8" in k or "igemm" in k}
    current = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
        elif current in funcs and ("registers" in line or "spill" in line or "C751" in line):
            funcs[current]["ptxas"].append(line.strip())
        for name in funcs:  # notes that name their function
            if "C751" in line and f"'{name}'" in line and line.strip() not in funcs[name]["ptxas"]:
                funcs[name]["ptxas"].append(line.strip())
    return funcs


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def compare(torch, got, ref) -> tuple[float, float, bool]:
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    cos = torch.nn.functional.cosine_similarity(g, r, dim=-1).min().item()
    return (g - r).abs().max().item(), cos, bool(torch.isfinite(g).all().item())


def cosine64(got, ref) -> float:
    """The cosine of two tensors taken whole, in float64: near 1 an fp32
    cosine scatters by about 1e-7 on its own."""
    g, r = got.double().reshape(-1), ref.double().reshape(-1)
    return (g @ r / (g.norm() * r.norm())).item()


def within(dt_name: str, err: float, cos: float, finite: bool) -> bool:
    if dt_name == "float32":
        return finite and err <= FP32_TOL
    return finite and err <= BF16_TOL and cos >= BF16_MIN_COS


def block_params(torch, W: int, gen, device):
    """One residual block's fp32 parameters at CLIP's init scales (as
    ``chip_smoke.py``'s)."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    proj_std = W ** -0.5 * (2 * 12) ** -0.5
    return {
        "ln_1": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "attn": {"qkv": {"kernel": normal((W, 3 * W), W ** -0.5), "bias": normal((3 * W,), 0.02)},
                 "out": {"kernel": normal((W, W), proj_std), "bias": normal((W,), 0.02)}},
        "ln_2": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "mlp": {"fc": {"kernel": normal((W, 4 * W), (2 * W) ** -0.5), "bias": normal((4 * W,), 0.02)},
                "proj": {"kernel": normal((4 * W, W), proj_std), "bias": normal((W,), 0.02)}},
    }


def k3_shim(path: pathlib.Path):
    """A tree's K3 entry points as one call each, whatever the tree's
    arguments: (attn(x, params, H, causal) -> out or None, mlp(x, params, act)
    -> out or None), None where the tree refuses the shape (-1). A tree whose
    library exports ``evr_gemm_s8`` (the wgmma int8 GEMM) takes each int8
    kernel as its K-major copy, made here once per kernel with the tree's
    ``evr_transpose_s8`` as ``ops.block_fused.k_major`` makes it; an older
    tree takes the kernels as the params hold them."""
    import torch

    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    try:
        lib.evr_gemm_s8
        k_major = True
    except AttributeError:
        k_major = False
    lib.evr_fused_attn_block_q.argtypes = [i] + [p] * 14 + [i] * 5 + [f, p]
    lib.evr_fused_mlp_block_q.argtypes = [i] + [p] * 15 + [i] * 4 + [p]
    lib.evr_fused_attn_block_q.restype = lib.evr_fused_mlp_block_q.restype = i
    if k_major:
        lib.evr_transpose_s8.argtypes, lib.evr_transpose_s8.restype = [p, p, i, i, p], i
    copies = {}

    def stream(x):
        return torch.cuda.current_stream(x.device).cuda_stream

    def args(prm):
        """the half's eight arguments as the tree reads them"""
        if not k_major:
            return prm
        out = list(prm)
        for at in (2, 5):
            w = prm[at]
            if w.data_ptr() not in copies:
                K, N = w.shape
                w_t = torch.empty((N, K), dtype=torch.int8, device=w.device)
                rc = lib.evr_transpose_s8(w.data_ptr(), w_t.data_ptr(), K, N, stream(w))
                if rc != 0:
                    raise RuntimeError(f"evr_transpose_s8 returned {rc}")
                copies[w.data_ptr()] = (w, w_t)
            out[at] = copies[w.data_ptr()][1]
        return out

    def code(x):
        return 1 if x.dtype == torch.bfloat16 else 0

    def attn(x, prm, H, causal):
        B, T, W = x.shape
        rows, dev = B * T, x.device
        a_q = torch.empty((rows, W), dtype=torch.int8, device=dev)
        a_scale = torch.empty(rows, dtype=torch.float32, device=dev)
        qkv = torch.empty((rows, 3 * W), dtype=x.dtype, device=dev)
        o, out = torch.empty_like(x), torch.empty_like(x)
        rc = lib.evr_fused_attn_block_q(code(x), x.data_ptr(), *(t.data_ptr() for t in args(prm)),
                                        a_q.data_ptr(), a_scale.data_ptr(), qkv.data_ptr(), o.data_ptr(),
                                        out.data_ptr(), B, T, W, H, int(causal), 1.0 / math.sqrt(W // H), stream(x))
        if rc not in (0, -1):
            raise RuntimeError(f"K3a: launch returned {rc}")
        return out if rc == 0 else None

    def mlp(x, prm, act):
        W, hid = x.shape[-1], prm[2].shape[1]
        rows, dev = x.numel() // W, x.device
        y_q = torch.empty((rows, W), dtype=torch.int8, device=dev)
        h = torch.empty((rows, hid), dtype=torch.float32, device=dev)
        h_q = torch.empty((rows, hid), dtype=torch.int8, device=dev)
        scales = torch.empty((2, rows), dtype=torch.float32, device=dev)
        out = torch.empty_like(x)
        rc = lib.evr_fused_mlp_block_q(code(x), x.data_ptr(), *(t.data_ptr() for t in args(prm)), y_q.data_ptr(),
                                       scales[0].data_ptr(), h.data_ptr(), h_q.data_ptr(), scales[1].data_ptr(),
                                       out.data_ptr(), rows, W, hid, {"quick_gelu": 0, "gelu": 1}[act], stream(x))
        if rc not in (0, -1):
            raise RuntimeError(f"K3b: launch returned {rc}")
        return out if rc == 0 else None

    return attn, mlp


def bench_int8(torch, libs: list[pathlib.Path], result: dict) -> bool:
    """K3a and K3b of each tree: bit-equal across the trees that take a
    shape and within the K3 bands of the plain versions, then timed in
    turns."""
    from evr_tpu_torch.models.quant import quantize_linear_params
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    shims = [k3_shim(path) for path in libs]
    ok = True

    def args(B, T, W, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = block_params(torch, W, gen, dev)
        q = {**p, "attn": {n: quantize_linear_params(v) for n, v in p["attn"].items()},
             "mlp": {n: quantize_linear_params(v) for n, v in p["mlp"].items()}}
        x32 = (torch.rand((B, T, W), generator=gen, device=dev) * 2 - 1) * math.sqrt(3.0)
        return bf.quant_block_half_params(q), x32

    for tag, (B, T, W, H, causal, act) in INT8_CHECKED.items():
        (qa, qm), x32 = args(B, T, W, 1)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            dt_name = str(dt).split(".")[-1]
            pa, pm = bf.cast_quant_args(dt, qa), bf.cast_quant_args(dt, qm)
            for half, ref in (("attn", bf.fused_attn_block_q_plain(x, *pa, n_heads=H, causal=causal)),
                              ("mlp", bf.fused_mlp_block_q_plain(x, *pm, activation=act))):
                outs = [shim[0](x, pa, H, causal) if half == "attn" else shim[1](x, pm, act) for shim in shims]
                torch.cuda.synchronize()
                taken = [o for o in outs if o is not None]
                same = all(torch.equal(o, taken[0]) for o in taken)
                rec = {"kind": f"K3{'a' if half == 'attn' else 'b'}", "shape": tag, "dtype": dt_name,
                       "taken": [o is not None for o in outs], "same_bits": same}
                good = bool(taken) and same
                for n, o in enumerate(outs):
                    if o is None:
                        continue
                    err, cos, finite = compare(torch, o, ref)
                    tol = INT8_FP32_TOL if dt == torch.float32 else BF16_TOL
                    good &= finite and err <= tol and cos >= INT8_MIN_COS
                    rec[f"tree{n}"] = {"max_abs_err": err, "min_row_cos": cos}
                rec["ok"] = good
                ok &= good
                log(f"check {rec['kind']} {tag} {act} {dt_name}: taken by trees {rec['taken']}, bit-equal across "
                    f"them {same}; " + ", ".join(f"tree {n} max_abs_err={rec[f'tree{n}']['max_abs_err']:.3e} "
                                                 f"min_row_cos={rec[f'tree{n}']['min_row_cos']:.7f}"
                                                 for n, o in enumerate(outs) if o is not None)
                    + f" {'ok' if good else 'FAILED'}")
                result["checks"].append(rec)
                del outs, taken, ref
    for tag, (B, T, W, H, causal, act) in INT8_TIMED.items():
        (qa, qm), x32 = args(B, T, W, 2)
        x = x32.to(torch.bfloat16)
        pa, pm = bf.cast_quant_args(torch.bfloat16, qa), bf.cast_quant_args(torch.bfloat16, qm)
        rows = B * T
        for half in ("attn", "mlp"):
            if half == "attn":
                ops, flops = 2 * rows * W * 4 * W, 4 * B * T * T * W
                nbytes = 4 * rows * W + 4 * W * W + 8 * 4 * W
                kerns = [lambda s=s: s[0](x, pa, H, causal) for s in shims]
            else:
                ops, flops = 2 * 2 * rows * W * 4 * W, 0
                nbytes = 4 * rows * W + 8 * W * W + 10 * 4 * W
                kerns = [lambda s=s: s[1](x, pm, act) for s in shims]
            n = len(kerns)
            runs = [[] for _ in range(n)]
            for idx in list(range(n)) + list(reversed(range(n))):
                runs[idx].append(cuda_ms(torch, kerns[idx]))
            t_ops = (ops / H100_INT8_OPS + flops / H100_BF16_FLOPS) * 1e3
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            rec = {"kind": f"K3{'a' if half == 'attn' else 'b'}", "shape": tag, "ms": [min(r) for r in runs],
                   "runs_ms": runs, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            result["times"].append(rec)
            log(f"time {rec['kind']} {tag} B={B} T={T} W={W} bf16: " + ", ".join(
                f"tree {j} {'/'.join(f'{v:.4f}' for v in runs[j])} ms" for j in range(n))
                + f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: {ops / 1e9:.2f} G int8 operations, "
                f"{flops / 1e9:.2f} GFLOP attention, {nbytes / 1e6:.1f} MB)")
            rec["split_ms"] = kernel_split(torch, kerns[-1])
            log(f"split {rec['kind']} {tag}, tree {n - 1}, device ms a call by kernel: " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in rec["split_ms"].items()))
    return ok


def kernel_split(torch, fn, calls: int = 20) -> dict[str, float]:
    """Device time a call of ``fn`` spends in each CUDA kernel, by
    ``torch.profiler`` over ``calls`` calls after a warm-up: {kernel name
    (shortened to its function): ms}, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us <= 0 or ev.key.startswith("cuda") or "Memcpy" in ev.key or "Memset" in ev.key:
            continue
        name = re.sub(r"^(void )?", "", ev.key).split("(")[0].split("<")[0].split("::")[-1]
        template = re.search(r"<(.*)>", ev.key)
        if template:
            name += "<" + template.group(1)[:40] + ">"
        split[name] = split.get(name, 0.0) + us / 1e3 / calls
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def check_blocks(torch, paths: list[dict], result: dict) -> bool:
    """K1, K2, K9, K5a and K5b of each tree through the package's wrappers
    (each tree's libraries put in ``ops.build``'s place in turn): every
    tree's output (K5: dx and every gradient) equal to the first tree's bit
    for bit at BLOCKS_CHECKED."""
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.ops import build

    dev = torch.device("cuda")
    names = BLOCK_LIBS
    libs = []
    for lib in paths:
        loaded = {}
        for name in names:
            loaded[name] = ctypes.CDLL(str(lib[name]))
            build._declare(name, loaded[name])
        libs.append(loaded)
    saved = {name: build._loaded.get(name) for name in names}
    ok = True
    try:
        for tag, (B, T, W, H, causal, act) in BLOCKS_CHECKED.items():
            gen = torch.Generator(device=dev).manual_seed(3)
            p = block_params(torch, W, gen, dev)
            attn, mlp = bf.block_half_params(p)
            x32 = (torch.rand((B, T, W), generator=gen, device=dev) * 2 - 1) * math.sqrt(3.0)
            g32 = (torch.rand((B, T, W), generator=gen, device=dev) * 2 - 1) * 0.01
            for dt in (torch.bfloat16, torch.float32):
                x, g = x32.to(dt), g32.to(dt)
                calls = (("K1", lambda: [bf.fused_attn_block(x, *attn, n_heads=H, causal=causal)]),
                         ("K2", lambda: [bf.fused_mlp_block(x, *mlp, activation=act)]),
                         ("K9", lambda: [bf.fused_block_merged(x, p, H, act, causal)]),
                         ("K5a", lambda: bf.fused_attn_block_bwd(x, g, *attn, n_heads=H, causal=causal)),
                         ("K5b", lambda: bf.fused_mlp_block_bwd(x, g, *mlp, activation=act)))
                for kind, call in calls:
                    outs = []
                    for loaded in libs:
                        build._loaded.update(loaded)
                        outs.append(call())
                    torch.cuda.synchronize()
                    same = all(torch.equal(u, v) for o in outs for u, v in zip(o, outs[0]))
                    ok &= same
                    dt_name = str(dt).split(".")[-1]
                    log(f"check {kind} {tag} {dt_name}: bit-equal across the trees {same} "
                        f"{'ok' if same else 'FAILED'}")
                    result["checks"].append({"kind": kind, "shape": tag, "dtype": dt_name, "same_bits": same,
                                             "ok": same})
                    del outs
    finally:
        for name, lib in saved.items():
            if lib is None:
                build._loaded.pop(name, None)
            else:
                build._loaded[name] = lib
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=pathlib.Path,
                    help="an ops/csrc directory (repeatable; default this package's)")
    ap.add_argument("--parts", default="fwd,bwd",
                    help="comma-separated: fwd (K6 and K1's core), bwd (K5a's attention backward), "
                         "int8 (K3a and K3b), blocks (K1, K2, K9, K5a and K5b)")
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON result here")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts or parts - {"fwd", "bwd", "int8", "blocks"}:
        ap.error(f"--parts {args.parts!r}: any of fwd, bwd, int8, blocks")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attn_bench: no CUDA device", file=sys.stderr)
        return 2
    from evr_tpu_torch.ops import build
    from evr_tpu_torch.ops.attention import flash_attention_plain
    from evr_tpu_torch.ops.block_fused import attn_backward_plain, attn_forward_plain

    trees = [p.resolve() for p in (args.csrc or [build.CSRC])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card, "trees": [str(t) for t in trees], "functions": [], "checks": [], "times": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = build_trees(trees, pathlib.Path(tmp), parts)
        log(f"build: {time.perf_counter() - t0:.1f} s")
        funcs = []
        for tree, lib in zip(trees, paths):
            for key, path in lib.items():
                for name, f in attention_functions(path).items():
                    log(f"sass {tree} {key} {name}: HGMMA/IGMMA {f['hgmma']}, DEPBAR {f['depbar']}; "
                        + "; ".join(f["ptxas"]))
                    funcs.append({"tree": str(tree), "lib": key, "function": name, **f})
        result["functions"] = funcs
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        cores, k6s, bwds = [], [], []
        for lib in paths:
            if "fwd" in parts:
                core = ctypes.CDLL(str(lib["core"])).shim_flash_forward
                core.argtypes, core.restype = [i, p, p] + [i] * 5 + [f, p], i
                k6 = ctypes.CDLL(str(lib["k6"])).evr_flash_attention
                k6.argtypes, k6.restype = [i, p, p, p, p, i, i, i, i, f, p], i
                cores.append(core)
                k6s.append(k6)
            if "bwd" in parts:
                bwd = ctypes.CDLL(str(lib["bwd"])).shim_flash_backward
                bwd.argtypes, bwd.restype = [i] + [p] * 6 + [i] * 5 + [f, p], i
                bwds.append(bwd)
        dev = torch.device("cuda")
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run_core(fn, qkv, o, B, T, W, H, causal):
            code = 1 if qkv.dtype == torch.bfloat16 else 0
            rc = fn(code, qkv.data_ptr(), o.data_ptr(), B, T, W, H, int(causal), 1.0 / math.sqrt(W // H), stream)
            if rc != 0:
                raise RuntimeError(f"core: launch returned {rc}")

        def run_k6(fn, q, k, v, o, causal):
            B, H, T, d = q.shape
            code = 1 if q.dtype == torch.bfloat16 else 0
            scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype).item()
            rc = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B * H, T, d, int(causal),
                    scale, stream)
            if rc != 0:
                raise RuntimeError(f"K6: launch returned {rc}")

        def record(kind, tag, tree, dt_name, got, ref):
            nonlocal ok
            err, cos, finite = compare(torch, got, ref)
            good = within(dt_name, err, cos, finite)
            ok &= good
            log(f"check {kind} {tag} {dt_name} tree {tree}: max_abs_err={err:.3e} min_row_cos={cos:.7f} "
                f"{'ok' if good else 'FAILED'}")
            result["checks"].append({"kind": kind, "shape": tag, "dtype": dt_name, "tree": tree,
                                     "max_abs_err": err, "min_row_cos": cos, "ok": good})

        def timed(kind, tag, kerns, lib, flops, nbytes):
            n = len(kerns)
            order = list(range(n)) + list(reversed(range(n)))
            runs = [[] for _ in range(n)]
            for idx in order:
                runs[idx].append(cuda_ms(torch, kerns[idx]))
            lib_ms = cuda_ms(torch, lib)
            t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            rec = {"kind": kind, "shape": tag, "ms": [min(r) for r in runs], "runs_ms": runs,
                   "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            result["times"].append(rec)
            log(f"time {kind} {tag} bf16: " + ", ".join(
                f"tree {j} {'/'.join(f'{x:.4f}' for x in runs[j])} ms" for j in range(n))
                + f"; SDPA {lib_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")

        gen = torch.Generator(device=dev).manual_seed(9)

        def unit(shape):
            return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * math.sqrt(3.0)

        for tag, (B, T, W, H, causal) in ({**CORE_TIMED, **CORE_CHECKED} if "fwd" in parts else {}).items():
            qkv32 = unit((B, T, 3 * W))
            for dt in (torch.bfloat16, torch.float32):
                qkv = qkv32.to(dt)
                ref = attn_forward_plain(qkv, H, causal)
                outs = [torch.empty((B, T, W), dtype=dt, device=dev) for _ in trees]
                for n, (core, o) in enumerate(zip(cores, outs)):
                    run_core(core, qkv, o, B, T, W, H, causal)
                    torch.cuda.synchronize()
                    record("core", tag, n, str(dt).split(".")[-1], o, ref)
                del ref
                if dt == torch.bfloat16 and tag in CORE_TIMED:
                    d = W // H
                    q, k, v = qkv.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
                    pairs = T * (T + 1) // 2 if causal else T * T
                    timed("core", f"{tag} B={B} T={T} W={W} H={H}", [
                        (lambda c=c, o=o: run_core(c, qkv, o, B, T, W, H, causal))
                        for c, o in zip(cores, outs)],
                        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                        4 * B * H * pairs * d, (3 * W + W) * B * T * 2)
                del outs
        for tag, (B, H, T, d, causal) in ({**K6_TIMED, **K6_CHECKED} if "fwd" in parts else {}).items():
            q32, k32, v32 = (unit((B, H, T, d)) for _ in range(3))
            for dt in (torch.bfloat16, torch.float32):
                q, k, v = (x.to(dt) for x in (q32, k32, v32))
                ref = flash_attention_plain(q, k, v, causal)
                outs = [torch.empty_like(q) for _ in trees]
                for n, (k6, o) in enumerate(zip(k6s, outs)):
                    run_k6(k6, q, k, v, o, causal)
                    torch.cuda.synchronize()
                    record("K6", tag, n, str(dt).split(".")[-1], o, ref)
                del ref
                if dt == torch.bfloat16 and tag in K6_TIMED:
                    pairs = T * (T + 1) // 2 if causal else T * T
                    timed("K6", f"{tag} B={B} H={H} T={T} d={d}", [
                        (lambda f=k6, o=o: run_k6(f, q, k, v, o, causal)) for k6, o in zip(k6s, outs)],
                        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                        4 * B * H * pairs * d, 4 * B * H * T * d * 2)
                del outs

        def run_bwd(fn, qkv, dout, outs, H, causal):
            B, T, W3 = qkv.shape
            W = W3 // 3
            code = 1 if qkv.dtype == torch.bfloat16 else 0
            o, st, dqkv, dqkv_r = outs
            rc = fn(code, qkv.data_ptr(), dout.data_ptr(), o.data_ptr(), st.data_ptr(), dqkv.data_ptr(),
                    0 if dqkv_r is None else dqkv_r.data_ptr(), B, T, W, H, int(causal),
                    1.0 / math.sqrt(W // H), stream)
            if rc != 0:
                raise RuntimeError(f"backward: launch returned {rc}")

        def bwd_outs(qkv, H):
            B, T, W3 = qkv.shape
            bf = qkv.dtype == torch.bfloat16
            return (torch.empty((B * T, W3 // 3), dtype=qkv.dtype, device=dev),
                    torch.empty((3, B, H, T), dtype=torch.float32, device=dev),
                    torch.empty((B * T, W3), dtype=torch.float32, device=dev),
                    torch.empty((B * T, W3), dtype=qkv.dtype, device=dev) if bf else None)

        def bwd_record(tag, tree, dt_name, outs, ref, same):
            nonlocal ok
            (o, _, dqkv, dqkv_r), (o_p, dqkv_p) = outs, ref
            W = o.shape[1]
            rec = {"kind": "bwd", "shape": tag, "dtype": dt_name, "tree": tree,
                   "o_max_abs_err": (o.float() - o_p.float()).abs().max().item(),
                   "finite": bool(torch.isfinite(dqkv).all().item() and torch.isfinite(o.float()).all().item())}
            for n, part in enumerate("qkv"):
                g, r = dqkv[:, n * W:(n + 1) * W], dqkv_p[:, n * W:(n + 1) * W]
                rec[f"d{part}_rel"] = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
                rec[f"d{part}_cos"] = cosine64(g, r)
            rels = [rec[f"d{x}_rel"] for x in "qkv"]
            coss = [rec[f"d{x}_cos"] for x in "qkv"]
            if dt_name == "float32":
                good = rec["finite"] and max(rels) <= BWD_FP32_REL
            else:
                rec["rounded"] = bool(torch.equal(dqkv_r, dqkv.to(torch.bfloat16)))
                good = (rec["finite"] and rec["rounded"] and rec["o_max_abs_err"] <= BWD_BF16_O_TOL
                        and max(rels) <= BWD_BF16_REL and min(coss) >= BWD_BF16_MIN_COS)
            rec["same_bits"] = same
            good &= same
            rec["ok"] = good
            ok &= good
            log(f"check bwd {tag} {dt_name} tree {tree}: o max_abs_err={rec['o_max_abs_err']:.3e} "
                + " ".join(f"d{x} rel={rec[f'd{x}_rel']:.3e} cos={rec[f'd{x}_cos']:.10f}" for x in "qkv")
                + f" same_bits={same} {'ok' if good else 'FAILED'}")
            result["checks"].append(rec)

        for tag, (B, T, W, H, causal) in ({**BWD_TIMED, **BWD_CHECKED} if "bwd" in parts else {}).items():
            d = W // H
            # the inputs of chip_smoke.py's phase_parity_attn_bwd
            gen_b = torch.Generator(device=dev).manual_seed(12)
            qkv32 = (torch.rand((B, T, 3 * W), generator=gen_b, device=dev) * 2 - 1) * math.sqrt(3.0)
            do32 = (torch.rand((B, T, W), generator=gen_b, device=dev) * 2 - 1) * math.sqrt(3.0) * 0.01
            first_fp32 = None
            for dt in (torch.bfloat16, torch.float32):
                qkv, dout = qkv32.to(dt), do32.to(dt)
                dt_name = str(dt).split(".")[-1]
                ref = attn_backward_plain(qkv, dout, H, causal)
                outs = [bwd_outs(qkv, H) for _ in trees]
                for n, (fn, out) in enumerate(zip(bwds, outs)):
                    run_bwd(fn, qkv, dout, out, H, causal)
                    torch.cuda.synchronize()
                    if dt == torch.bfloat16:  # the same bits from a second call
                        again = bwd_outs(qkv, H)
                        run_bwd(fn, qkv, dout, again, H, causal)
                        torch.cuda.synchronize()
                        same = all(torch.equal(x, y) for x, y in zip(out, again) if x is not None)
                        del again
                    else:  # the same bits as the first tree's fp32 kernels
                        first_fp32 = first_fp32 or out
                        same = all(torch.equal(x, y) for x, y in zip(out, first_fp32) if x is not None)
                    bwd_record(tag, n, dt_name, out, ref, same)
                del ref
                if dt == torch.bfloat16 and tag in BWD_TIMED:
                    leaf = qkv.detach().requires_grad_()
                    q, k, v = leaf.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)
                    lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                    g_out = dout.view(B, T, H, d).transpose(1, 2)
                    pairs = T * (T + 1) // 2 if causal else T * T
                    timed("bwd", f"{tag} B={B} T={T} W={W} H={H}", [
                        (lambda fn=fn, out=out: run_bwd(fn, qkv, dout, out, H, causal))
                        for fn, out in zip(bwds, outs)],
                        lambda: torch.autograd.grad(lib_out, leaf, g_out, retain_graph=True),
                        12 * B * H * pairs * d, B * T * W * (6 + 2 + 2 + 12 + 6) + 3 * B * H * T * 4)
                    del leaf, q, k, v, lib_out
                del outs
            del first_fp32
        if "int8" in parts:
            ok &= bench_int8(torch, [lib["int8"] for lib in paths], result)
        if "blocks" in parts:
            ok &= check_blocks(torch, paths, result)
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
