"""Hold the attention forward to its plain version and time it, for one or
more source trees of the kernels, on one NVIDIA GPU.

    python -m evr_tpu_torch.tools.attn_bench [--csrc DIR ...] [--out FILE]

Each ``--csrc`` is an ``ops/csrc`` directory (default: this package's); give
an older tree's too to compare the two on one card in one process. For each
tree two libraries are compiled with ``ops.build``'s nvcc flags, all nvcc
processes started together: the tree's ``flash_attn.cu`` (K6, entry
``evr_flash_attention``) and a shim over its ``flash.cuh`` exporting
``launch_flash_fwd``, the attention core of K1, K3a and K9 (the function of
``ops.block_fused.attn_forward``), so that a tree from before that entry
existed runs through the same device code as the block halves.

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
K6_CHECKED = {
    "vitb-vision": (256, 12, 50, 64, False),
    "long-d80-causal": (2, 4, 1000, 80, True),
    "t129-d64": (3, 5, 129, 64, False),
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


def log(msg: str) -> None:
    print(msg, flush=True)


def build_trees(trees: list[pathlib.Path], out: pathlib.Path) -> list[dict]:
    """Compile each tree's core shim and flash_attn.cu; all nvcc processes
    run together. Returns per tree {"core", "k6"}: library paths."""
    from evr_tpu_torch.ops import build

    nvcc = build.nvcc_path()
    procs, libs = [], []
    for n, csrc in enumerate(trees):
        shim = out / f"core_shim{n}.cu"
        shim.write_text(SHIM)
        lib = {"core": out / f"libcore{n}.so", "k6": out / f"libk6{n}.so"}
        for key, src in (("core", shim), ("k6", csrc / "flash_attn.cu")):
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
    """{mangled name: {"hgmma": n, "ptxas": [lines]}} for each attention
    kernel function of a library (its name holds ``attn`` or ``flash_fwd``)."""
    from evr_tpu_torch.ops import build

    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"hgmma": 0, "ptxas": []}
        elif name is not None and "HGMMA" in line:
            funcs[name]["hgmma"] += 1
    funcs = {k: v for k, v in funcs.items() if "attn" in k or "flash_fwd" in k}
    current = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            current = m.group(1)
        elif current in funcs and ("registers" in line or "spill" in line or "C7515" in line):
            funcs[current]["ptxas"].append(line.strip())
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


def within(dt_name: str, err: float, cos: float, finite: bool) -> bool:
    if dt_name == "float32":
        return finite and err <= FP32_TOL
    return finite and err <= BF16_TOL and cos >= BF16_MIN_COS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=pathlib.Path,
                    help="an ops/csrc directory (repeatable; default this package's)")
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attn_bench: no CUDA device", file=sys.stderr)
        return 2
    from evr_tpu_torch.ops import build
    from evr_tpu_torch.ops.attention import flash_attention_plain
    from evr_tpu_torch.ops.block_fused import attn_forward_plain

    trees = [p.resolve() for p in (args.csrc or [build.CSRC])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card, "trees": [str(t) for t in trees], "functions": [], "checks": [], "times": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = build_trees(trees, pathlib.Path(tmp))
        log(f"build: {time.perf_counter() - t0:.1f} s")
        funcs = []
        for tree, lib in zip(trees, paths):
            for key, path in lib.items():
                for name, f in attention_functions(path).items():
                    log(f"sass {tree} {key} {name}: HGMMA {f['hgmma']}; " + "; ".join(f["ptxas"]))
                    funcs.append({"tree": str(tree), "lib": key, "function": name, **f})
        result["functions"] = funcs
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        cores, k6s = [], []
        for lib in paths:
            core = ctypes.CDLL(str(lib["core"])).shim_flash_forward
            core.argtypes, core.restype = [i, p, p] + [i] * 5 + [f, p], i
            k6 = ctypes.CDLL(str(lib["k6"])).evr_flash_attention
            k6.argtypes, k6.restype = [i, p, p, p, p, i, i, i, i, f, p], i
            cores.append(core)
            k6s.append(k6)
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

        for tag, (B, T, W, H, causal) in {**CORE_TIMED, **CORE_CHECKED}.items():
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
        for tag, (B, H, T, d, causal) in {**K6_TIMED, **K6_CHECKED}.items():
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
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
