"""Hold K4 (the fused index scan + top-k) to its plain version and time it,
for one or more source trees of the kernel, on one NVIDIA GPU.

    python -m evr_tpu_torch.tools.topk_bench [--csrc DIR ...] [--rows N] [--out FILE]

Each ``--csrc`` is an ``ops/csrc`` directory (default: this package's); give
an older tree's too to compare the two on one card in one process. Each
tree's ``topk_fused.cu`` is compiled with ``ops.build``'s nvcc flags, all
nvcc processes started together. A tree whose kernel sorts each 1,024-row
tile with a bitonic sort (the per-tile design) is compiled a second time
with that sort cut out (``<tree> sortless``, wrong answers, timed only), so
that its scan can be timed alone. A tree that exports ``evr_topk_plan``
takes k and writes [Q, n_blocks, kc] candidates (the plan read from the
library), and times its scan alone through ``evr_fused_topk_scan``; an
older one takes kc and writes [Q, n_tiles, kc].

The index is ``--rows`` seeded unit rows of 512 (1,048,576 by default, as
``chip_smoke.py``'s ``topk_index``: a block of 64 tied rows at 5,000), in
int8 with row scales, bf16 and fp32. At CHECKED's cases every tree's rows
must equal ``fused_topk_plain``'s and its scores match them bit for bit.
At TIMED's cases each tree is timed by CUDA events, the trees in turns
(first, ..., last, last, ..., first), the better of each tree's two runs
kept: the whole call as ``fused_topk`` makes it (``prepared_queries``, the
launch, ``_merge``), the launch alone, the scan alone and ``_merge`` alone;
beside ``prepared_queries`` alone, ``torch.matmul`` + ``torch.topk`` on the
same rows (int8 dequantised to bf16) and the bound: the rows (and scales)
read once at 3.35 TB/s against one product and one sum per element and
query at the fp32 peak (67 TFLOP/s, H100 SXM data sheet). The last line of
the output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys
import tempfile

from ..ops import build

DIM, K = 512, 30
SORT_LOOP = "for (int k = 2; k <= kTopkTile; k <<= 1)"
# (dtype, Q, k, start, end) with end None for all rows, or k above the range
CHECKED = [
    ("int8", 1, 30, 0, None), ("int8", 5, 300, 17, -4099), ("int8", 32, 1, 17, -4099),
    ("bfloat16", 1, 30, 0, None), ("float32", 5, 30, 17, -4099), ("int8", 5, 30, 600000, 600010),
]
TIMED = [("int8", 1), ("bfloat16", 1), ("float32", 1), ("int8", 5), ("int8", 32)]
H100_BYTES_PER_S, H100_FP32_FLOPS = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def build_trees(trees: list[pathlib.Path], out: pathlib.Path) -> list[dict]:
    """One library a tree (and a sortless one for a per-tile tree), all
    compiled in parallel."""
    nvcc = build.nvcc_path()
    jobs = []
    for n, csrc in enumerate(trees):
        src = csrc / "topk_fused.cu"
        jobs.append({"tree": str(csrc), "name": f"tree {n}", "src": src, "csrc": csrc})
        text = src.read_text()
        if SORT_LOOP in text:
            cut = out / f"tree{n}_sortless.cu"
            cut.write_text(text.replace(SORT_LOOP, "for (int k = 2; k <= 0; k <<= 1)"))
            jobs.append({"tree": str(csrc), "name": f"tree {n} sortless", "src": cut, "csrc": csrc})
    procs = []
    for j, job in enumerate(jobs):
        job["lib"] = out / f"libtopk{j}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(job["csrc"]), "-o", str(job["lib"]), str(job["src"])]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for job, proc in zip(jobs, procs):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{job['src']}: nvcc exit {proc.returncode}\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {job['name']}: {line.strip()}")
        lib = ctypes.CDLL(str(job["lib"]))
        p, i = ctypes.c_void_p, ctypes.c_int
        entries = [lib.evr_fused_topk]
        job["new"] = hasattr(lib, "evr_topk_plan")
        if job["new"]:
            entries.append(lib.evr_fused_topk_scan)
            lib.evr_topk_plan.argtypes = [i, i, i, i, p]
            lib.evr_topk_plan.restype = i
        for fn in entries:
            fn.argtypes = [i, p, p, p, i, i, i, i, i, i, p, p, p]
            fn.restype = i
        job["cdll"] = lib
    return jobs


def index_of(torch, dtype: str, rows: int):
    """``chip_smoke.py``'s topk_index: seeded unit rows, 64 tied at 5,000."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    emb = torch.randn((rows, DIM), generator=gen, device="cuda")
    emb[5000:5064] = emb[5000]
    emb = emb / emb.norm(dim=1, keepdim=True)
    if dtype == "int8":
        scales = (emb.abs().amax(1) / 127.0).clamp_min(1e-12)
        return torch.clamp(torch.round(emb / scales[:, None]), -127, 127).to(torch.int8), scales
    return emb.to(getattr(torch, dtype)), None


def launcher(torch, job, index, nq, start, end, k, scales, scan=False):
    """A function launching the tree's kernel on prepared queries, returning
    its candidates (allocated per call, as the wrapper does)."""
    n, d = index.shape
    if job["new"]:
        plan = (ctypes.c_int * 7)()
        if job["cdll"].evr_topk_plan(n, d, nq, k, plan) != 0:
            raise RuntimeError(f"{job['name']}: no plan for {n} x {d}, Q {nq}, k {k}")
        shape, k_arg = (nq, plan[0], plan[3]), k
    else:
        shape, k_arg = (nq, -(-n // 1024), min(k, 1024)), min(k, 1024)
    entry = job["cdll"].evr_fused_topk_scan if scan else job["cdll"].evr_fused_topk
    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[index.dtype]
    sp = None if scales is None else scales.data_ptr()

    def run(qp):
        cs = torch.empty(shape, dtype=torch.float32, device="cuda")
        cr = torch.empty(shape, dtype=torch.int32, device="cuda")
        rc = entry(code, index.data_ptr(), qp.data_ptr(), sp, n, d, nq, start, end, k_arg, cs.data_ptr(),
                   cr.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{job['name']}: launch failed with {rc}")
        return cs, cr
    return run


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", type=pathlib.Path,
                    help="an ops/csrc directory (repeatable; default this package's)")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON result here")
    args = ap.parse_args(argv)
    import torch

    from ..ops.retrieval import _merge, fused_topk_plain, prepared_queries

    if not torch.cuda.is_available():
        print("topk_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = [p.resolve() for p in (args.csrc or [build.CSRC])]
    result = {"card": card, "rows": args.rows, "checks": [], "times": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = build_trees(trees, pathlib.Path(tmp))
        answering = [j for j in jobs if "sortless" not in j["name"]]
        n = args.rows
        gen = torch.Generator(device="cuda").manual_seed(4)
        for dtype in ("int8", "bfloat16", "float32"):
            index, scales = index_of(torch, dtype, n)
            for cdt, nq, k, start, end in CHECKED:
                if cdt != dtype:
                    continue
                end = n if end is None else (end if end > 0 else n + end)
                q = torch.randn((nq, DIM), generator=gen, device="cuda")
                q[0] = index[5000].float()
                ref_s, ref_r = fused_topk_plain(index, q, start, end, k, scales)
                qp = prepared_queries(q, index.dtype)
                for job in answering:
                    got_s, got_r = _merge(*launcher(torch, job, index, nq, start, end, k, scales)(qp), k)
                    torch.cuda.synchronize()
                    rows_eq, bits = bool(torch.equal(got_r, ref_r)), bool(torch.equal(got_s, ref_s))
                    ok &= rows_eq and bits
                    rec = {"tree": job["name"], "dtype": dtype, "Q": nq, "k": k, "start": start, "end": end,
                           "rows_equal": rows_eq, "scores_bit_equal": bits}
                    result["checks"].append(rec)
                    log(f"check {json.dumps(rec)}")
            for tdt, nq in TIMED:
                if tdt != dtype:
                    continue
                q = torch.randn((nq, DIM), generator=gen, device="cuda")
                qp = prepared_queries(q, index.dtype)
                qn = (q / q.norm(dim=1, keepdim=True))
                rows = (index.float() * scales[:, None]).to(torch.bfloat16) if dtype == "int8" else index
                qn = qn.to(rows.dtype)
                per = {}
                for job in jobs:
                    run = launcher(torch, job, index, nq, 0, n, K, scales)
                    cands = run(qp)
                    fns = {"call": lambda run=run: _merge(*run(prepared_queries(q, index.dtype)), K),
                           "kernel": lambda run=run: run(qp), "merge": lambda c=cands: _merge(*c, K)}
                    if job["new"]:
                        scan = launcher(torch, job, index, nq, 0, n, K, scales, scan=True)
                        fns["scan"] = lambda scan=scan: scan(qp)
                    per[job["name"]] = fns
                order = [j["name"] for j in jobs]
                runs = {name: {} for name in order}
                for name in order + order[::-1]:
                    for part, fn in per[name].items():
                        ms = cuda_ms(torch, fn)
                        runs[name][part] = min(ms, runs[name].get(part, math.inf))
                prep = cuda_ms(torch, lambda: prepared_queries(q, index.dtype))
                lib = cuda_ms(torch, lambda: torch.topk(qn @ rows.T, K))
                elt = index.element_size()
                nbytes = n * DIM * elt + (4 * n if scales is not None else 0) + 4 * DIM * nq + nq * K * 12
                t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, 2 * n * DIM * nq / H100_FP32_FLOPS * 1e3
                rec = {"dtype": dtype, "Q": nq, "k": K, "prepared_queries_ms": prep, "library_ms": lib,
                       "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "trees": runs}
                result["times"].append(rec)
                log(f"time {json.dumps(rec)}")
                del rows
            del index, scales
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
