"""Hold K7 (the PQ table-lookup scorer) to its plain version and time it, for
one or more source trees of the kernel, on one NVIDIA GPU.

    python -m evr_tpu_torch.tools.adc_bench [--csrc DIR ...] [--cases TAG,...] [--out FILE] [--sass-dir DIR]

Each ``--csrc`` is an ``ops/csrc`` directory (default: this package's); give
an older tree's too to compare the two on one card in one process. Each
tree's ``adc_list.cu`` is compiled with ``ops.build``'s nvcc flags, all nvcc
processes started together, and its SASS counts of TMA instructions
(``UTMALDG``, ``UBLKCP``) and generic loads are printed. A tree that exports
``evr_adc_probe_scores`` reads the probed lists where they lie (int64 list
ids, the tables code-major; its plan is checked against
``ops.adc.adc_plan``); an older one exports ``evr_adc_list_scores`` and takes
gathered [P, C, S] blocks.

The index is ``codes_lists`` [2,048 lists, 3,072 rows, 64] of seeded random
codes (``chip_smoke.py``'s large IVF-PQ tier's geometry), the tables seeded
normals at 1/sqrt(S). At CASES every tree's scores must equal the plain
version's (``adc_probe_scores_plain``) bit for bit. At the TIMED cases each
tree is timed by CUDA events over 30 back-to-back calls (which the host's
launch work can bound) and, for the launches alone, by the kernel's device
time in a ``torch.profiler`` trace, the trees in turns (first, ..., last,
last, ..., first), the better of each tree's two runs kept: for a lists-in-place
tree the call as ``adc_probe_scores`` makes it (the code-major table copy
and the launch), the launch alone, and the
parent's form (the gathered copy, then the launch on it); for an older tree
the gathered copy plus its launch, and its launch alone. Beside them: the
gathered copy alone, the port's ``adc_gather_sum`` (the "xla" path, the
copy included) and a library expression on the gathered blocks (each
block's table expanded over C, ``gather``, ``sum``), none where its int64
indices would pass LIBRARY_MAX_BYTES; and the bound: the distinct probed
lists' codes, the tables and the scores moved once at 3.35 TB/s against one
fp32 add a term at 67 TFLOP/s (H100 SXM data sheet). The last line of the
output is one JSON object.
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

N_LISTS, ROWS, SUB, CENTROIDS = 2048, 3072, 64, 256
# (tag, L, C, S, K, B, n, ids): ids "distinct" (each query n distinct random
# lists), "repeat" (repeated and unordered), "all" (every list for each
# query), "one" (one list for every probe: its codes stay in L2, so the
# kernel's walk is timed without the stream from device memory)
CASES = [
    ("P256", N_LISTS, ROWS, SUB, CENTROIDS, 8, 32, "distinct"),
    ("P256-one-list", N_LISTS, ROWS, SUB, CENTROIDS, 8, 32, "one"),
    ("B1", N_LISTS, ROWS, SUB, CENTROIDS, 1, 32, "distinct"),
    ("full", N_LISTS, ROWS, SUB, CENTROIDS, 8, N_LISTS, "all"),
    ("ragged", 9, 517, 20, 100, 2, 3, "repeat"),
    ("repeat", 40, 1000, 64, 256, 3, 8, "repeat"),
    ("S32", 64, 777, 32, 256, 4, 16, "distinct"),
    ("S96", 64, 500, 96, 64, 2, 8, "repeat"),
    ("S128", 64, 3072, 128, 256, 2, 8, "distinct"),
    ("S16", 64, 300, 16, 256, 2, 8, "distinct"),
    ("unaligned", 40, 1000, 64, 256, 3, 8, "distinct"),
]
TIMED = ("P256", "P256-one-list", "B1", "full", "ragged")
LIBRARY_MAX_BYTES = 8 << 30  # the library expression's int64 gather indices, at most
H100_BYTES_PER_S, H100_FP32_FLOPS = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def sass_counts(lib: pathlib.Path, keep: pathlib.Path | None = None) -> dict[str, dict[str, int]]:
    """Per kernel function of the library: TMA tensor loads (UTMALDG), bulk
    copies (UBLKCP), shared loads (LDS) and generic loads (LD.E); the SASS
    is written to ``keep`` if given."""
    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    if keep is not None:
        keep.parent.mkdir(parents=True, exist_ok=True)
        keep.write_text(sass)
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = {"UTMALDG": 0, "UBLKCP": 0, "LDS": 0, "LD.E": 0}
        elif name is not None:
            for m in out[name]:
                if f" {m}" in line:
                    out[name][m] += 1
    return out


def build_trees(trees: list[pathlib.Path], out: pathlib.Path, sass_dir: pathlib.Path | None) -> list[dict]:
    nvcc = build.nvcc_path()
    jobs, procs = [], []
    for n, csrc in enumerate(trees):
        job = {"name": f"tree {n}", "tree": str(csrc), "lib": out / f"libadc{n}.so"}
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(job["lib"]), str(csrc / "adc_list.cu")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        jobs.append(job)
    p, i = ctypes.c_void_p, ctypes.c_int
    for n, (job, proc) in enumerate(zip(jobs, procs)):
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{job['tree']}/adc_list.cu: nvcc exit {proc.returncode}\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {job['name']}: {line.strip()}")
        job["sass"] = sass_counts(job["lib"], sass_dir / f"adc{n}.sass" if sass_dir else None)
        log(f"sass {job['name']}: {json.dumps(job['sass'])}")
        lib = ctypes.CDLL(str(job["lib"]))
        job["new"] = hasattr(lib, "evr_adc_probe_scores")
        if job["new"]:
            lib.evr_adc_probe_scores.argtypes = [p, i, i, i, p, i, i, p, i, p, p]
            lib.evr_adc_probe_scores.restype = i
            lib.evr_adc_plan.argtypes = [i] * 6 + [p]
            lib.evr_adc_plan.restype = i
        else:
            lib.evr_adc_list_scores.argtypes = [p, p, i, i, i, i, i, p, p]
            lib.evr_adc_list_scores.restype = i
        job["cdll"] = lib
    return jobs


def case_inputs(torch, case, codes_cache: dict):
    """Seeded codes_lists (shared by the cases of one geometry), list ids
    [B, n] int32 and tables [B, S, K] fp32 on the card."""
    tag, L, C, S, K, B, n, kind = case
    key = (L, C, S, K)
    if key not in codes_cache:
        gen = torch.Generator(device="cuda").manual_seed(L + C + S + K)
        codes_cache.clear()
        codes_cache[key] = torch.randint(0, K, (L, C, S), generator=gen, device="cuda", dtype=torch.uint8)
    codes = codes_cache[key]
    if tag == "unaligned":  # the same codes one byte past a 16-byte boundary
        flat = torch.empty(L * C * S + 16, dtype=torch.uint8, device="cuda")
        codes = flat[1:1 + L * C * S].view(L, C, S)
        codes.copy_(codes_cache[key])
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + n)
    if kind == "all":
        ids = torch.stack([torch.randperm(L, generator=gen, device="cuda") for _ in range(B)])
    elif kind == "one":
        ids = torch.full((B, n), L // 2, device="cuda")
    elif kind == "distinct":
        ids = torch.stack([torch.randperm(L, generator=gen, device="cuda")[:n] for _ in range(B)])
    else:  # repeated and unordered
        ids = torch.randint(0, L, (B, n), generator=gen, device="cuda")
        ids[:, -1] = ids[:, 0]
    tables = torch.randn((B, S, K), generator=gen, device="cuda") / math.sqrt(S)
    return codes, ids.to(torch.int64), tables


def launcher(torch, job, codes, ids, tables):
    """(the call, the launch alone, the parent's form) for a tree: functions
    returning [B, n, C] scores."""
    from ..ops.adc import adc_plan

    _, C, S = codes.shape
    B, n = ids.shape
    K = tables.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    ids_flat = ids.reshape(-1).long()
    arange = torch.arange(B * n, device="cuda")

    def gathered():
        return codes[ids_flat]

    if job["new"]:
        def plan_of(cl):
            plan = (ctypes.c_int * 7)()
            aligned = cl.data_ptr() % 16 == 0
            if job["cdll"].evr_adc_plan(cl.shape[0], C, S, K, B * n, int(aligned), plan) != 0:
                raise RuntimeError(f"{job['name']}: no plan for L {cl.shape[0]} C {C} S {S} K {K} P {B * n}")
            py = tuple(adc_plan(cl.shape[0], C, S, K, B * n, aligned))
            if pathlib.Path(job["tree"]) == build.CSRC.resolve() and tuple(plan) != py:
                raise RuntimeError(f"{job['name']}: the C plan {tuple(plan)} is not adc_plan's {py}")
            return tuple(plan)

        def code_major():
            return tables.transpose(1, 2).contiguous()

        def run(cl, ii, tt):
            out = torch.empty((B, n, C), dtype=torch.float32, device="cuda")
            rc = job["cdll"].evr_adc_probe_scores(cl.data_ptr(), cl.shape[0], C, S, ii.data_ptr(), B, n,
                                                  tt.data_ptr(), K, out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{job['name']}: launch failed with {rc}")
            return out

        blocks = gathered()
        plan = plan_of(codes)
        plan_of(blocks)
        ready = code_major()
        return {
            "call": lambda: run(codes, ids, code_major()),
            "kernel": lambda: run(codes, ids, ready),
            "gathered_call": lambda: run(gathered(), arange, code_major()),
            "gathered_kernel": lambda: run(blocks, arange, ready),
        }, plan

    def old(blocks):
        out = torch.empty((B, n, C), dtype=torch.float32, device="cuda")
        rc = job["cdll"].evr_adc_list_scores(blocks.data_ptr(), tables.data_ptr(), B * n, C, S, K, n,
                                             out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{job['name']}: launch failed with {rc}")
        return out

    blocks = gathered()
    return {"gathered_call": lambda: old(gathered()), "gathered_kernel": lambda: old(blocks)}, None


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


def device_ms(torch, fn, iters: int = 20) -> float:
    """The device time of K7's kernels (names holding ``adc_``) per call of
    ``fn``, from a ``torch.profiler`` trace: the launches' own time, without
    the host's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) or e.cuda_time_total
             for e in prof.key_averages() if "adc_" in e.key)
    return us / iters / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", type=pathlib.Path,
                    help="an ops/csrc directory (repeatable; default this package's)")
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON result here")
    ap.add_argument("--sass-dir", type=pathlib.Path, help="write each tree's SASS there")
    ap.add_argument("--cases", help="comma-separated case tags to run (default: all)")
    args = ap.parse_args(argv)
    import torch

    from ..index.ivfpq import adc_gather_sum
    from ..ops.adc import adc_bytes, adc_probe_scores_plain

    if not torch.cuda.is_available():
        print("adc_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    trees = [p.resolve() for p in (args.csrc or [build.CSRC])]
    result = {"card": card, "checks": [], "times": []}
    ok = True
    cases = [c for c in CASES if not args.cases or c[0] in args.cases.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        jobs = build_trees(trees, pathlib.Path(tmp), args.sass_dir)
        result["sass"] = {j["name"]: j["sass"] for j in jobs}
        codes_cache: dict = {}
        for case in cases:
            tag, L, C, S, K, B, n, kind = case
            codes, ids, tables = case_inputs(torch, case, codes_cache)
            ref = adc_probe_scores_plain(codes, ids, tables)
            fns = {}
            for job in jobs:
                fns[job["name"]], plan = launcher(torch, job, codes, ids, tables)
                for form, fn in fns[job["name"]].items():
                    if form in ("call", "gathered_call"):
                        got = fn()
                        torch.cuda.synchronize()
                        same = bool(torch.equal(got, ref))
                        ok &= same
                        rec = {"tree": job["name"], "case": tag, "L": L, "C": C, "S": S, "K": K, "B": B,
                               "n": n, "ids": kind, "plan": plan, "bit_equal": same,
                               "max_abs_err": float((got - ref).abs().max())}
                        result["checks"].append(rec)
                        log(f"check {json.dumps(rec)}")
            del ref
            if tag not in TIMED:
                continue
            order = [j["name"] for j in jobs]
            runs = {name: {} for name in order}
            for name in order + order[::-1]:
                for form, fn in fns[name].items():
                    runs[name][form] = min(cuda_ms(torch, fn), runs[name].get(form, math.inf))
                    if form.endswith("kernel"):
                        dev = f"{form}_device"
                        runs[name][dev] = min(device_ms(torch, fn), runs[name].get(dev, math.inf))
            P = B * n
            ids_flat = ids.reshape(-1).long()
            copy_ms = cuda_ms(torch, lambda: codes[ids_flat])
            gather_sum_ms = library_ms = None
            if P * C * S * 8 <= LIBRARY_MAX_BYTES:
                gather_sum_ms = cuda_ms(torch, lambda: adc_gather_sum(codes[ids], tables), iters=10)
                blocks = codes[ids_flat]
                owner = torch.arange(P, device="cuda") // n

                def library():
                    t = tables[owner][:, None].expand(P, C, S, K)
                    return torch.gather(t, 3, blocks.long()[..., None])[..., 0].sum(dim=2)

                library_ms = cuda_ms(torch, library, iters=10)
                del blocks
            lists = int(torch.unique(ids).numel())
            nbytes = adc_bytes(lists, C, S, K, B, P)
            t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, P * C * S / H100_FP32_FLOPS * 1e3
            rec = {"case": tag, "L": L, "C": C, "S": S, "K": K, "B": B, "n": n, "distinct_lists": lists,
                   "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations", "gather_copy_ms": copy_ms,
                   "adc_gather_sum_ms": gather_sum_ms, "library_ms": library_ms, "trees": runs}
            result["times"].append(rec)
            log(f"time {json.dumps(rec)}")
            torch.cuda.empty_cache()
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
