"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. Libraries are built on first
use into ``ops/build/`` (listed in ``.gitignore``), named by a hash of their
sources so an edited kernel is rebuilt, and several sources compile in
parallel (one ``nvcc`` process each). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "build"
KERNEL_SOURCES = (
    "block_attn", "block_mlp", "block_quant", "topk_fused", "block_attn_bwd", "block_mlp_bwd",
    "adc_list", "flash_attn", "layernorm", "block_merged",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Built library for ``csrc/<name>.cu``, keyed by its sources' hash."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes started together. Returns seconds per library built; the
    compiler's register/spill report lands beside it as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    times = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _declare(name, lib)
            _loaded[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "block_attn":
        fn = lib.evr_fused_attn_block
        fn.argtypes = [i] + [p] * 11 + [i] * 5 + [f, p]
        fn.restype = i
        fn = lib.evr_flash_forward
        fn.argtypes = [i, p, p] + [i] * 5 + [f, p]
        fn.restype = i
    elif name == "block_mlp":
        fn = lib.evr_fused_mlp_block
        fn.argtypes = [i] + [p] * 10 + [i] * 4 + [p]
        fn.restype = i
        fn = lib.evr_gemm_bf16
        fn.argtypes = [p] * 4 + [i] * 3 + [p]
        fn.restype = i
    elif name == "block_quant":
        fn = lib.evr_fused_attn_block_q
        fn.argtypes = [i] + [p] * 14 + [i, i, i, i, i, f, p]
        fn.restype = i
        fn = lib.evr_fused_mlp_block_q
        fn.argtypes = [i] + [p] * 15 + [i, i, i, i, p]
        fn.restype = i
    elif name == "topk_fused":
        fn = lib.evr_fused_topk
        fn.argtypes = [i, p, p, p, i, i, i, i, i, i, p, p, p]
        fn.restype = i
    elif name == "block_attn_bwd":
        fn = lib.evr_fused_attn_block_bwd
        fn.argtypes = [i] + [p] * 26 + [i] * 5 + [f, p]
        fn.restype = i
        fn = lib.evr_flash_backward
        fn.argtypes = [i] + [p] * 6 + [i] * 5 + [f, p]
        fn.restype = i
        fn = lib.evr_gemm_bf16_t
        fn.argtypes = [p] * 5 + [i] * 7 + [p]
        fn.restype = i
    elif name == "block_mlp_bwd":
        fn = lib.evr_fused_mlp_block_bwd
        fn.argtypes = [i] + [p] * 23 + [i] * 4 + [p]
        fn.restype = i
    elif name == "adc_list":
        fn = lib.evr_adc_list_scores
        fn.argtypes = [p, p, i, i, i, i, i, p, p]
        fn.restype = i
    elif name == "flash_attn":
        fn = lib.evr_flash_attention
        fn.argtypes = [i, p, p, p, p, i, i, i, i, f, p]
        fn.restype = i
    elif name == "layernorm":
        fn = lib.evr_fused_layer_norm
        fn.argtypes = [i, p, p, p, p, i, i, i, p]
        fn.restype = i
    elif name == "block_merged":
        fn = lib.evr_fused_block_merged
        fn.argtypes = [i] + [p] * 19 + [i] * 7 + [f, p]
        fn.restype = i
    else:
        raise KeyError(f"unknown kernel library {name!r}")
