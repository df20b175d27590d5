"""ctypes binding and first-use build of the native frame stager.

``src/image_loader.cc`` is compiled with ``g++`` on first use into
``build/`` beside this file (git-ignored; the library's name carries a hash
of the source, so an edited source builds anew). The build needs no library
but the C++ runtime. There is no fallback: a stager that cannot be built or
loaded raises with the compiler's output.

The stager takes JPEG files only, as the JAX package's libjpeg stager
does: a file that does not start with the JPEG marker fails like one that
does not decode. Decoding is cv2's (``IMREAD_COLOR |
IMREAD_IGNORE_ORIENTATION``: grey replicated, EXIF orientation not applied,
as libjpeg decodes to RGB; cv2 bundles the same libjpeg-turbo on every host,
where a system libjpeg may be absent); the resize and crop are the C++
code's, on a thread pool (cv2's decode and the ctypes call both release the
interpreter lock).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "src" / "image_loader.cc"
_BUILD = _HERE / "build"
_lock = threading.Lock()
_lib_handle = None


def build_native() -> pathlib.Path:
    """Compile the shared library (once per source version) and return its
    path; raises RuntimeError with the compiler's output when it fails."""
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    lib = _BUILD / f"libevr_stage_{digest}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders (test
    # workers) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build the native stager ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"cannot build the native stager ({' '.join(cmd)}), exit {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def _get_lib():
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build_native()))
            lib.evr_stage_pixels.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int,
            ]
            lib.evr_stage_pixels.restype = ctypes.c_int
            _lib_handle = lib
        return _lib_handle


class NativeStager:
    """Batch JPEG files → staged uint8 [N, S, S, 3] RGB (decode, Pillow
    bicubic shortest-side resize, centre crop) on a thread pool."""

    def __init__(self, image_size: int = 224, n_threads: int | None = None):
        self.image_size = image_size
        self.n_threads = n_threads or max(1, os.cpu_count() or 1)
        self._lib = _get_lib()

    def stage_pixels(self, img: np.ndarray, out: np.ndarray, bgr: bool) -> int:
        """Stage one decoded uint8 [H, W, 3] image (BGR when ``bgr``) into
        ``out`` (uint8 [S, S, 3], C-contiguous); returns the C status, 0 on
        success."""
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"need uint8 [H, W, 3] pixels, got {img.dtype} {img.shape}")
        if img.strides[1:] != (3, 1):
            img = np.ascontiguousarray(img)
        size = self.image_size
        if out.shape != (size, size, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"need a C-contiguous uint8 [{size}, {size}, 3] output")
        h, w = img.shape[:2]
        return self._lib.evr_stage_pixels(
            img.ctypes.data, w, h, img.strides[0], int(bgr), out.ctypes.data, size)

    def _stage_file(self, path, out: np.ndarray) -> int:
        import cv2

        try:
            data = np.fromfile(str(path), np.uint8)
        except OSError:
            return 1
        if data[:2].tobytes() != b"\xff\xd8":  # not a JPEG
            return 1
        img = cv2.imdecode(data, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            return 1
        return self.stage_pixels(img, out, bgr=True)

    def stage_batch(self, paths) -> tuple[np.ndarray, list[int]]:
        """Stage a list of JPEG paths → (uint8 [N, S, S, 3], ok indices).

        A file that fails to decode is reported by its absence from the ok
        indices (its row is left unwritten); callers drop those rows."""
        paths = list(paths)
        size = self.image_size
        out = np.empty((len(paths), size, size, 3), dtype=np.uint8)
        if not paths:
            return out, []
        with ThreadPoolExecutor(max_workers=min(self.n_threads, len(paths))) as pool:
            status = list(pool.map(lambda i: self._stage_file(paths[i], out[i]), range(len(paths))))
        return out, [i for i, rc in enumerate(status) if rc == 0]
