"""Build the stage-1 CUDA kernels with nvcc at first use and load them.

``csrc/search_kernels.cu`` has a plain C interface, so it is compiled by
``nvcc`` straight into a shared library and bound with ``ctypes``: a build
takes seconds, where an extension that includes PyTorch's headers takes
minutes.  The library goes into ``dewi_tpu_torch/_build/<hash>/``, keyed by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("search_kernels.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Wall seconds of the nvcc run that produced the loaded library (0.0 when
# an existing build was reused).
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # emb, emb_bf16, q, mult, add, out, out_bf16, nq, d, cap, stream
    "dewi_scores_matrix": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # emb, emb_bf16, q, mult, add, out, nq, d, cap, stream
    "dewi_bmax": (_P, _I, _P, _P, _P, _P, _I, _I, _L, _P),
    # packed, q8, qscale, mult, add, out, out_bf16, nq, d, cap, stream
    "dewi_scores_matrix_s4": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # packed, q8, qscale, mult, add, out, nq, d, cap, stream
    "dewi_bmax_s4": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    # emb, q8, qscale, mult, add, out, out_bf16, nq, d, cap, stream
    "dewi_scores_matrix_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # emb, q8, qscale, mult, add, out, nq, d, cap, stream
    "dewi_bmax_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    # emb, emb_bf16, q, mult, add, out, ldo, nq, d, cap, stream
    "dewi_bmax_t": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # emb, q8, qscale, mult, add, out, ldo, nq, d, cap, stream
    "dewi_bmax_s8_t": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P),
    # kind (0 int8 rows, 1 bf16 rows, 2 packed int4 rows, 3 int8 rows with
    # s8 queries), d
    "dewi_queries_per_launch": (_I, _I),
}


def find_nvcc() -> str:
    """Locate nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the default
    toolkit location.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the stage-1 "
        "CUDA kernels are built from dewi_tpu_torch/csrc at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libdewi_search.so"


def _compile(out: Path) -> None:
    global build_seconds
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.dewi_error_string.argtypes = [ctypes.c_int]
        lib.dewi_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


__all__ = ["find_nvcc", "source_hash", "library_path", "load_library",
           "build_seconds"]
