"""Build the search CUDA kernels with nvcc at first use and load them.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them (one process per source, all started together) and links one shared
library that is bound with ``ctypes``: a build takes seconds, where an
extension that includes PyTorch's headers takes minutes.  The library goes
into ``dewi_tpu_torch/_build/<hash>/``, keyed by a hash of the sources,
headers and flags, so an edited source builds anew and an unchanged one is
reused.  Nothing here runs at import time.
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
SOURCES = ("search_kernels.cu", "stream_kernels.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Wall seconds of the nvcc run that produced the loaded library (0.0 when
# an existing build was reused).
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
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
    # emb, pay, q, nq, d, cap, n_valid, 1 - eta, eta, entropy_pref / 2, k,
    # chunks, part_scores, part_ids, out_scores, out_ids, stream
    "dewi_stream_search": (_P, _P, _P, _I, _I, _L, _I, _F, _F, _F, _I, _I,
                           _P, _P, _P, _P, _P),
    # emb, scales, then as dewi_stream_search from pay on, with max_ctas
    # (the rows of the partial lists) in place of chunks
    "dewi_int8_stream_search": (_P, _P, _P, _P, _I, _I, _L, _I, _F, _F, _F, _I, _I,
                                _P, _P, _P, _P, _P),
    # d
    "dewi_stream_queries_per_launch": (_I,),
    # d
    "dewi_int8_stream_queries_per_launch": (_I,),
    # nq, d
    "dewi_int8_stream_max_ctas": (_I, _I),
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
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the search "
        "CUDA kernels are built from dewi_tpu_torch/csrc at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libdewi_search.so"


def _compile(out: Path) -> None:
    """Compile every source to an object, all at once, then link them."""
    global build_seconds
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        logs = [" ".join(c) + "\n" + p.communicate()[0] for c, p in zip(cmds, procs)]
        failed = [p.returncode for p in procs if p.returncode != 0]
        lib = str(Path(tmp) / "lib.so")
        if not failed:
            link = [nvcc, "-shared", "-o", lib, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.returncode)
        build_seconds = time.perf_counter() - t0
        log = "\n".join(logs)
        (out.parent / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed (rc {failed[0]}):\n{log[-4000:]}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing


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
