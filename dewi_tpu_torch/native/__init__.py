"""ctypes bindings of the port's native C++ runtime: the ``payloads.jsonl``
codec, the minhash shingle hasher and the GIL-free JPEG decode pool.

The port's counterpart of ``dewi_tpu/native``.  The sources are the port's
own copies, ``dewi_tpu_torch/csrc/native/*.cpp``; at first use they are
built with ``g++`` (or ``$CXX``, flags ``$CXXFLAGS`` or the defaults below)
into ``dewi_tpu_torch/_build/native/libdewi_native.so``, and built again
when a source is newer than the library.  The JPEG pool is compiled in only
where a probe program compiles and links against libjpeg with
``jpeg_mem_src``.  Nothing is written outside ``_build/native/``.

Everything degrades to Python when the library is absent and cannot be
built (a warning says why).  Set ``DEWI_TPU_NO_NATIVE=1`` to force the
Python paths.

The Python JSONL writer writes the very bytes the native one writes: floats
in the shortest form that reads back as the same float32 (``std::to_chars``:
fixed or scientific, whichever is shorter, fixed on a tie), ids escaped as
the native writer escapes them.
"""

from __future__ import annotations

import ctypes
import json
import logging
import math
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..types import PAYLOAD_FIELDS, Payload

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc" / "native"
SOURCES = ("dewi_native.cpp", "dewi_jpeg.cpp")
BUILD_DIR = _PKG / "_build" / "native"
LIB_PATH = BUILD_DIR / "libdewi_native.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native")
# Compiles and links only where libjpeg provides jpeg_mem_src (libjpeg >= 8
# or any libjpeg-turbo), so a header-only toolchain cannot break the build.
JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
              "int main(){jpeg_decompress_struct c; "
              "jpeg_mem_src(&c, (const unsigned char*)0, 0); return 0;}\n")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Set by the build that produced the loaded library (None: reused a build).
build_seconds: Optional[float] = None
built_with_jpeg: Optional[bool] = None


def _compiler() -> Tuple[str, List[str]]:
    flags = os.environ.get("CXXFLAGS")
    return os.environ.get("CXX", "g++"), (flags.split() if flags else list(CXXFLAGS))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((SRC_DIR / s).stat().st_mtime > built for s in SOURCES)


def _have_jpeg(cxx: str) -> bool:
    try:
        proc = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull, "-ljpeg"],
                              input=JPEG_PROBE, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return proc.returncode == 0


def build() -> Path:
    """Compile the library into ``BUILD_DIR`` (atomically: a concurrent
    loader sees the old library or the new one, never half of one)."""
    global build_seconds, built_with_jpeg
    cxx, flags = _compiler()
    t0 = time.perf_counter()
    jpeg = _have_jpeg(cxx)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *flags, *(["-DDEWI_HAVE_JPEG"] if jpeg else []), "-shared", "-o", tmp,
           *(str(SRC_DIR / s) for s in SOURCES), *(["-ljpeg"] if jpeg else [])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    built_with_jpeg = jpeg
    return LIB_PATH


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dewi_write_payloads_jsonl.restype = ctypes.c_int64
    lib.dewi_write_payloads_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.dewi_read_payloads_jsonl.restype = ctypes.c_int64
    lib.dewi_read_payloads_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.dewi_minhash.restype = ctypes.c_int64
    lib.dewi_minhash.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dewi_has_jpeg.restype = ctypes.c_int32
    lib.dewi_has_jpeg.argtypes = []
    lib.dewi_decode_jpeg_batch.restype = ctypes.c_int64
    lib.dewi_decode_jpeg_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Load the library, building it first when it is absent or stale;
    None when it is switched off or cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("DEWI_TPU_NO_NATIVE", "").lower() in ("1", "true", "yes"):
            return None
        try:
            if _stale():
                build()
        except Exception as e:  # noqa: BLE001 — host code: Python paths remain
            logger.warning("Native build failed (%s); using the Python paths.", e)
            if not LIB_PATH.exists():
                return None
        try:
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
        except (OSError, AttributeError) as e:
            logger.warning("Native library load failed (%s); using Python.", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


_KEYS_CSV = ",".join(PAYLOAD_FIELDS).encode()


# ---------------------------------------------------------------------------
# payloads.jsonl codec
# ---------------------------------------------------------------------------

_ESCAPES = {'"': '\\"', "\\": "\\\\", "\n": "\\n", "\r": "\\r", "\t": "\\t"}


def _escape(s: str) -> str:
    """JSON string body as the native writer escapes it: quotes, backslash,
    the three whitespace escapes, other control bytes as ``\\u00XX``,
    everything else as it is (UTF-8 on disk)."""
    return "".join(_ESCAPES.get(c) or (f"\\u{ord(c):04x}" if ord(c) < 0x20 else c)
                   for c in s)


def float_text(v: Any) -> str:
    """``std::to_chars(float)``: the shortest text that reads back as the
    same float32, fixed or scientific, whichever is shorter (fixed on a
    tie).  Fixed notation prints an integral value's exact digits, as
    ``printf("%f")`` would, not the shortest digits padded with zeros."""
    x = np.float32(v)
    if math.isnan(x):
        return "-nan" if np.signbit(x) else "nan"
    if math.isinf(x):
        return "-inf" if x < 0 else "inf"
    if x != 0 and float(x).is_integer():
        fixed = str(int(x))
    else:
        fixed = np.format_float_positional(x, unique=True, trim="-")
    sci = np.format_float_scientific(x, unique=True, trim="-", exp_digits=2)
    return sci if len(sci) < len(fixed) else fixed


def _python_write(path: Any, doc_ids: Sequence[str], matrix: np.ndarray) -> None:
    keys = PAYLOAD_FIELDS
    with open(path, "wb") as f:
        for doc_id, row in zip(doc_ids, matrix):
            body = ", ".join(f'"{k}": {float_text(v)}' for k, v in zip(keys, row))
            line = f'{{"doc_id": "{_escape(str(doc_id))}", "payload": {{{body}}}}}\n'
            f.write(line.encode("utf-8"))


def write_payloads_jsonl(path: Any, doc_ids: Sequence[str], matrix: np.ndarray) -> None:
    """Write ``{"doc_id": ..., "payload": {...}}`` lines (native when the
    library is built and no id holds a newline; the same bytes either way)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    n = matrix.shape[0]
    if matrix.ndim != 2 or matrix.shape[1] != len(PAYLOAD_FIELDS) or n != len(doc_ids):
        raise ValueError(f"payloads {matrix.shape} do not match {len(doc_ids)} ids x "
                         f"{len(PAYLOAD_FIELDS)} fields")
    lib = _load()
    if lib is not None and "\n" not in "".join(doc_ids):
        ids_nl = "\n".join(doc_ids).encode("utf-8")
        rc = lib.dewi_write_payloads_jsonl(
            str(path).encode(), ids_nl,
            matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(n), _KEYS_CSV,
        )
        if rc >= 0:
            return
        logger.warning("Native JSONL write failed (rc=%d); Python fallback.", rc)
    _python_write(path, doc_ids, matrix)


def _native_read_safe(path: Path) -> bool:
    """The read side of the writer's newline guard: an id escaped as
    ``\\n`` or ``\\u0000`` would shift or cut the C parser's ``\\n``-joined
    id buffer, so such a file is read by the Python parser."""
    try:
        data = path.read_bytes()
    except OSError:
        return False
    return b"\\n" not in data and b"\\u0000" not in data


def read_payloads_jsonl(path: Any) -> Tuple[List[str], np.ndarray]:
    """Read back ``(doc_ids, [N, 8] matrix)``; tolerant of missing and extra
    keys; ``"id"`` is accepted in place of ``"doc_id"``."""
    path = Path(path)
    lib = _load()
    if lib is not None and _native_read_safe(path):
        data_len = path.stat().st_size
        max_rows = max(1, data_len // 16)  # a line is longer than 16 bytes
        out = np.zeros((max_rows, len(PAYLOAD_FIELDS)), dtype=np.float32)
        ids_cap = data_len + max_rows + 16
        ids_buf = ctypes.create_string_buffer(ids_cap)
        rc = lib.dewi_read_payloads_jsonl(
            str(path).encode(), _KEYS_CSV,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(max_rows), ids_buf, ctypes.c_int64(ids_cap),
        )
        if rc >= 0:
            ids = ids_buf.value.decode("utf-8").split("\n") if rc else []
            return ids[: int(rc)], out[: int(rc)]
        logger.warning("Native JSONL read failed (rc=%d); Python fallback.", rc)
    ids: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            ids.append(str(d.get("doc_id", d.get("id", ""))))
            rows.append(Payload.from_dict(d.get("payload", {})).to_array())
    mat = (np.stack(rows) if rows
           else np.zeros((0, len(PAYLOAD_FIELDS)), np.float32))
    return ids, mat


# ---------------------------------------------------------------------------
# minhash
# ---------------------------------------------------------------------------


def minhash_signatures_native(texts: Sequence[str], num_hashes: int = 64, seed: int = 0,
                              k: int = 3) -> Optional[np.ndarray]:
    """Native minhash (FNV-1a over ASCII-lowercased shingle bytes); None when
    the library is unavailable or a text holds the record separator."""
    lib = _load()
    if lib is None:
        return None
    if any("\x1e" in t for t in texts):
        return None
    rng = np.random.default_rng(seed)
    p = (1 << 61) - 1
    a = rng.integers(1, p, size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, p, size=num_hashes, dtype=np.uint64)
    sigs = np.full((len(texts), num_hashes), np.iinfo(np.uint64).max, dtype=np.uint64)
    blob = "\x1e".join(texts).encode("utf-8", errors="replace")
    rc = lib.dewi_minhash(
        blob, ctypes.c_int64(len(texts)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(num_hashes), ctypes.c_int64(k),
        sigs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != len(texts):
        return None
    return sigs


# ---------------------------------------------------------------------------
# JPEG decode pool
# ---------------------------------------------------------------------------


def jpeg_pool_available() -> bool:
    """True when the library was built against libjpeg."""
    lib = _load()
    return lib is not None and bool(lib.dewi_has_jpeg())


def decode_jpeg_batch(paths: Sequence[str], size: int, threads: int = 4,
                      out: Optional[np.ndarray] = None
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """GIL-free batched JPEG decode: ``([n, size, size, 3] uint8, [n] bool)``.

    The mask marks the slots that decoded natively; the caller decodes the
    rest (non-JPEG bytes, CMYK, truncated files) with PIL.  None when the
    pool is unavailable.  libjpeg decodes at the smallest DCT scale still at
    least the target (PIL's draft trick), then a centre-aligned bilinear
    resize.  With ``out`` the rows go straight into the caller's C-contiguous
    buffer, and failed slots are left as they were.
    """
    if not paths or not jpeg_pool_available():
        return None
    if any("\n" in p for p in paths):
        return None
    lib = _load()
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), dtype=np.uint8)
    elif (out.shape != (n, size, size, 3) or out.dtype != np.uint8
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous uint8 {(n, size, size, 3)}, "
                         f"got {out.dtype} {out.shape}")
    ok = np.zeros(n, dtype=np.uint8)
    rc = lib.dewi_decode_jpeg_batch(
        "\n".join(paths).encode("utf-8"), ctypes.c_int64(n),
        ctypes.c_int32(int(size)), ctypes.c_int32(max(1, int(threads))),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        return None
    return out, ok.astype(bool)


__all__ = [
    "available", "build", "float_text",
    "write_payloads_jsonl", "read_payloads_jsonl",
    "minhash_signatures_native", "jpeg_pool_available", "decode_jpeg_batch",
    "LIB_PATH", "BUILD_DIR", "SRC_DIR",
]
