"""The msgpack layout of ``flax.serialization``, read and written without flax.

The reference's checkpoints (``dewi_tpu/models/registry.py`` ``save_params``)
are ``flax.serialization.to_bytes`` of a param tree: nested msgpack maps
with string keys whose leaves are ndarrays, each packed as ext type 1 around
a nested msgpack ``(shape, dtype name, row-major bytes)`` triple.  The card
has neither flax nor msgpack, so this module carries the few msgpack types
that layout uses (RFC: https://github.com/msgpack/msgpack/blob/master/spec.md).
Ints, floats and strings are written in the smallest form, as msgpack-python
writes them.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, m8: int, m16: int,
              m32: int) -> None:
    if n <= fix_max and fix >= 0:
        out.append(bytes([fix | n]))
    elif n < 1 << 8 and m8 >= 0:
        out.append(bytes([m8, n]))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", m16, n))
    else:
        out.append(struct.pack(">BI", m32, n))


_UINTS = ((1 << 8, 0xCC, ">BB"), (1 << 16, 0xCD, ">BH"), (1 << 32, 0xCE, ">BI"),
          (1 << 64, 0xCF, ">BQ"))
_INTS = ((1 << 7, 0xD0, ">Bb"), (1 << 15, 0xD1, ">Bh"), (1 << 31, 0xD2, ">Bi"),
         (1 << 63, 0xD3, ">Bq"))


def _pack_int(out: List[bytes], v: int) -> None:
    if -32 <= v < 128:  # positive and negative fixint
        out.append(struct.pack(">b", v) if v < 0 else bytes([v]))
        return
    for lim, code, fmt in (_UINTS if v >= 0 else _INTS):
        if (v < lim) if v >= 0 else (v >= -lim):
            out.append(struct.pack(fmt, code, v))
            return
    raise OverflowError(v)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    return packb((tuple(int(s) for s in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        data = _ndarray_payload(obj)
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(bytes([fixext[n], EXT_NDARRAY]))
        elif n < 1 << 8:
            out.append(bytes([0xC7, n, EXT_NDARRAY]))
        elif n < 1 << 16:
            out.append(struct.pack(">BHB", 0xC8, n, EXT_NDARRAY))
        else:
            out.append(struct.pack(">BIB", 0xC9, n, EXT_NDARRAY))
        out.append(data)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), -1, -1, 0xC4, 0xC5, 0xC6)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, -1, 0xDC, 0xDD)
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, -1, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, numbers, ndarrays)."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if name == "bfloat16":  # widen exactly: bf16 is the top half of an f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def ext(self, n: int) -> Any:
        (code,) = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self) -> Any:
        (b,) = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in lengths:
            return self.take(self.unpack(lengths[b])[0])
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])[0])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])[0]
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])[0]).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I")[0])]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I")[0])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """Inverse of :func:`packb`; ndarray ext records come back as numpy arrays."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


__all__ = ["packb", "unpackb"]
