"""The msgpack codec of flax's checkpoint files, in plain Python.

A flax checkpoint (`flax.serialization.to_bytes`) is one msgpack map with
string keys.  flax writes tuples and lists as maps keyed '0', '1', ...; an
array as ext type 1 whose payload is the msgpack array [shape, dtype name,
C-order bytes]; a numpy scalar as ext type 3 with the same payload (shape
[]); a Python int, float, bool or None as itself.  Arrays over 2**30 bytes
it splits into a `__msgpack_chunked_array__` map, which no model of this
repository has: this codec refuses that marker both ways.

`unpackb` keeps the order of every map it reads and `packb` writes each
value in msgpack's smallest form, as the msgpack package does, so a file
read and written back is the same bytes.  Arrays come back as writable
numpy arrays; a `bfloat16` array (numpy has no such dtype) comes back as a
torch bfloat16 tensor, and `packb` writes such a tensor as flax would.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
MAX_LEAF_BYTES = 2 ** 30


# --------------------------------------------------------------------- pack

def _pack_uint_header(out: bytearray, n: int, small: Tuple[int, int],
                      codes: Tuple[int, int, int], what: str) -> None:
    """A length header: `small` = (first byte, limit) of the fix form (or
    (None, 0)), then the 8/16/32-bit forms' codes (None where msgpack has
    none for this type)."""
    fix, limit = small
    if fix is not None and n < limit:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += bytes((codes[0], n))
    elif n < 2 ** 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 2 ** 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"{what} of {n} entries is too long for msgpack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too large for msgpack")
    else:
        for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                               (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} too small for msgpack")


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_uint_header(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), "str")
    out += b


def _pack_bin(out: bytearray, b: bytes) -> None:
    _pack_uint_header(out, len(b), (None, 0), (0xC4, 0xC5, 0xC6), "bin")
    out += b


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_uint_header(out, n, (None, 0), (0xC7, 0xC8, 0xC9), "ext")
    out.append(code)
    out += payload


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    out = bytearray()
    out.append(0x93)
    _pack_uint_header(out, len(shape), (0x90, 16), (None, 0xDC, 0xDD),
                      "shape")
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, dtype_name)
    _pack_bin(out, data)
    return bytes(out)


def _ndarray_payload(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return _array_payload(
                a.shape, "bfloat16",
                a.contiguous().view(torch.int16).numpy().tobytes())
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax "
                         "encoding")
    if a.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"an array of {a.nbytes} bytes would need flax's "
                         f"{CHUNKED} form, which this codec does not write")
    return _array_payload(a.shape, a.dtype.name, a.tobytes("C"))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        _pack_str(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(out, bytes(obj))
    elif isinstance(obj, dict):
        _pack_uint_header(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF),
                          "map")
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_uint_header(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD),
                          "array")
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"no msgpack encoding for {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode a tree of dicts, lists, scalars and arrays as flax does."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ------------------------------------------------------------------- unpack

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)


_WIDTH = {0: 1, 1: 2, 2: 4, 3: 8}


def _read(r: _Reader) -> Any:
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.uint(_WIDTH[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.uint(_WIDTH[b - 0xC7])
        return _read_ext(r.uint(1), r.take(n))
    if b == 0xCA:
        return struct.unpack(">f", r.take(4))[0]
    if b == 0xCB:
        return struct.unpack(">d", r.take(8))[0]
    if 0xCC <= b <= 0xCF:
        return r.uint(_WIDTH[b - 0xCC])
    if 0xD0 <= b <= 0xD3:
        return r.sint(_WIDTH[b - 0xD0])
    if 0xD4 <= b <= 0xD8:
        code = r.uint(1)
        return _read_ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):
        return str(r.take(r.uint(_WIDTH[b - 0xD9])), "utf-8")
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.uint(2 if b == 0xDC else 4))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.uint(2 if b == 0xDE else 4))
    raise ValueError(f"msgpack type byte 0x{b:02x} is not in flax's files")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if CHUNKED in out:
        raise ValueError(f"{CHUNKED}: arrays over 2**30 bytes are not "
                         "supported (no model of this repository has one)")
    return out


def _read_array(payload: memoryview):
    r = _Reader(payload)
    fields = _read(r)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("malformed flax array payload")
    shape, name, buf = fields
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"flax array of dtype {name!r} has no numpy "
                         "counterpart") from e
    return np.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def _read_ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _read_array(payload)
    if code == EXT_NPSCALAR:
        a = _read_array(payload)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack ext type {code} is not in flax's files")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (a flax checkpoint's whole tree)."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return obj
