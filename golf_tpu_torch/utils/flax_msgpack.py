"""A reader of flax's msgpack state files (``flax.serialization.to_bytes``)
without flax or msgpack.

A state file is one msgpack map of nested maps keyed by strings; each leaf
array is a msgpack ext of code 1 whose payload is itself msgpack: the array
``[shape, dtype name, raw bytes]`` in C order. The reader decodes the
subset such files use: nil, booleans, integers, floats, strings, binary,
arrays, maps and exts. ``bfloat16`` leaves become float32 (the uint16 bits
shifted left by 16, exact); other dtypes keep their numpy dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1


def _array(payload: bytes) -> np.ndarray:
    (shape, dtype, raw), end = _decode(payload, 0)
    if end != len(payload):
        raise ValueError("trailing bytes in an ndarray ext")
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, np.dtype("<u2")).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, np.dtype(dtype)).copy()
    return arr.reshape(tuple(shape))


def _ext(code: int, payload: bytes) -> Any:
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext code {code}")
    return _array(payload)


def _decode(buf: bytes, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b <= 0x7F:                                   # positive fixint
        return b, i
    if b >= 0xE0:                                   # negative fixint
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:                           # fixmap
        return _map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:                           # fixarray
        return _list(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:                           # fixstr
        n = b & 0x1F
        return buf[i:i + n].decode("utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
             0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
             0xDC: (">H", "array"), 0xDD: (">I", "array"),
             0xDE: (">H", "map"), 0xDF: (">I", "map")}
    if b in sized:
        fmt, kind = sized[b]
        (n,), i = struct.unpack_from(fmt, buf, i), i + struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[i:i + n]), i + n
        if kind == "str":
            return buf[i:i + n].decode("utf-8"), i + n
        return (_list if kind == "array" else _map)(buf, i, n)
    numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in numbers:
        fmt = numbers[b]
        (v,) = struct.unpack_from(fmt, buf, i)
        return v, i + struct.calcsize(fmt)
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    ext = {0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
    if b in ext:
        fmt = ext[b]
        (n,), i = struct.unpack_from(fmt, buf, i), i + struct.calcsize(fmt)
        code = struct.unpack_from(">b", buf, i)[0]
        return _ext(code, bytes(buf[i + 1:i + 1 + n])), i + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _list(buf: bytes, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _decode(buf, i)
        out.append(v)
    return out, i


def _map(buf: bytes, i: int, n: int) -> Tuple[Dict, int]:
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i)
        v, i = _decode(buf, i)
        out[k] = v
    return out, i


def loads(data: bytes) -> Any:
    """Decode one msgpack object (a flax state dict: nested dicts of numpy
    arrays)."""
    out, end = _decode(memoryview(data).tobytes(), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes")
    return out


def load(path: str) -> Any:
    with open(path, "rb") as fh:
        return loads(fh.read())
