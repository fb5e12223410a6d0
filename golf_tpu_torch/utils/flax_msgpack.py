"""A reader and a writer of flax's msgpack state files
(``flax.serialization.to_bytes``) without flax or msgpack.

A state file is one msgpack map of nested maps keyed by strings; each leaf
array is a msgpack ext of code 1 whose payload is itself msgpack: the array
``[shape, dtype name, raw bytes]`` in C order. The reader decodes the
subset such files use: nil, booleans, integers, floats, strings, binary,
arrays, maps and exts. ``bfloat16`` leaves become float32 (the uint16 bits
shifted left by 16, exact); other dtypes keep their numpy dtype. The
writer (``dumps``, ``dump``) packs nested dicts of arrays the same way,
keys in sorted order, optionally rounding float32 leaves to ``bfloat16``
(round to nearest even, as numpy's ``bfloat16`` cast does).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

class _BF16:
    """A bfloat16 leaf: its bits (uint16) in the leaf's shape."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


def _header(n: int, fix: Optional[int], codes) -> bytes:
    """A length header: ``fix | n`` in the fix form where it fits (16
    entries for maps and arrays, 32 bytes for strings), else the 8-, 16- or
    32-bit form of ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n < (32 if fix == 0xA0 else 16):
        return bytes([fix | n])
    for code, fmt in zip(codes, ("B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


def _ext_ndarray(shape, dtype: str, raw: bytes) -> bytes:
    payload: list = []
    _encode([list(shape), dtype, raw], payload)
    body = b"".join(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fix[len(body)]]) if len(body) in fix else \
        _header(len(body), None, (0xC7, 0xC8, 0xC9))
    return head + bytes([_EXT_NDARRAY]) + body


def _encode(obj: Any, out: list) -> None:
    if isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, (None, 0xDE, 0xDF)))
        for key in sorted(obj):
            _encode(str(key), out)
            _encode(obj[key], out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, (None, 0xDC, 0xDD)))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, bytes):
        out.append(_header(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj)
    elif isinstance(obj, (int, np.integer)) and 0 <= int(obj) < 1 << 32:
        v = int(obj)     # positive fixint, else uint 8/16/32
        out.append(bytes([v]) if v <= 0x7F else
                   _header(v, None, (0xCC, 0xCD, 0xCE)))
    elif isinstance(obj, _BF16):
        out.append(_ext_ndarray(obj.bits.shape, "bfloat16",
                                obj.bits.tobytes()))
    elif isinstance(obj, np.ndarray):
        out.append(_ext_ndarray(obj.shape, obj.dtype.name,
                                np.ascontiguousarray(obj).tobytes()))
    else:
        raise TypeError(f"cannot write {type(obj).__name__}")


def to_bfloat16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), rounded to nearest even."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bias = ((bits >> 16) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((bits + bias) >> 16).astype(np.uint16)


def dumps(tree: Any, bfloat16: bool = False) -> bytes:
    """Encode a flax state dict (nested dicts of numpy arrays) as flax's
    ``to_bytes`` does; with ``bfloat16`` every float32 leaf is stored as
    ``bfloat16``."""
    def convert(obj):
        if isinstance(obj, dict):
            return {k: convert(v) for k, v in obj.items()}
        arr = np.asarray(obj)
        if bfloat16 and arr.dtype == np.float32:
            return _BF16(to_bfloat16_bits(arr))
        return arr

    out: list = []
    _encode(convert(tree), out)
    return b"".join(out)


def dump(path: str, tree: Any, bfloat16: bool = False) -> None:
    with open(path, "wb") as fh:
        fh.write(dumps(tree, bfloat16))
