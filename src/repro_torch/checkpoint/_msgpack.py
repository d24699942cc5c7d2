"""A small msgpack writer and reader, for the checkpoint files.

The port carries its own codec because the card's machine has no msgpack
package.  It covers what the checkpoint payloads hold: maps (string keys
in practice, any key this module can write), arrays (lists and tuples;
read back as lists), str, bin (``bytes``), ints of every width, float
(float64), bool and nil.  ``packb(obj)`` writes the bytes that
``msgpack.packb(obj, use_bin_type=True)`` writes, and ``unpackb(data)``
reads what ``msgpack.unpackb(data, raw=False)`` reads (float32 and the
ext types aside: ext raises).
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack_len(out: List[bytes], n: int, fix_base: int, fix_max: int,
              codes: Tuple[Tuple[int, int, str], ...]) -> None:
    """The header of a container or string of ``n`` entries: a fix type
    when ``n < fix_max``, else the first of ``codes`` ``(limit, code,
    struct format)`` whose limit exceeds ``n``."""
    if n < fix_max:
        out.append(bytes((fix_base | n,)))
        return
    for limit, code, fmt in codes:
        if n < limit:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack cannot hold {n} entries")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if v < limit:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} too large for msgpack")
    else:
        for limit, code, fmt in ((-(1 << 7), 0xD0, ">b"),
                                 (-(1 << 15), 0xD1, ">h"),
                                 (-(1 << 31), 0xD2, ">i"),
                                 (-(1 << 63), 0xD3, ">q")):
            if v >= limit:
                out.append(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} too small for msgpack")


_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARR = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, _STR)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, 0, _BIN)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, _ARR)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} as msgpack")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (bin for ``bytes``, str8 for short text)."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


# type byte → value, number format, or (length format, kind)
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xDC: (">H", "arr"), 0xDD: (">I", "arr"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def pairs(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b < 0x90:
            return self.pairs(b & 0x0F)
        if 0x90 <= b < 0xA0:
            return self.items(b & 0x0F)
        if 0xA0 <= b < 0xC0:
            return self.take(b & 0x1F).decode("utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.num(_NUMBERS[b])
        if b not in _SIZED:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        fmt, kind = _SIZED[b]
        n = self.num(fmt)
        if kind == "str":
            return self.take(n).decode("utf-8")
        if kind == "bin":
            return self.take(n)
        return self.items(n) if kind == "arr" else self.pairs(n)


def unpackb(data: bytes) -> Any:
    """The object msgpack ``data`` holds (arrays as lists, bin as
    ``bytes``); trailing bytes are an error."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(data):
        raise ValueError("extra bytes after the msgpack object")
    return obj
