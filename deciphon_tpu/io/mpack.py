"""A small MessagePack encoder/decoder for the .dcp and h3result formats.

It covers the subset those formats use — nil, booleans, integers, single
and double floats, strings, binary, arrays, maps and ext types — and
produces the same bytes as the `msgpack` package with its defaults
(`use_bin_type=True`, smallest encoding for every integer and length), so
the scan's main path needs nothing outside the standard library and numpy.
Arrays of float32 scalars, the bulk of a pressed profile, decode through
numpy in one step.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np

__all__ = ["ExtType", "Packer", "Unpacker", "packb", "unpackb",
           "FormatError"]


class FormatError(ValueError):
    """Malformed or truncated MessagePack data."""


class ExtType(NamedTuple):
    code: int
    data: bytes


_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_b = struct.Struct(">b")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _len_head(n: int, fix: int | None, fixmax: int, c8: int | None,
              c16: int, c32: int) -> bytes:
    if fix is not None and n <= fixmax:
        return _B.pack(fix | n)
    if c8 is not None and n <= 0xFF:
        return bytes((c8, n))
    if n <= 0xFFFF:
        return bytes((c16,)) + _H.pack(n)
    if n <= 0xFFFFFFFF:
        return bytes((c32,)) + _I.pack(n)
    raise ValueError(f"length {n} exceeds MessagePack's 32-bit limit")


class Packer:
    """Encoder with the `msgpack.Packer` methods the formats use."""

    def __init__(self, use_single_float: bool = False):
        self.use_single_float = use_single_float

    def pack(self, obj) -> bytes:
        out = bytearray()
        self._pack(obj, out)
        return bytes(out)

    def pack_array_header(self, n: int) -> bytes:
        return _len_head(n, 0x90, 15, None, 0xDC, 0xDD)

    def pack_map_header(self, n: int) -> bytes:
        return _len_head(n, 0x80, 15, None, 0xDE, 0xDF)

    def _pack(self, obj, out: bytearray) -> None:
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif isinstance(obj, int):
            out += self._int(int(obj))
        elif isinstance(obj, float):
            if self.use_single_float:
                out.append(0xCA)
                try:
                    out += _f.pack(obj)
                except OverflowError:  # past float32's range: +-inf, as C
                    out += _f.pack(math.copysign(math.inf, obj))
            else:
                out.append(0xCB)
                out += _d.pack(obj)
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            out += _len_head(len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
            out += raw
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = bytes(obj)
            out += _len_head(len(raw), None, 0, 0xC4, 0xC5, 0xC6)
            out += raw
        elif isinstance(obj, ExtType):
            n = len(obj.data)
            fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if n in fixed:
                out.append(fixed[n])
            else:
                out += _len_head(n, None, 0, 0xC7, 0xC8, 0xC9)
            out += _b.pack(obj.code)
            out += obj.data
        elif isinstance(obj, (list, tuple)):
            out += self.pack_array_header(len(obj))
            for v in obj:
                self._pack(v, out)
        elif isinstance(obj, dict):
            out += self.pack_map_header(len(obj))
            for k, v in obj.items():
                self._pack(k, out)
                self._pack(v, out)
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__}")

    @staticmethod
    def _int(v: int) -> bytes:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            return _b.pack(v) if v < 0 else _B.pack(v)
        if v > 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if v <= top:
                    return bytes((code,)) + struct.pack(fmt, v)
        else:
            for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                   (0xD2, ">i", -0x80000000),
                                   (0xD3, ">q", -0x8000000000000000)):
                if v >= low:
                    return bytes((code,)) + struct.pack(fmt, v)
        raise OverflowError(f"integer {v} does not fit 64 bits")


def packb(obj, use_single_float: bool = False) -> bytes:
    return Packer(use_single_float=use_single_float).pack(obj)


class Unpacker:
    """Streaming decoder over a binary file or a bytes object.

    Maps decode to dicts, or to `object_pairs_hook(list_of_pairs)` when
    the hook is given; keys may be of any type.  `tell()` counts the bytes
    consumed so far."""

    CHUNK = 1 << 16

    def __init__(self, source, object_pairs_hook=None):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._buf = bytes(source)
            self._fp = None
        else:
            self._buf = b""
            self._fp = source
        self._pos = 0  # read offset into _buf
        self._base = 0  # stream offset of _buf[0]
        self._hook = object_pairs_hook

    def tell(self) -> int:
        return self._base + self._pos

    def _need(self, n: int) -> None:
        if not self._have(n):
            raise FormatError("unexpected end of MessagePack data")

    def _have(self, n: int) -> bool:
        """Whether n more bytes are available (reading ahead if needed)."""
        if self._pos + n <= len(self._buf):
            return True
        if self._fp is not None:
            self._base += self._pos
            parts = [self._buf[self._pos:]]
            have = len(parts[0])
            while have < n:
                chunk = self._fp.read(max(self.CHUNK, n - have))
                if not chunk:
                    break
                parts.append(chunk)
                have += len(chunk)
            self._buf = b"".join(parts)
            self._pos = 0
        return self._pos + n <= len(self._buf)

    def _take(self, n: int) -> bytes:
        self._need(n)
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def _byte(self) -> int:
        self._need(1)
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def _uint(self, size: int) -> int:
        return int.from_bytes(self._take(size), "big")

    def read_array_header(self) -> int:
        b = self._byte()
        if 0x90 <= b <= 0x9F:
            return b & 0x0F
        if b == 0xDC:
            return self._uint(2)
        if b == 0xDD:
            return self._uint(4)
        raise FormatError(f"expected an array header, got 0x{b:02x}")

    def read_map_header(self) -> int:
        b = self._byte()
        if 0x80 <= b <= 0x8F:
            return b & 0x0F
        if b == 0xDE:
            return self._uint(2)
        if b == 0xDF:
            return self._uint(4)
        raise FormatError(f"expected a map header, got 0x{b:02x}")

    def _array(self, n: int) -> list:
        # fast path: n float32 scalars (0xca + 4 bytes each)
        if n > 8 and self._have(5 * n):
            span = self._buf[self._pos:self._pos + 5 * n]
            if span[::5] == b"\xca" * n:
                raw = np.frombuffer(span, np.uint8).reshape(n, 5)[:, 1:]
                self._pos += 5 * n
                return np.ascontiguousarray(raw).view(">f4").reshape(
                    -1).astype(np.float64).tolist()
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int):
        pairs = [(self.unpack(), self.unpack()) for _ in range(n)]
        if self._hook is not None:
            return self._hook(pairs)
        return dict(pairs)

    def _ext(self, n: int) -> ExtType:
        code = _b.unpack(self._take(1))[0]
        return ExtType(code, self._take(n))

    def unpack(self):
        b = self._byte()
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._uint(1 << (b - 0xC7)))
        if b == 0xCA:
            return _f.unpack(self._take(4))[0]
        if b == 0xCB:
            return _d.unpack(self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            size = 1 << (b - 0xD0)
            return int.from_bytes(self._take(size), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self._array(self._uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise FormatError(f"unknown MessagePack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        try:
            return self._take(n).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise FormatError(f"bad utf-8 string: {exc}") from exc


def unpackb(data: bytes):
    """Decode one object that must span all of `data`."""
    u = Unpacker(data)
    obj = u.unpack()
    if u.tell() != len(data):
        raise FormatError("extra bytes after the MessagePack object")
    return obj
