"""A small MessagePack codec: the byte format of the checkpoint files.

The JAX package writes its checkpoints with ``msgpack.packb(...,
use_bin_type=True)``; the port writes and reads the same bytes with this
module, so it needs no msgpack package.  It covers what the checkpoint
format uses: ``None``, ``bool``, ``int`` (64-bit), ``float`` (written as
float64), ``str``, bytes-like (``bin``), lists and tuples (arrays) and
dicts (maps).  Each value takes the shortest encoding, as msgpack's
packer chooses it, so both packages give the same bytes for the same
tree.

:func:`pack_chunks` returns the encoding as a list of chunks in which
every bytes-like value is the caller's own object, not a copy: a
checkpoint of a model-sized array is written straight from its host
buffer.  :func:`unpack` returns ``bin`` values as memoryviews into the
buffer it was given (no copy either).
"""
from __future__ import annotations

import struct
from typing import Any, List

__all__ = ["pack_chunks", "packb", "unpack", "MPackError"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")


class MPackError(ValueError):
    """Bytes that are not (supported) MessagePack."""


def _nbytes(data) -> int:
    return memoryview(data).nbytes


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes((0xA0 | n,)) + raw)
        elif n < 1 << 8:
            out.append(b"\xd9" + _B.pack(n) + raw)
        elif n < 1 << 16:
            out.append(b"\xda" + _H.pack(n) + raw)
        else:
            out.append(b"\xdb" + _I.pack(n) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = _nbytes(obj)
        if n < 1 << 8:
            out.append(b"\xc4" + _B.pack(n))
        elif n < 1 << 16:
            out.append(b"\xc5" + _H.pack(n))
        elif n < 1 << 32:
            out.append(b"\xc6" + _I.pack(n))
        else:
            raise MPackError(f"bin of {n} bytes exceeds MessagePack's 4 GiB")
        if n:
            out.append(obj)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes((0x90 | n,)))
        elif n < 1 << 16:
            out.append(b"\xdc" + _H.pack(n))
        else:
            out.append(b"\xdd" + _I.pack(n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes((0x80 | n,)))
        elif n < 1 << 16:
            out.append(b"\xde" + _H.pack(n))
        else:
            out.append(b"\xdf" + _I.pack(n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} as "
                        "MessagePack")


def _pack_int(v: int, out: List) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(bytes((v,)))
        elif v < 1 << 8:
            out.append(b"\xcc" + _B.pack(v))
        elif v < 1 << 16:
            out.append(b"\xcd" + _H.pack(v))
        elif v < 1 << 32:
            out.append(b"\xce" + _I.pack(v))
        elif v < 1 << 64:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError(f"int {v} exceeds 64 bits")
    elif v >= -32:
        out.append(_b.pack(v))
    elif v >= -(1 << 7):
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -(1 << 15):
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -(1 << 31):
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -(1 << 63):
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError(f"int {v} exceeds 64 bits")


def pack_chunks(obj: Any) -> List:
    """The encoding of ``obj`` as a list of bytes-like chunks (bin values
    are the caller's objects, uncopied)."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    """The encoding of ``obj`` as one ``bytes``."""
    return b"".join(bytes(c) if isinstance(c, memoryview) else c
                    for c in pack_chunks(obj))


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MPackError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]


def _read(r: _Reader) -> Any:
    t = r.unpack(_B)
    if t < 0x80:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _read_map(r, t & 0x0F)
    if 0x90 <= t <= 0x9F:
        return _read_array(r, t & 0x0F)
    if 0xA0 <= t <= 0xBF:
        return str(r.take(t & 0x1F), "utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if t in simple:
        return simple[t]
    if t in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: _B, 0xC5: _H, 0xC6: _I}[t])
        return r.take(n)
    if t == 0xCA:
        return r.unpack(_f)
    if t == 0xCB:
        return r.unpack(_d)
    ints = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
            0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
    if t in ints:
        return r.unpack(ints[t])
    if t in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: _B, 0xDA: _H, 0xDB: _I}[t])
        return str(r.take(n), "utf-8")
    if t in (0xDC, 0xDD):
        return _read_array(r, r.unpack(_H if t == 0xDC else _I))
    if t in (0xDE, 0xDF):
        return _read_map(r, r.unpack(_H if t == 0xDE else _I))
    raise MPackError(f"unsupported MessagePack type byte 0x{t:02x}")


def _read_array(r: _Reader, n: int) -> list:
    return [_read(r) for _ in range(n)]


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if isinstance(k, memoryview):
            k = bytes(k)
        out[k] = _read(r)
    return out


def unpack(buf) -> Any:
    """Decode one MessagePack value that fills ``buf`` (bytes-like);
    ``bin`` values come back as memoryviews into ``buf``."""
    r = _Reader(memoryview(buf).cast("B"))
    obj = _read(r)
    if r.pos != len(r.buf):
        raise MPackError(f"{len(r.buf) - r.pos} bytes of trailing data")
    return obj
