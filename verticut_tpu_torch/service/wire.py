"""The msgpack subset that the search RPC carries, in plain Python.

The reference's server and client speak msgpack-RPC through the
``msgpack`` package; the port speaks the same bytes without it. Covered:
nil, bool, float64 (float32 too on decode), every int form, str
(fixstr/8/16/32), bin (8/16/32), array and map (fix/16/32). Ext types
raise.

:func:`packb` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``;
:class:`Unpacker` decodes as ``msgpack.Unpacker(raw=False)`` does: str as
``str``, bin as ``bytes``, arrays as lists, maps (whose keys must be str or
bytes) as dicts, and it yields each message once it has been fed whole.
"""

from __future__ import annotations

import struct

#: the most bytes an Unpacker holds (``msgpack.Unpacker``'s default)
MAX_BUFFER_SIZE = 100 * 1024 * 1024

_U8, _U16, _U32, _U64 = (struct.Struct(f">B{c}").pack for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">B{c}").pack for c in "bhiq")
_DOUBLE = struct.Struct(">Bd").pack


class OutOfData(Exception):
    """The buffer ends inside a message."""


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (bin type for ``bytes``)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += _U8(0xCC, v)
        elif v < 1 << 16:
            out += _U16(0xCD, v)
        elif v < 1 << 32:
            out += _U32(0xCE, v)
        elif v < 1 << 64:
            out += _U64(0xCF, v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += _I8(0xD0, v)
    elif v >= -(1 << 15):
        out += _I16(0xD1, v)
    elif v >= -(1 << 31):
        out += _I32(0xD2, v)
    elif v >= -(1 << 63):
        out += _I64(0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, fix, fix_max: int, c8, c16: int,
              c32: int) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n < 1 << 8:
        out += bytes((c8, n))
    elif n < 1 << 16:
        out += _U16(c16, n)
    elif n < 1 << 32:
        out += _U32(c32, n)
    else:
        raise ValueError(f"object of length {n} is too large to pack")


def _pack(obj, out: bytearray) -> None:
    t = type(obj)
    if t is int:
        _pack_int(obj, out)
    elif t is list or t is tuple:
        _pack_len(len(obj), out, 0x90, 16, None, 0xDC, 0xDD)
        for x in obj:      # the RPC's rows: lists of ints
            if type(x) is int:
                _pack_int(x, out)
            else:
                _pack(x, out)
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += _DOUBLE(0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, 0xD9, 0xDA, 0xDB)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), out, 0, 0, 0xC4, 0xC5, 0xC6)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _take(buf, i: int, n: int) -> bytes:
    if i + n > len(buf):
        raise OutOfData
    return bytes(buf[i:i + n])


def _fixed(fmt: str):
    """A decoder of the value in the ``fmt`` bytes after the type byte."""
    st = struct.Struct(fmt)
    size, unpack = st.size, st.unpack_from

    def dec(buf, i, c):
        if i + size > len(buf):
            raise OutOfData
        return unpack(buf, i)[0], i + size
    return dec


def _sized(fmt: str, body):
    """A decoder of a length in ``fmt`` bytes, then ``body(buf, i, n)``."""
    length = _fixed(fmt)

    def dec(buf, i, c):
        n, i = length(buf, i, c)
        return body(buf, i, n)
    return dec


def _raw(buf, i: int, n: int):
    return _take(buf, i, n), i + n


def _text(buf, i: int, n: int):
    return _take(buf, i, n).decode("utf-8"), i + n


def _array(buf, i: int, n: int):
    out = []
    put = out.append
    end = len(buf)
    for _ in range(n):
        if i >= end:
            raise OutOfData
        c = buf[i]
        if c < 0x80:       # the RPC's rows: lists of small ints
            put(c)
            i += 1
        else:
            x, i = _DECODE[c](buf, i + 1, c)
            put(x)
    return out, i


def _map(buf, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key")
        out[k], i = _unpack(buf, i)
    return out, i


def _unsupported(buf, i, c):
    raise ValueError(f"msgpack type 0x{c:02x} is not supported")


# the decoder of each type byte: (buf, index past it, the byte) ->
# (object, index past the object)
_DECODE = [_unsupported] * 256
for _c in range(0x80):
    _DECODE[_c] = lambda buf, i, c: (c, i)
for _c in range(0xE0, 0x100):
    _DECODE[_c] = lambda buf, i, c: (c - 0x100, i)
for _c in range(0x80, 0x90):
    _DECODE[_c] = lambda buf, i, c: _map(buf, i, c & 0x0F)
for _c in range(0x90, 0xA0):
    _DECODE[_c] = lambda buf, i, c: _array(buf, i, c & 0x0F)
for _c in range(0xA0, 0xC0):
    _DECODE[_c] = lambda buf, i, c: _text(buf, i, c & 0x1F)
_DECODE[0xC0] = lambda buf, i, c: (None, i)
_DECODE[0xC2] = lambda buf, i, c: (False, i)
_DECODE[0xC3] = lambda buf, i, c: (True, i)
for _c, _fmt in zip(range(0xCA, 0xD4),
                    ">f >d >B >H >I >Q >b >h >i >q".split()):
    _DECODE[_c] = _fixed(_fmt)      # float32/64, uint8-64, int8-64
for _body, _codes in ((_raw, (0xC4, 0xC5, 0xC6)),
                      (_text, (0xD9, 0xDA, 0xDB)),
                      (_array, (0xDC, 0xDD)), (_map, (0xDE, 0xDF))):
    for _c, _fmt in zip(_codes, (">B", ">H", ">I")[3 - len(_codes):]):
        _DECODE[_c] = _sized(_fmt, _body)
del _c, _fmt, _body, _codes


def _unpack(buf, i: int):
    """The object that starts at ``buf[i]`` and the index past it."""
    if i >= len(buf):
        raise OutOfData
    c = buf[i]
    return _DECODE[c](buf, i + 1, c)


class Unpacker:
    """Streaming decoder: :meth:`feed` bytes as they arrive, then iterate
    to take every message that is complete; a partial one stays buffered
    for the next feed."""

    def __init__(self):
        self._buf = bytearray()
        self._pos = 0

    def feed(self, data) -> None:
        if len(self._buf) - self._pos + len(data) > MAX_BUFFER_SIZE:
            raise ValueError("msgpack buffer is full")
        self._buf += data

    def __iter__(self):
        return self

    def __next__(self):
        try:
            obj, self._pos = _unpack(self._buf, self._pos)
        except OutOfData:
            del self._buf[:self._pos]
            self._pos = 0
            raise StopIteration from None
        return obj
