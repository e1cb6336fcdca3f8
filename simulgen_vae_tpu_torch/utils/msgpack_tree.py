"""flax's msgpack checkpoint format, read and written with numpy and the
standard library (the card's machine has neither flax nor msgpack).

The format is ``flax.serialization.to_bytes``: a msgpack map of the state
dict, whose leaves are

* ext type 1, an ndarray: its payload is itself a msgpack array
  ``[shape, dtype name, row-major bytes]`` (native byte order);
* ext type 2, a Python complex: a msgpack array ``[real, imag]``;
* ext type 3, a numpy scalar: packed as a 0-d ndarray;
* maps, str, bin, int, float, nil and bool as msgpack has them.

An array above :data:`MAX_CHUNK_SIZE` bytes is written as a map
``{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...}, 'chunks':
{'0': flat chunk, ...}}`` and read back whole. The writer encodes each value
in the smallest form, as msgpack-python does, so that it gives flax's bytes.

Reading goes through one ``memoryview`` of the file's bytes: an array's data
is an ``np.frombuffer`` view of it (copied only where its offset is not a
multiple of the item size), with no loop over elements. numpy has no
bfloat16: a bfloat16 leaf comes back as its float32 values, which are exact.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30        # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# -- reading -------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.mv):
            raise ValueError("msgpack data ends inside a value")
        return self.mv[start:self.pos]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by this format")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return _unchunk(out) if CHUNKED in out else out

    def ext(self, n: int) -> Any:
        code = self.sint(1)
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not used by this format")


_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.uint(1))),
    0xC5: lambda r: bytes(r.take(r.uint(2))),
    0xC6: lambda r: bytes(r.take(r.uint(4))),
    0xC7: lambda r: r.ext(r.uint(1)),
    0xC8: lambda r: r.ext(r.uint(2)),
    0xC9: lambda r: r.ext(r.uint(4)),
    0xCA: lambda r: struct.unpack(">f", r.take(4))[0],
    0xCB: lambda r: struct.unpack(">d", r.take(8))[0],
    0xCC: lambda r: r.uint(1),
    0xCD: lambda r: r.uint(2),
    0xCE: lambda r: r.uint(4),
    0xCF: lambda r: r.uint(8),
    0xD0: lambda r: r.sint(1),
    0xD1: lambda r: r.sint(2),
    0xD2: lambda r: r.sint(4),
    0xD3: lambda r: r.sint(8),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str(r.uint(1)),
    0xDA: lambda r: r.str(r.uint(2)),
    0xDB: lambda r: r.str(r.uint(4)),
    0xDC: lambda r: [r.value() for _ in range(r.uint(2))],
    0xDD: lambda r: [r.value() for _ in range(r.uint(4))],
    0xDE: lambda r: r.map(r.uint(2)),
    0xDF: lambda r: r.map(r.uint(4)),
}
_BIN_LEN = {0xC4: 1, 0xC5: 2, 0xC6: 4}


def _ndarray(payload: memoryview) -> np.ndarray:
    """An ext-1 payload ``[shape, dtype name, bytes]`` -> an array viewing
    the payload's bytes."""
    r = _Reader(payload)
    if r.uint(1) != 0x93:
        raise ValueError("an ndarray payload is not a 3-element array")
    shape = tuple(r.value())
    name = r.value()
    name = name.decode() if isinstance(name, bytes) else name
    kind = r.uint(1)
    if kind not in _BIN_LEN:
        raise ValueError("an ndarray payload's data is not bin")
    data = r.take(r.uint(_BIN_LEN[kind]))
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    arr = np.frombuffer(data, np.dtype(name)).reshape(shape)
    return arr if arr.flags.aligned else arr.copy()


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def unpackb(buf) -> Any:
    """A flax msgpack buffer (bytes, bytearray or memoryview) -> its tree of
    dicts, lists, Python scalars and numpy arrays."""
    r = _Reader(buf)
    out = r.value()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the msgpack value")
    return out


def load(path: str) -> Any:
    """Read a flax msgpack file. The file is read into one writable buffer,
    so that the arrays viewing it are writable."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        f.seek(0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return unpackb(buf)


# -- writing -------------------------------------------------------------------

def _uint_header(n: int, forms) -> bytes:
    for limit, prefix, fmt in forms:
        if n <= limit:
            return prefix + (struct.pack(fmt, n) if fmt else b"")
    raise ValueError(f"length {n} is too large for msgpack")


def _len_header(n: int, fix: int, fix_max: int, b8, b16, b32) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    forms = ([(0xFF, bytes([b8]), ">B")] if b8 is not None else []) + [
        (0xFFFF, bytes([b16]), ">H"), (0xFFFFFFFF, bytes([b32]), ">I")]
    return _uint_header(n, forms)


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        forms = [(0xFF, b"\xcc", ">B"), (0xFFFF, b"\xcd", ">H"),
                 (0xFFFFFFFF, b"\xce", ">I"), (2 ** 64 - 1, b"\xcf", ">Q")]
        return _uint_header(n, forms)
    for lo, prefix, fmt in ((-2 ** 7, b"\xd0", ">b"), (-2 ** 15, b"\xd1", ">h"),
                            (-2 ** 31, b"\xd2", ">i"), (-2 ** 63, b"\xd3", ">q")):
        if n >= lo:
            return prefix + struct.pack(fmt, n)
    raise ValueError(f"integer {n} is too large for msgpack")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _len_header(len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB) + raw


def _bin_header(n: int) -> bytes:
    return _uint_header(n, [(0xFF, b"\xc4", ">B"), (0xFFFF, b"\xc5", ">H"),
                            (0xFFFFFFFF, b"\xc6", ">I")])


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _uint_header(n, [(0xFF, b"\xc7", ">B"), (0xFFFF, b"\xc8", ">H"),
                                (0xFFFFFFFF, b"\xc9", ">I")])
    return head + struct.pack(">b", code)


def _chunked(arr: np.ndarray) -> dict:
    step = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + step]
                       for i, s in enumerate(range(0, flat.size, step))}}


class _Writer:
    def __init__(self, out: BinaryIO):
        self.write = out.write

    def value(self, x: Any, top: bool = True) -> None:
        w = self.write
        if x is None:
            w(b"\xc0")
        elif x is True or x is False:
            w(b"\xc3" if x else b"\xc2")
        elif isinstance(x, dict):
            w(_len_header(len(x), 0x80, 15, None, 0xDE, 0xDF))
            for k, v in x.items():
                w(_str(str(k)))
                if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_SIZE:
                    v = _chunked(v)
                self.value(v, top=False)
        elif isinstance(x, (list, tuple)):
            w(_len_header(len(x), 0x90, 15, None, 0xDC, 0xDD))
            for v in x:
                self.value(v, top=False)
        elif isinstance(x, np.ndarray):
            if top and x.nbytes > MAX_CHUNK_SIZE:
                return self.value(_chunked(x))
            self.ndarray(EXT_NDARRAY, x)
        elif isinstance(x, np.generic):
            self.ndarray(EXT_NPSCALAR, np.asarray(x))
        elif isinstance(x, int):
            w(_int(x))
        elif isinstance(x, float):
            w(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            w(_str(x))
        elif isinstance(x, (bytes, bytearray)):
            w(_bin_header(len(x)) + bytes(x))
        elif isinstance(x, complex):
            payload = b"\x92" + b"".join(b"\xcb" + struct.pack(">d", v)
                                         for v in (x.real, x.imag))
            w(_ext_header(EXT_COMPLEX, len(payload)) + payload)
        else:
            raise TypeError(f"cannot write a {type(x).__name__} in flax's format")

    def ndarray(self, code: int, arr: np.ndarray) -> None:
        if arr.dtype.hasobject or arr.dtype.names is not None:
            raise ValueError("object and structured dtypes cannot be written")
        data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        head = (b"\x93" + _len_header(arr.ndim, 0x90, 15, None, 0xDC, 0xDD)
                + b"".join(_int(d) for d in arr.shape) + _str(arr.dtype.name)
                + _bin_header(data.size))
        self.write(_ext_header(code, len(head) + data.size) + head)
        self.write(memoryview(data))


def dump(tree: Any, out: BinaryIO) -> None:
    """Write ``tree`` (dicts with str keys, lists, numpy arrays and scalars,
    Python scalars) to a binary file object in flax's msgpack format."""
    _Writer(out).value(tree)


def packb(tree: Any) -> bytes:
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()
