"""The subset of msgpack that flax's ``serialization.to_bytes`` writes for
a tree of numpy arrays, so the port reads and writes the JAX package's
``.ckpt`` files without the ``msgpack`` package.

Covered: maps, str, bin, ext, non-negative ints, arrays and nil, each value
in its smallest encoding as the ``msgpack`` package writes it. An ndarray
is flax's ext type 1 holding ``packb((shape, dtype name, C-order bytes))``;
map keys are written sorted at every level (the order ``jax.tree.map``
gives flax), except in an :class:`OrderedMap`, which keeps its insertion
order (the order flax writes a plain dict in, as the top level of the JAX
package's ``.trainstate`` payload). Anything else raises ``ValueError``,
including an array above
flax's 2^30-byte chunk limit (flax writes such an array as a chunked
sub-map, which this subset does not write).
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

NDARRAY_EXT = 1
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


class OrderedMap(dict):
    """A map that :func:`packb` writes in its insertion order, not sorted."""


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative integer {n} (only non-negative ints are written)")
    if n < 0x80:
        return bytes([n])
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                           (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit in 64 bits")


def _head(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """The header of a str, bin, array or map of length ``n``: its fix form
    when there is one and ``n`` fits, else the 8-, 16- or 32-bit form."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} is too long for msgpack")


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _head(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        raise ValueError("booleans are not in this msgpack subset")
    elif isinstance(obj, int):
        out.append(_uint(obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out += [_head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)), raw]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        out += [_head(len(raw), None, 0, (0xC4, 0xC5, 0xC6)), raw]
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in obj if isinstance(obj, OrderedMap) else sorted(obj):
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.names is not None:
            raise ValueError(f"an array of dtype {obj.dtype} (object and structured dtypes "
                             f"are not serialised)")
        if obj.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"an array of {obj.nbytes} bytes is above flax's 2^30-byte chunk "
                             f"limit, which this subset does not write")
        arr = obj if obj.flags.c_contiguous else obj.copy(order="C")  # keeps 0-d shapes
        body: List[bytes] = []
        _pack((tuple(int(d) for d in arr.shape), arr.dtype.name,
               memoryview(arr.reshape(-1)).cast("B")), body)
        out.append(_ext_head(NDARRAY_EXT, sum(len(p) for p in body)))
        out += body  # the array's bytes, copied once by packb's join
    else:
        raise ValueError(f"a {type(obj).__name__} is not in this msgpack subset")


def packb(obj: Any) -> bytes:
    """``obj`` (nested dicts with str keys, lists or tuples, str, bytes,
    non-negative ints, None and ndarrays) as msgpack bytes, every array's
    bytes copied once into the result."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Unpacker:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        sizes = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if b in sizes:
            return self.num(sizes[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                0xDF: ">I"}
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num(lens[b])))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.num(lens[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(lens[b]))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(lens[b]))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed or b in (0xC7, 0xC8, 0xC9):
            n = fixed[b] if b in fixed else self.num(lens[b])
            code = self.take(1)[0]
            return self.ext(code, self.take(n))
        raise ValueError(f"msgpack type byte {b:#04x} is not in this subset")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.value()
        return out

    def ext(self, code: int, data: memoryview) -> np.ndarray:
        if code != NDARRAY_EXT:
            raise ValueError(f"ext type {code} (only flax's ndarray, type 1, is read)")
        inner = _Unpacker(data)
        spec = inner.value()
        if inner.pos != len(data) or not (isinstance(spec, list) and len(spec) == 3):
            raise ValueError("a malformed ndarray ext")
        shape, dtype, raw = spec
        try:
            dt = np.dtype(dtype)
        except TypeError as e:
            raise ValueError(f"ndarray dtype {dtype!r} is not a numpy dtype") from e
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The value that ``data`` (one msgpack object of this subset) holds;
    ndarray exts come back as writable numpy arrays."""
    u = _Unpacker(data)
    out = u.value()
    if u.pos != len(u.buf):
        raise ValueError(f"{len(u.buf) - u.pos} bytes after the msgpack object")
    return out
