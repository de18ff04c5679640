"""Params files in flax's msgpack format, without flax or msgpack.

A params file is one msgpack map: nested maps with string keys (tuples
and lists become maps keyed ``"0"``, ``"1"``, ...) whose leaves are
arrays in msgpack extension type 1 (the payload is itself msgpack:
``[shape, dtype name, C-order bytes]``), numpy scalars in extension type
3 (the same payload), or plain ints, floats, strings, bools and nil.
``to_bytes`` writes the bytes flax's ``serialization.to_bytes`` writes
for the same tree, and ``from_bytes`` reads every file either wrote.
"""

from __future__ import annotations

import struct as _struct
from typing import Any

import ml_dtypes
import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# -- msgpack encoder (the subset above, smallest encodings first) -------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                             (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < hi:
                out.append(tag)
                out += _struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")
    else:
        for tag, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                             (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= lo:
                out.append(tag)
                out += _struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, tags, out) -> None:
    """Header of a str/bin/array/map/ext of length ``n``: the fix form
    when there is one and it fits, else the 8/16/32-bit length form."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, hi in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < hi:
            out.append(tag)
            out += _struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} too large for msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += _struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif hasattr(obj, "__array__"):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- msgpack decoder -----------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack_from(self, fmt: str):
        return _struct.unpack(fmt, self.take(_struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack_from(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def value(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map_(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str_(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if tag in fixed:
            return self.unpack_from(fixed[tag])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
                   0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if tag in lengths:
            n = self.unpack_from(lengths[tag])
            if tag <= 0xC6:
                return self.take(n)
            if tag <= 0xC9:
                return self.ext(n)
            if tag <= 0xDB:
                return self.str_(n)
            if tag <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map_(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack value")
    return value


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    name = dtype_name.decode()
    dtype = np.dtype(ml_dtypes.bfloat16 if name == "bfloat16" else name)
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


# -- state dicts ---------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(tree: Any) -> Any:
    """Nested dicts with string keys; tuples/lists keyed by position."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if hasattr(tree, "__array__") and not isinstance(tree, np.generic):
        return np.asarray(tree)
    return tree


def from_state_dict(target: Any, state: Any) -> Any:
    """Rebuild ``target``'s structure from ``state`` (as read from a file);
    leaves come from ``state``."""
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"saved params lack keys {sorted(missing)}")
        return {k: from_state_dict(v, state[str(k)]) for k, v in target.items()}
    if _is_namedtuple(target):
        return type(target)(
            *(from_state_dict(getattr(target, k), state[k])
              for k in target._fields)
        )
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                f"saved sequence has {len(state)} items, expected {len(target)}"
            )
        items = [from_state_dict(v, state[str(i)]) for i, v in enumerate(target)]
        return type(target)(items)
    return state


def to_bytes(tree: Any) -> bytes:
    return packb(to_state_dict(tree))


def msgpack_restore(data: bytes) -> Any:
    """The raw state dict of a params file."""
    return unpackb(data)


def from_bytes(target: Any, data: bytes) -> Any:
    return from_state_dict(target, msgpack_restore(data))
