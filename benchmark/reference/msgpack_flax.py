"""Flax msgpack checkpoints as nested dicts of numpy arrays, for the
reference: a frozen copy of the decoder in ``tti_torch/model/checkpoint.py``
(``_Reader``, ``_unchunk``, ``load_flax_msgpack``) at commit bb8100e, so
that the reference reads the raw checkpoint file without the program."""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

Tree = dict[str, Any]


_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder state over one msgpack byte string (big-endian wire format)."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(">" + fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code -> (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack("b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = _Reader(payload).obj()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":  # upper half of an f32 bit pattern
            raw = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = raw.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype_name)).copy()
        return arr.reshape(tuple(shape))


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked-array leaves (written for very large arrays)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][k] for k in sorted(tree["shape"], key=int))
        chunks = [tree["chunks"][k] for k in sorted(tree["chunks"], key=int)]
        return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_msgpack(path: str) -> Tree:
    """Decode a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


