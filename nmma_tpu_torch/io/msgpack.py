"""A small msgpack decoder for flax-serialized parameter trees.

fiesta saves its networks with ``flax.serialization.to_bytes``: msgpack
maps of strings to maps or arrays, where each array is an extension of
type 1 whose payload is itself msgpack of ``(shape, dtype name, C-order
bytes)`` (flax/serialization.py ``_ndarray_to_bytes``); numpy scalars are
extension type 3 with the same payload, complex numbers type 2 holding
``(real, imag)``, and arrays above 2**30 bytes are split into
``__msgpack_chunked_array__`` maps. ``msgpack_restore`` reads that layout
into nested dicts of numpy arrays without flax or the msgpack package.
Any malformed input, or bytes left over after the one top-level object,
raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, blob: bytes, raw=False):
        self.blob = memoryview(blob)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.blob):
            raise ValueError("truncated msgpack data")
        out = self.blob[self.pos:self.pos + n]
        self.pos += n
        return bytes(out)

    def unpack(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def ext(self, n):
        code = struct.unpack(">b", self.take(1))[0]
        return _ext(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: lambda: self.take(self.unpack("B")),
            0xC5: lambda: self.take(self.unpack("H")),
            0xC6: lambda: self.take(self.unpack("I")),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack("H")),
            0xC9: lambda: self.ext(self.unpack("I")),
            0xCA: lambda: self.unpack("f"),
            0xCB: lambda: self.unpack("d"),
            0xCC: lambda: self.unpack("B"),
            0xCD: lambda: self.unpack("H"),
            0xCE: lambda: self.unpack("I"),
            0xCF: lambda: self.unpack("Q"),
            0xD0: lambda: self.unpack("b"),
            0xD1: lambda: self.unpack("h"),
            0xD2: lambda: self.unpack("i"),
            0xD3: lambda: self.unpack("q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.string(self.unpack("B")),
            0xDA: lambda: self.string(self.unpack("H")),
            0xDB: lambda: self.string(self.unpack("I")),
            0xDC: lambda: [self.value() for _ in range(self.unpack("H"))],
            0xDD: lambda: [self.value() for _ in range(self.unpack("I"))],
            0xDE: lambda: self.mapping(self.unpack("H")),
            0xDF: lambda: self.mapping(self.unpack("I")),
        }
        if b not in sized:
            raise ValueError(f"invalid msgpack type byte 0x{b:02x}")
        return sized[b]()

    def mapping(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, list):
                key = tuple(key)
            out[key] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    if dtype_name == b"bfloat16":
        # the top half of an f32 (numpy has no bfloat16): widen it exactly
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode("ascii"))
                         ).reshape(shape)


def _ext(code, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def unpackb(blob: bytes, raw=False):
    """The one msgpack object in ``blob``: strings as ``str`` (``bytes``
    with ``raw``), flax's extension types as numpy arrays and scalars."""
    reader = _Reader(blob, raw=raw)
    try:
        out = reader.value()
    except (struct.error, UnicodeDecodeError, TypeError) as err:
        raise ValueError(f"malformed msgpack data: {err}") from err
    if reader.pos != len(reader.blob):
        raise ValueError(f"msgpack data has {len(reader.blob) - reader.pos} "
                         "bytes after its object")
    return out


def _unchunk(tree):
    """flax's chunked array leaves joined back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(blob: bytes):
    """``flax.serialization.msgpack_restore`` without flax: the nested dict
    of numpy arrays that ``flax.serialization.to_bytes`` wrote."""
    return _unchunk(unpackb(blob))
