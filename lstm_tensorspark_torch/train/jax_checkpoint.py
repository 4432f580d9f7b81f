"""Read the JAX package's single-file checkpoints, ``step_<N>.msgpack``.

The JAX package saves a ``TrainState`` with flax's
``serialization.to_bytes``: msgpack of the state's dict (namedtuples and
dataclasses as maps by field name, lists and tuples as maps keyed "0",
"1", ...), each array as msgpack ext type 1 holding the msgpack of
``(shape, dtype name, C-order bytes)``, a numpy scalar as ext type 3 (the
same payload), a complex number as ext type 2, and an array above flax's
chunk limit as a map with ``__msgpack_chunked_array__``. This module
decodes that format in plain Python (the port imports neither flax nor
msgpack), so a model trained on a TPU can be served on the card:
:func:`decode` is the decoder, :func:`params_tree` the ``params`` subtree
with its layers as a list, ready for ``convert.params_from_numpy``, and
:func:`read_params` reads one file, checked against its sha256 sidecar as
the port's own checkpoints are (``train/checkpoint.read_verified``).
"""

from __future__ import annotations

import struct

import numpy as np

from .checkpoint import classified_parse, read_verified

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """msgpack decoding over one buffer (big-endian, as the format is)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} of {len(self.data) - self.pos})")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "ext":
                return self.ext(n)
            return self.array(n) if kind == "array" else self.map(n)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte "
                         f"{self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re_, im = decode(payload)
            return complex(re_, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: msgpack of (shape, dtype name,
    bytes). bfloat16 (which numpy lacks) comes back as float32, exactly."""
    shape, name, buf = decode(payload)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """Chunked array leaves (flax ``_chunk``) back into arrays."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def decode(data: bytes):
    """One msgpack document (the types flax writes) → Python values:
    maps, lists, str, bytes, ints, floats, None, bools, numpy arrays and
    scalars. Raises ``ValueError`` on a truncated or unknown input, or on
    bytes left over."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the "
                         "document")
    return out


def params_tree(state: dict) -> dict:
    """The ``params`` subtree of a decoded ``TrainState`` (chunked arrays
    joined), the layers' map {"0": ..., "1": ...} as a list: what
    ``convert.params_from_numpy`` takes."""
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError("not a JAX TrainState (no params)")
    params = _unchunk(state["params"])
    layers = params["layers"]
    if isinstance(layers, dict):
        params = dict(params, layers=[layers[str(i)]
                                      for i in range(len(layers))])
    return params


def read_params(path: str) -> dict:
    """The params (numpy leaves) of the JAX checkpoint at ``path``: the
    bytes checked against the sidecar (``CorruptCheckpointError`` on a
    mismatch, or when a file without a sidecar does not decode); a
    verified file that does not decode re-raises."""
    data = read_verified(path)
    return classified_parse(path, data, lambda d: params_tree(decode(d)))
