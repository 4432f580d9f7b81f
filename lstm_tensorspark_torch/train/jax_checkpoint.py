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
:func:`encode` is the writer: for the same tree it gives the bytes of
``flax.serialization.to_bytes``, byte for byte, so an artifact the port
publishes to a model registry (``serve/registry.py``) carries the sha256
the JAX package would give it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .checkpoint import classified_parse, read_verified

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
#: flax's ``MAX_CHUNK_SIZE``: an array leaf of more bytes is written as a
#: map of flat chunks of at most this many bytes
MAX_CHUNK_SIZE = 2**30


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


class _Writer:
    """msgpack encoding as ``msgpack.packb(use_bin_type=True)`` chooses its
    forms: the smallest int, str and bin sizes, float64, fixext where the
    payload fits one."""

    def __init__(self):
        self.out = bytearray()

    def pack(self, fmt: str, *vals) -> None:
        self.out += struct.pack(">" + fmt, *vals)

    def sized(self, n: int, fix: int | None, fix_max: int, forms) -> None:
        """A header for ``n`` items or bytes: the fix form below
        ``fix_max``, else the first (code, struct format, limit) that
        holds ``n``."""
        if fix is not None and n < fix_max:
            self.pack("B", fix | n)
            return
        for code, fmt, limit in forms:
            if n < limit:
                self.pack("B" + fmt, code, n)
                return
        raise ValueError(f"msgpack: {n} is too large")

    def value(self, x) -> None:
        if x is None:
            self.pack("B", 0xC0)
        elif x is True or x is False:
            self.pack("B", 0xC3 if x else 0xC2)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            self.ext(_EXT_NDARRAY, _array_bytes(x))
        elif isinstance(x, np.generic):
            self.ext(_EXT_NPSCALAR, _array_bytes(np.asarray(x)))
        elif type(x) is int:
            self.int(x)
        elif type(x) is float:
            self.pack("Bd", 0xCB, x)
        elif type(x) is str:
            b = x.encode("utf-8")
            self.sized(len(b), 0xA0, 32, ((0xD9, "B", 2**8), (0xDA, "H", 2**16),
                                          (0xDB, "I", 2**32)))
            self.out += b
        elif type(x) is bytes:
            self.sized(len(x), None, 0, ((0xC4, "B", 2**8), (0xC5, "H", 2**16),
                                         (0xC6, "I", 2**32)))
            self.out += x
        elif type(x) in (list, tuple):
            self.sized(len(x), 0x90, 16, ((0xDC, "H", 2**16),
                                          (0xDD, "I", 2**32)))
            for v in x:
                self.value(v)
        elif type(x) is dict:
            self.sized(len(x), 0x80, 16, ((0xDE, "H", 2**16),
                                          (0xDF, "I", 2**32)))
            for k, v in x.items():
                self.value(k)
                self.value(v)
        else:
            raise TypeError(f"msgpack: cannot encode {type(x).__name__}")

    def int(self, x: int) -> None:
        if 0 <= x < 0x80 or -0x20 <= x < 0:
            self.pack("b" if x < 0 else "B", x)
            return
        forms = ((0xCC, "B", 0, 0xFF), (0xD0, "b", -0x80, -1),
                 (0xCD, "H", 0, 0xFFFF), (0xD1, "h", -0x8000, -1),
                 (0xCE, "I", 0, 0xFFFFFFFF), (0xD2, "i", -2**31, -1),
                 (0xCF, "Q", 0, 2**64 - 1), (0xD3, "q", -2**63, -1))
        for code, fmt, lo, hi in forms:
            if lo <= x <= hi:
                self.pack("B" + fmt, code, x)
                return
        raise ValueError(f"msgpack: int {x} out of range")

    def ext(self, code: int, payload: bytes) -> None:
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        n = len(payload)
        if n in fixext:
            self.pack("Bb", fixext[n], code)
        else:
            for head, fmt, limit in ((0xC7, "B", 2**8), (0xC8, "H", 2**16),
                                     (0xC9, "I", 2**32)):
                if n < limit:
                    self.pack("B" + fmt + "b", head, n, code)
                    break
        self.out += payload


def _pack(x) -> bytes:
    w = _Writer()
    w.value(x)
    return bytes(w.out)


def _array_bytes(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name,
    C-order bytes). A torch tensor is written as the numpy array it holds;
    a bfloat16 tensor (which numpy lacks) by its raw 16-bit words, named
    ``bfloat16`` as JAX names it."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _pack((tuple(t.shape), "bfloat16",
                          t.view(torch.int16).numpy().tobytes()))
        a = t.numpy()
    if a.dtype.hasobject:
        raise ValueError("msgpack: object arrays cannot be encoded")
    return _pack((a.shape, a.dtype.name, a.tobytes("C")))


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else a.size * a.dtype.itemsize


def _chunk(a) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes, with its shape."""
    flat = a.reshape(-1)
    itemsize = a.element_size() if isinstance(a, torch.Tensor) \
        else a.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(tuple(a.shape))},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _state_dict(tree):
    """flax's ``to_state_dict`` and array chunking over ``tree``: maps keep
    their order with ``str`` keys, named tuples become maps by field,
    lists and tuples maps keyed "0", "1", …; an array leaf above
    :data:`MAX_CHUNK_SIZE` bytes becomes its chunked map."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def encode(tree) -> bytes:
    """``tree`` (maps, lists, tuples, named tuples; numpy arrays, torch
    tensors, numpy and Python scalars, str, bytes, None) as
    ``flax.serialization.to_bytes`` writes it: flax's state dict, then
    msgpack with each array as ext type 1 (a numpy scalar as ext type 3).
    :func:`decode` reads it back."""
    return _pack(_state_dict(tree))


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
