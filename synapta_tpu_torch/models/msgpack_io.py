"""A jax-free reader and writer for the flax msgpack weight files.

``flax.serialization.msgpack_restore`` and ``msgpack_serialize`` need jax
and the ``msgpack`` package; the port only needs the subset flax writes for
a parameter tree: maps, arrays, str, bin, nil, bool, ints, floats, and
ExtType code 1 (ndarray: msgpack of ``(shape, dtype name, raw bytes)``) and
code 3 (numpy scalar, same payload). The writer gives the same bytes as
flax's for such a tree.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from synapta_tpu_torch.models.charset import NUM_CLASSES

# The port shares the JAX package's weight files: they are read by file path
# from the repo root (<repo>/synapta_tpu/models/weights/), never imported.
WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "synapta_tpu", "models", "weights", "recognizer.msgpack",
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {  # tag -> (length format, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SCALAR = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise ValueError("truncated msgpack data")
        out = self.b[self.i : self.i + n]
        self.i += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode("utf-8")
        if t in _CONST:
            return _CONST[t]
        if t in _SCALAR:
            return self.unpack(_SCALAR[t])
        if t in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[t])
        if t not in _SIZED:
            raise ValueError(f"unsupported msgpack type 0x{t:02x}")
        fmt, kind = _SIZED[t]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "array":
            return self.array(n)
        if kind == "map":
            return self.map(n)
        return self.ext(self.unpack(">b"), n)

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = msgpack_restore(payload)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 arrays need ml_dtypes; not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore for parameter trees: decode one
    msgpack value spanning the whole buffer (flax chunks only leaves above
    2**30 bytes, which this reader does not reassemble)."""
    r = _Reader(data)
    out = r.value()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after msgpack value")
    return out


def _pack(v, out: list) -> None:
    """Append the msgpack encoding of v (the smallest form msgpack-python
    picks, bin type on) to out."""
    def sized(n, fix, fix_max, tags):
        if n <= fix_max:
            out.append(bytes([fix | n]))
            return
        for tag, fmt in tags:
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack length {n} too large")

    if isinstance(v, dict):
        sized(len(v), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for k in sorted(v):  # flax copies the tree with jax's tree_map,
            _pack(k, out)    # which rebuilds every dict in sorted key order
            _pack(v[k], out)
    elif isinstance(v, (list, tuple)):
        sized(len(v), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for x in v:
            _pack(x, out)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        sized(len(b), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out.append(b)
    elif isinstance(v, bytes):
        sized(len(v), 0, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out.append(v)
    elif v is None or isinstance(v, bool):
        out.append(bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[v]]))
    elif isinstance(v, (np.ndarray, np.generic)):  # before float: np.float64
        code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
        arr = np.asarray(v)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not supported")
        if arr.nbytes > 1 << 30:
            raise ValueError("arrays above 2**30 bytes are chunked by flax; "
                             "not supported")
        payload = msgpack_serialize(
            (arr.shape, arr.dtype.name, arr.tobytes("C")))
        n = len(payload)
        if n in _FIXEXT.values():
            out.append(bytes([{m: t for t, m in _FIXEXT.items()}[n]]))
        else:
            sized(n, 0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        out.append(struct.pack(">b", code) + payload)
    elif isinstance(v, int):
        if 0 <= v <= 0x7F or -32 <= v < 0:
            out.append(struct.pack(">b" if v < 0 else ">B", v))
            return
        tags = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
            if v >= 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for tag, fmt in tags:
            try:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
            except struct.error:
                continue
        raise ValueError(f"integer {v} out of msgpack range")
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    else:
        raise TypeError(f"cannot msgpack {type(v).__name__}")


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize for parameter trees: nested
    dicts (written in sorted key order, as flax writes them), lists and tuples, str, bytes, None, bool,
    int, float and numpy arrays and scalars, byte for byte as flax writes
    them."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def write_params(tree, path: str) -> None:
    """Write a parameter tree to ``path`` as flax's ``to_bytes`` does (the
    directory is made if missing)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


def load_params(path: str = WEIGHTS_PATH):
    """Read a recognizer checkpoint as a nested dict of numpy arrays. A
    checkpoint older than the current charset has a narrower CTC head; it is
    padded to NUM_CLASSES with zero kernel columns and a -1e4 bias so the
    new classes never win the argmax (as synapta_tpu/models/train.py does)."""
    with open(path, "rb") as f:
        params = msgpack_restore(f.read())
    head = params.get("Dense_0", {})
    k = head.get("kernel")
    if k is not None and k.shape[-1] < NUM_CLASSES:
        pad = NUM_CLASSES - k.shape[-1]
        head["kernel"] = np.concatenate(
            [np.asarray(k), np.zeros((k.shape[0], pad), k.dtype)], axis=-1
        )
        b = np.asarray(head["bias"])
        head["bias"] = np.concatenate([b, np.full((pad,), -1e4, b.dtype)])
    return params
