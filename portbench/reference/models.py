"""Plain float32 references of the two models the pipeline serves: the CTC
line recognizer and the DB text-line detector, written from the flax
parameter trees in the shipped weight files, with the msgpack reader copied
from ``synapta_tpu_torch/models/msgpack_io.py``.

Each model runs in float32 (TF32 off) with no rounding step of the
program's bfloat16 path. ``fp8=True`` makes the comparison's control, a
precision below the program's bfloat16: every conv and dense layer reads
its input rounded to float8 e4m3 (scaled per tensor so that its largest
magnitude maps to 448) and its kernel rounded alike with a scale per output
channel.
"""
from __future__ import annotations

import math
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS_DIR = os.path.join(REPO, "synapta_tpu", "models", "weights")
RECOGNIZER_WEIGHTS = os.path.join(WEIGHTS_DIR, "recognizer.msgpack")
DETECTOR_WEIGHTS = os.path.join(WEIGHTS_DIR, "detector.msgpack")

# ------------------------------------------------------------ msgpack

_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {
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
        out = self.b[self.i: self.i + n]
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
            return [self.value() for _ in range(t & 0x0F)]
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
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(self.unpack(">b"), n)

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = read_tree_bytes(payload)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == 3 else arr


def read_tree_bytes(data: bytes):
    r = _Reader(data)
    out = r.value()
    if r.i != len(r.b):
        raise ValueError("trailing bytes after msgpack value")
    return out


def read_tree(path: str):
    """A flax msgpack checkpoint as a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return read_tree_bytes(f.read())


# ------------------------------------------------------------ layers


def _round(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to float8 e4m3 and back, one scale over ``dims`` (None:
    the whole tensor)."""
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims, keepdim=True)
    a = torch.clamp(a, min=1e-12)
    s = a / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _same_pad(n: int, stride: int, k: int):
    """(low, high) padding of flax's 'SAME' along an axis of length n."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class _Net:
    def __init__(self, device, fp8):
        self.device = torch.device(device)
        self.fp8 = fp8
        self._memo = {}

    def t(self, a, perm=None) -> torch.Tensor:
        """A parameter leaf as a float32 tensor on the device (once)."""
        key = (id(a), perm)
        if key not in self._memo:
            arr = np.array(a, np.float32)
            if perm is not None:
                arr = np.transpose(arr, perm)
            self._memo[key] = (a, torch.from_numpy(
                np.ascontiguousarray(arr)).to(self.device))
        return self._memo[key][1]

    def conv(self, x, w_hwio, bias=None, stride=1):
        """flax Conv with 'SAME' padding: x (B, C, H, W), kernel HWIO."""
        w = self.t(w_hwio, (3, 2, 0, 1))
        kh, kw = w.shape[2:]
        ph = _same_pad(x.shape[2], stride, kh)
        pw = _same_pad(x.shape[3], stride, kw)
        if self.fp8:
            x, w = _round(x, None), _round(w, (1, 2, 3))
        b = None if bias is None else self.t(bias)
        return F.conv2d(F.pad(x, (*pw, *ph)), w, b, stride)

    def dense(self, x, w_io, bias):
        """flax Dense; the kernel (in, ...) flattens to (in, out)."""
        w = self.t(w_io).reshape(np.shape(w_io)[0], -1).T  # (out, in)
        if self.fp8:
            x, w = _round(x, None), _round(w, (1,))
        return F.linear(x, w, self.t(bias).reshape(-1))


class RecognizerRef(_Net):
    """(B, 32, W) uint8 line tiles -> (B, W // 4, classes) float32 logits."""

    def __init__(self, tree, device="cpu", fp8=False):
        super().__init__(device, fp8)
        self.p = tree
        self.strides = [(1, 1), (2, 2), (2, 2), (2, 1), (2, 1)]

    def _conv_s(self, x, c, stride):
        w = self.t(c["kernel"], (3, 2, 0, 1))
        ph = _same_pad(x.shape[2], stride[0], 3)
        pw = _same_pad(x.shape[3], stride[1], 3)
        if self.fp8:
            x, w = _round(x, None), _round(w, (1, 2, 3))
        return F.conv2d(F.pad(x, (*pw, *ph)), w, self.t(c["bias"]), stride)

    def _ln(self, x, ln):
        d = x.shape[-1]
        return F.layer_norm(x, (d,), self.t(ln["scale"]), self.t(ln["bias"]),
                            eps=1e-6)

    def _block(self, s, blk):
        att = blk["MultiHeadDotProductAttention_0"]
        B, T, D = s.shape
        heads = np.shape(att["query"]["kernel"])[1]
        hd = D // heads
        h = self._ln(s, blk["LayerNorm_0"])

        def proj(name):  # (B, T, D) -> (B, heads, T, hd)
            y = self.dense(h, att[name]["kernel"], att[name]["bias"])
            return y.view(B, T, heads, hd).transpose(1, 2)

        q, k, v = proj("query"), proj("key"), proj("value")
        w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
        a = (w @ v).transpose(1, 2).reshape(B, T, D)
        x = s + self._out(a, att["out"])
        m = self.dense(self._ln(x, blk["LayerNorm_1"]),
                       blk["Dense_0"]["kernel"], blk["Dense_0"]["bias"])
        m = 0.5 * m * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (m + 0.044715 * m ** 3)))
        return x + self.dense(m, blk["Dense_1"]["kernel"], blk["Dense_1"]["bias"])

    def _out(self, a, out):
        """The attention's out projection: kernel (heads, hd, D)."""
        w = self.t(out["kernel"]).reshape(-1, a.shape[-1]).T
        if self.fp8:
            a, w = _round(a, None), _round(w, (1,))
        return F.linear(a, w, self.t(out["bias"]))

    @torch.inference_mode()
    def __call__(self, tiles_u8) -> torch.Tensor:
        p = self.p
        x = torch.as_tensor(np.asarray(tiles_u8)).to(self.device)
        x = x.to(torch.float32)[:, None] / 255.0
        for i, st in enumerate(self.strides):
            x = F.relu(self._conv_s(x, p[f"Conv_{i}"], st))
        s = x.mean(dim=2).transpose(1, 2) + self.t(p["pos_embed"])
        j = 0
        while f"EncoderBlock_{j}" in p:
            s = self._block(s, p[f"EncoderBlock_{j}"])
            j += 1
        h = self._ln(s, p["LayerNorm_0"])
        return self.dense(h, p["Dense_0"]["kernel"], p["Dense_0"]["bias"])


class DetectorRef(_Net):
    """(B, S, S) uint8 views -> (B, S/2, S/2) float32 probability logits of
    the DB head (channel 0)."""

    # (stride) of ConvBlock_0..7, the backbone; 8-10 have stride 1
    STRIDES = (2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1)

    def __init__(self, tree, device="cpu", fp8=False):
        super().__init__(device, fp8)
        self.p = tree

    def _block(self, x, i):
        blk = self.p[f"ConvBlock_{i}"]
        c = self.conv(x, blk["Conv_0"]["kernel"], None, self.STRIDES[i])
        gn = blk["GroupNorm_0"]
        y = F.group_norm(c, min(8, c.shape[1]), self.t(gn["scale"]),
                         self.t(gn["bias"]), eps=1e-6)
        return F.relu(y)

    def _lat(self, x, i):
        return self.conv(x, self.p[f"Conv_{i}"]["kernel"])

    @staticmethod
    def _up(t, like):
        return F.interpolate(t, size=like.shape[2:], mode="bilinear",
                             align_corners=False)

    @torch.inference_mode()
    def __call__(self, views_u8) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(views_u8)).to(self.device)
        x = x.to(torch.float32)[:, None] / 255.0
        b = self._block
        c1 = b(b(x, 0), 1)
        c2 = b(b(c1, 2), 3)
        c3 = b(b(c2, 4), 5)
        c4 = b(b(c3, 6), 7)
        p3 = self._lat(c3, 0) + self._up(self._lat(c4, 1), c3)
        p2 = self._lat(c2, 2) + self._up(b(p3, 8), c2)
        p1 = self._lat(c1, 3) + self._up(b(p2, 9), c1)
        h = b(p1, 10)
        head = self.p["Conv_4"]
        return self.conv(h, head["kernel"], head["bias"])[:, 0]
