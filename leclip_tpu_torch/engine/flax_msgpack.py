"""The msgpack subset that flax's ``msgpack_serialize`` writes, on tensors.

The JAX package's checkpoints (``model.ckpt-{e}``, engine/checkpoint.py) are
``flax.serialization.msgpack_serialize`` of a nested dict: maps with string
keys, strings, ints, floats (float64), and arrays as msgpack ext records of
type 1 (an ndarray: the msgpack array ``[shape, dtype name, raw C-order
bytes]``). :func:`packb` writes that subset with the same (smallest)
encodings msgpack-python chooses, and :func:`unpackb` reads it back, arrays
as CPU tensors; anything else raises. Maps are written with their keys sorted, as flax's writer
(through ``jax.tree_util``) orders them, so the same tree gives the same
bytes in both packages. Arrays above flax's 2**30-byte chunk size are not handled
(a prompt checkpoint holds kilobytes)."""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# --------------------------------- writing -----------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack")


def _sized(n: int, small, codes) -> bytes:
    """Header of a str / bin / array / map of ``n`` items: ``small`` is
    (fix code, fix limit) or None; ``codes`` the 8/16/32-bit length codes."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack item of length {n}")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), None, (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _sized(len(data), None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + data


def _array_bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        name = _DTYPE_NAMES[t.dtype]
        shape = list(t.shape)
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    else:
        a = np.ascontiguousarray(t)
        name, shape, raw = a.dtype.name, list(a.shape), a.tobytes("C")
    return _pack([shape, name, raw])


def _pack(x) -> bytes:
    if isinstance(x, int) and not isinstance(x, bool):
        return _int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        return _str(x)
    if isinstance(x, (bytes, bytearray)):
        return _bin(bytes(x))
    if isinstance(x, (list, tuple)):
        return _sized(len(x), (0x90, 16), (None, 0xDC, 0xDD)) + b"".join(_pack(v) for v in x)
    if isinstance(x, dict):
        out = [_sized(len(x), (0x80, 16), (None, 0xDE, 0xDF))]
        for k in sorted(x):  # flax writes through jax.tree_util, which sorts keys
            out += [_pack(k), _pack(x[k])]
        return b"".join(out)
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return _ext(_EXT_NDARRAY, _array_bytes(x))
    raise TypeError(f"cannot msgpack {type(x).__name__}")


def packb(tree) -> bytes:
    """A nested dict / list of tensors, arrays and Python scalars → bytes, as
    ``flax.serialization.msgpack_serialize`` writes them."""
    return _pack(tree)


# --------------------------------- reading -----------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.unpack("B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        if c not in lengths:
            raise ValueError(f"msgpack code 0x{c:02x} is not in flax's subset")
        n = self.unpack(lengths[c])
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not in flax's subset")
        shape, name, raw = _Reader(data).read()
        name = name.decode() if isinstance(name, bytes) else name
        dtype = _TORCH_DTYPES[name]
        flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else \
            torch.empty(0, dtype=torch.uint8)
        t = flat.view(dtype).reshape(shape).clone()
        return t


def unpackb(data: bytes):
    """Bytes written by flax's ``msgpack_serialize`` (or :func:`packb`) → the
    nested dict, arrays as CPU tensors."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
