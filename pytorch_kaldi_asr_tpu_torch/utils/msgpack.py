"""A small msgpack codec for the subset that flax checkpoints use.

``flax.serialization.to_bytes`` writes a parameter tree as msgpack: nested
maps with string keys (lists become maps keyed ``"0"``, ``"1"``, ...), and
every array as extension type 1 whose payload is itself msgpack of
``(shape, dtype_name, raw C-order bytes)`` (flax ``_ndarray_to_bytes`` /
``_msgpack_ext_pack``).  Extension type 3 holds a numpy scalar the same way.

The machine that runs the port has neither ``msgpack`` nor ``flax``, so this
module reads and writes that subset itself: nil, bool, ints, float64, str,
bin, arrays and maps, plus the two array extensions.  It packs each value in
the shortest form, as ``msgpack.packb(..., use_bin_type=True)`` does, so a
tree written here is byte-identical to the same tree written by flax.

Arrays decode to CPU ``torch.Tensor``s (``bfloat16`` included, which numpy
lacks) and encode from ``torch.Tensor`` or ``numpy.ndarray``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# arrays <-> (shape, dtype_name, bytes)
# ---------------------------------------------------------------------------


def _array_payload(x):
    """(shape, dtype name, C-order bytes) of a tensor or ndarray."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return list(t.shape), name, raw
    a = np.asarray(x)
    return list(a.shape), a.dtype.name, a.tobytes("C")


def _tensor_from_payload(shape, dtype_name, raw):
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    if dtype_name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported array dtype {dtype_name!r}")
    dtype = _TORCH_DTYPES[dtype_name]
    shape = tuple(int(s) for s in shape)
    if dtype == torch.bfloat16:
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(arr.copy())


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def _pack_int(n, out):
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", n))
    elif 0 <= n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack(">b", n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n, fix_base, fix_max, codes, out):
    """Length header: fix form below ``fix_max``, else the 8/16/32-bit
    code (``codes`` lists them; None where the type has no 8-bit form)."""
    if n < fix_max and fix_base is not None:
        out.append(struct.pack("B", fix_base | n))
    elif n <= 0xFF and codes[0] is not None:
        out.append(codes[0] + struct.pack("B", n))
    elif n <= 0xFFFF:
        out.append(codes[1] + struct.pack(">H", n))
    else:
        out.append(codes[2] + struct.pack(">I", n))


def _pack_ext(code, data, out):
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        out.append(fixed[n] + struct.pack("b", code))
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack("B", n) + struct.pack("b", code))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n) + struct.pack("b", code))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + struct.pack("b", code))
    out.append(data)


def _pack(obj, out):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (b"\xc4", b"\xc5", b"\xc6"), out)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(EXT_NDARRAY, packb(_array_payload(obj)), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, packb(_array_payload(np.asarray(obj))), out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj):
    """Serialize ``obj`` to msgpack bytes."""
    out = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# unpacking
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw_str):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(chunk)

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        raw = self.take(n)
        return raw if self.raw_str else raw.decode("utf-8")

    def ext(self, n):
        code = self.unpack("b")
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype_name, raw = unpackb(data, raw_str=True)
            t = _tensor_from_payload(shape, dtype_name, raw)
            return t if code == EXT_NDARRAY else t.reshape(()).item()
        raise ValueError(f"unsupported msgpack extension type {code}")

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {
            0xC0: lambda: None,
            0xC2: lambda: False,
            0xC3: lambda: True,
            0xC4: lambda: self.take(self.unpack("B")),
            0xC5: lambda: self.take(self.unpack(">H")),
            0xC6: lambda: self.take(self.unpack(">I")),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"),
            0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack("B"),
            0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"),
            0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"),
            0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"),
            0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1),
            0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str_(self.unpack("B")),
            0xDA: lambda: self.str_(self.unpack(">H")),
            0xDB: lambda: self.str_(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map_(self.unpack(">H")),
            0xDF: lambda: self.map_(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map_(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data, raw_str=False):
    """Deserialize msgpack bytes.  ``raw_str`` keeps str values as bytes
    (flax reads the inner array payload that way)."""
    reader = _Reader(data, raw_str)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj
