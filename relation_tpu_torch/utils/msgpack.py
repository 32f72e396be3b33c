"""The subset of MessagePack that ``flax.serialization`` writes, in pure
Python, so that the port reads and writes the JAX package's checkpoints
without flax and without the ``msgpack`` package.

Objects: maps (str keys), str, bin, int, float (always 64-bit), bool, nil,
arrays, and flax's ext types:
  1  an ndarray: the packb of ``(shape, dtype name, C-order bytes)``;
     ``bfloat16`` travels as its 16-bit pattern and decodes to a
     ``torch.bfloat16`` tensor (numpy has no such dtype);
  2  a complex: the packb of ``(real, imag)``;
  3  a numpy scalar: ext 1 of its 0-d array.
Encoding a torch tensor writes ext 1 of its CPU values. Like
``flax.serialization.msgpack_serialize``, leaves of a map larger than
``MAX_CHUNK_SIZE`` bytes are written as
``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``,
and ``unpackb`` joins such chunks again. Maps are written with their keys
sorted, as flax writes them.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30                    # flax/serialization.py's limit
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# --------------------------------------------------------------------------
# the pure-Python packer (msgpack-python's choices of the shortest form)
# --------------------------------------------------------------------------

def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError(f"integer {x} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below fix_max, else 8/16/32-bit."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, lim in codes:
        if code is not None and n <= lim:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_bin(b, out: list) -> None:
    _pack_len(len(b), None, 0, ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF),
                                (0xC6, "I", 0xFFFFFFFF)), out)
    out.append(bytes(b))


def _pack_str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 0x1F, ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF),
                                   (0xDB, "I", 0xFFFFFFFF)), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack("B", fixext[n]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    else:
        out.append(struct.pack(">BI", 0xC9, n))
    out.append(struct.pack("b", code))
    out.append(data)


def _array_payload(x) -> bytes:
    """The packb of (shape, dtype name, C bytes) of an ndarray or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name = tuple(x.shape), "bfloat16"
            raw = x.view(torch.int16).numpy().tobytes("C")
        else:
            x = x.numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialisable")
        shape, name, raw = x.shape, x.dtype.name, x.tobytes("C")
    out: list = []
    _pack(([int(d) for d in shape], name, raw), out)
    return b"".join(out)


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, complex):
        inner: list = []
        _pack([x.real, x.imag], inner)
        _pack_ext(EXT_COMPLEX, b"".join(inner), out)
    elif isinstance(x, str):
        _pack_str(x, out)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bin(x, out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 0x0F, ((None, "", 0), (0xDE, "H", 0xFFFF),
                                       (0xDF, "I", 0xFFFFFFFF)), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 0x0F, ((None, "", 0), (0xDC, "H", 0xFFFF),
                                       (0xDD, "I", 0xFFFFFFFF)), out)
        for v in x:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


# --------------------------------------------------------------------------
# the pure-Python unpacker
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        a = self.pos
        self.pos = a + n
        if self.pos > len(self.mv):
            raise ValueError("msgpack data ends early")
        return self.mv[a:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            v = self.unpack(ints[c])
            return float(v) if c in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            n = fixext[c]
        elif c in lens:
            n = self.unpack(lens[c])
        else:
            raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(n)
        code = self.unpack("b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _array_from_payload(payload) -> np.ndarray | torch.Tensor:
    shape, name, buf = _Reader(payload).obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    if code == EXT_COMPLEX:
        re, im = _Reader(data).obj()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


# --------------------------------------------------------------------------
# flax's chunked arrays
# --------------------------------------------------------------------------

def _itemsize(x) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def _nbytes(x) -> int:
    n = x.numel() if isinstance(x, torch.Tensor) else x.size
    return n * _itemsize(x)


def _chunk(x) -> dict:
    flat = x.reshape(-1)
    step = max(1, int(MAX_CHUNK_SIZE / _itemsize(x)))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree):
    """A copy of the maps of ``tree``, keys sorted (flax's tree_map sorts
    them), with oversized array leaves chunked (flax descends maps only,
    and so does this)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk_leaves(v)
    return tree


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def packb(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for
    ``tree`` (maps, lists, scalars, ndarray, numpy-scalar and tensor
    leaves)."""
    out: list = []
    _pack(_chunk_leaves(tree), out)
    return b"".join(out)


def unpackb(data):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``
    (ndarray leaves read-only over ``data``'s memory; chunked arrays
    joined)."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the msgpack object")
    return _unchunk_leaves(tree)
