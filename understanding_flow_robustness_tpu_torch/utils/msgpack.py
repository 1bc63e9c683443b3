"""The port's MessagePack codec for flax's ``.msgpack`` variables (the
format of ``flax.serialization.to_bytes``, which the JAX package's
``ufr-convert`` and its trainer's weights export write), in pure Python on
``struct`` and numpy: no ``msgpack`` or ``flax`` package is needed.

``packb(tree)`` writes the bytes ``flax.serialization.msgpack_serialize``
writes for the same tree: dict keys in sorted order (flax copies the tree
with ``jax.tree_util.tree_map``, which sorts them), arrays as flax's
``ndarray`` extension (type 1: a msgpack ``(shape, dtype name, C-order
bytes)``), numpy scalars as ``npscalar`` (type 3), Python complex numbers
as ``native_complex`` (type 2), and arrays of more than ``MAX_CHUNK_SIZE``
bytes split into ``__msgpack_chunked_array__`` dicts
(flax/serialization.py:278-393).  ``unpackb(data)`` reads them back as
``msgpack_restore`` does: numpy arrays, but ``bfloat16`` leaves, which
numpy lacks, as ``torch.bfloat16`` tensors taken from the raw bits.

The subset read and written is the one flax emits: nil, bool, every int
width, float32/64, str, bin, array, map and ext (fixext 1-16, ext
8/16/32).  A ``torch.Tensor`` leaf is written as the numpy array of its
values (a bf16 tensor under the name ``bfloat16``).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

# flax/serialization.py:334: arrays above this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _BF16:
    """A bf16 array as the uint16 array of its bits (numpy has no bf16)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape, self.size, self.dtype = bits.shape, bits.size, bits.dtype

    def reshape(self, *shape):
        return _BF16(self.bits.reshape(*shape))

    def __getitem__(self, idx):
        return _BF16(self.bits[idx])


def _as_array(x):
    """A tensor or numpy array leaf as a numpy array (or _BF16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _BF16(x.view(torch.int16).numpy().view(np.uint16))
        return x.numpy()
    return x


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _header(out: list, n: int, fix: int, fix_max: int, tags) -> None:
    """A length header: the fix form up to ``fix_max``, then the 8-, 16-
    and 32-bit forms whose tags ``tags`` names (None where there is
    none)."""
    if n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for tag, fmt, top in zip(tags, (">BB", ">BH", ">BI"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(struct.pack(fmt, tag, n))
            return
    raise ValueError(f"object of length {n} is too large for msgpack")


def _bin(out: list, data) -> None:
    n = len(data)
    for tag, fmt, top in ((0xC4, ">BB", 0xFF), (0xC5, ">BH", 0xFFFF),
                          (0xC6, ">BI", 0xFFFFFFFF)):
        if n <= top:
            out.append(struct.pack(fmt, tag, n))
            out.append(data)
            return
    raise ValueError("bytes object is too large for msgpack")


def _str(out: list, s: str) -> None:
    data = s.encode("utf-8")
    _header(out, len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
    out.append(data)


def _ext_header(out: list, code: int, n: int) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    else:
        _header(out, n, 0, -1, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))


def _ndarray_payload(arr) -> list:
    """The ext payload of an array: msgpack ``(shape, name, bytes)``, as
    pieces (flax ``_ndarray_to_bytes``; the data is not copied here)."""
    if isinstance(arr, _BF16):
        shape, name, data = arr.shape, "bfloat16", arr.bits
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name, data = arr.shape, arr.dtype.name, arr
    data = memoryview(np.ascontiguousarray(data).reshape(-1).view(np.uint8))
    out: list = [b"\x93"]
    _header(out, len(shape), 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in shape:
        _int(out, int(d))
    _str(out, name)
    _bin(out, data)
    return out


def _pack(out: list, x) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _int(out, x)
    elif t is bytes or t is bytearray:
        _bin(out, bytes(x))
    elif t is str:
        _str(out, x)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif t is list:
        _header(out, len(x), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _header(out, len(x), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, _BF16)) or isinstance(x, np.generic):
        code = EXT_NPSCALAR if isinstance(x, np.generic) else EXT_NDARRAY
        pieces = _ndarray_payload(np.asarray(x) if code == EXT_NPSCALAR
                                  else x)
        _ext_header(out, code, sum(len(p) for p in pieces))
        out.extend(pieces)
    elif t is complex:
        payload = b"\x92" + struct.pack(">BdBd", 0xCB, x.real, 0xCB, x.imag)
        _ext_header(out, EXT_COMPLEX, len(payload))
        out.append(payload)
    else:
        # msgpack's strict types (flax packs with strict_types=True): a
        # tuple or a subclass of a packed type is refused
        raise TypeError(f"Cannot serialize {x!r}")


def _sorted(x):
    """The tree with every dict's keys sorted (jax.tree_util.tree_map's
    copy in msgpack_serialize); leaves as numpy arrays."""
    if type(x) is dict:
        return {k: _sorted(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted(v) for v in x]
    return _as_array(x)


def _chunk(arr):
    """flax ``_chunk``: a canonical dict of the array's flat chunks."""
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + chunksize] for j, i in
                       enumerate(range(0, arr.size, chunksize))}}


def _nbytes(x) -> int:
    if isinstance(x, (np.ndarray, _BF16)):
        return x.size * x.dtype.itemsize
    return -1


def _chunk_leaves(d):
    """flax ``_chunk_array_leaves_in_place``: oversized arrays reached
    through dicts (not lists) are chunked."""
    if type(d) is dict:
        for k, v in d.items():
            if _nbytes(v) > MAX_CHUNK_SIZE:
                d[k] = _chunk(v)
            elif type(v) is dict:
                _chunk_leaves(v)
    elif _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out: list = []
    _pack(out, _chunk_leaves(_sorted(tree)))
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, b: int, base: int) -> int:
        """The length of a str/bin/array/map/ext of 8-, 16- or 32-bit
        header ``b``, ``base`` being the 8-bit form's tag."""
        return self.unpack(("B", ">H", ">I")[b - base])

    def obj(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.raw(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.length(b, 0xC4)))
        if 0xC7 <= b <= 0xC9:
            n = self.length(b, 0xC7)
            return self.ext(self.unpack("b"), n)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(self.unpack("b"), _FIXEXT[b])
        if 0xD9 <= b <= 0xDB:
            return self.raw(self.length(b, 0xD9), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unknown msgpack tag 0x{b:02x}")

    def raw(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, code: int, n: int):
        start = self.pos
        self.take(n)
        payload = self.mv[start:start + n]
        if code == EXT_NDARRAY:
            return _ndarray_from(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray_from(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        if code == EXT_COMPLEX:
            re_, im = _Reader(payload).obj()
            return complex(re_, im)
        raise ValueError(f"unknown msgpack extension type {code}")


def _ndarray_from(payload: memoryview):
    """flax ``_ndarray_from_bytes``: a numpy view of the data's bytes
    (writable where the data is a ``bytearray``), or a bf16 tensor (a
    copy) for ``bfloat16``."""
    r = _Reader(payload)
    if r.take(1)[0] != 0x93:
        raise ValueError("ndarray payload is not a (shape, dtype, data) "
                         "triple")
    shape = r.obj(raw=True)
    name = r.obj(raw=True).decode()
    b = r.take(1)[0]
    if not 0xC4 <= b <= 0xC6:
        raise ValueError("ndarray payload without a bin buffer")
    buf = r.take(r.length(b, 0xC4))
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax ``_unchunk_array_leaves_in_place``."""
    if type(d) is dict:
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if type(v) is dict and CHUNKED in v:
                d[k] = _unchunk(v)
            elif type(v) is dict:
                _unchunk_leaves(v)
    return d


def unpackb(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree of dicts,
    lists, Python scalars and arrays; the arrays are views of ``data``'s
    memory, not copies."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.mv):
        raise ValueError("extra bytes after the msgpack object")
    return _unchunk_leaves(out)
