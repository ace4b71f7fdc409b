"""Checkpoint files in the JAX package's format, without msgpack or flax
(counterpart of ``bbdm_tpu/checkpoints/io.py``).

A ``.ckpt`` is what ``flax.serialization.msgpack_serialize`` writes: a msgpack
map whose array leaves are ext type 1 (the msgpack of ``(shape, dtype name,
C-order bytes)``), numpy scalars ext type 3 (the same payload, 0-d), and arrays
over 2^30 bytes split into ``{'__msgpack_chunked_array__': True, 'shape': {...},
'chunks': {...}}`` maps. This module reads and writes that subset of msgpack:
maps, arrays, str, bin, int, float, bool and nil in all their widths, and the
two ext types. Reading maps each array onto one buffer of the whole file with
``np.frombuffer`` (no copy per leaf); bfloat16 arrays are widened to float32
(numpy has no bfloat16). Writes are atomic (tmp + rename).

Content of a model checkpoint (``bbdm_tpu/checkpoints/io.py:1-15``):
``{'model': params, 'ema': params, 'step': int, 'epoch': int[, latent
stats NHWC [1,1,1,C]]}`` with params the JAX parameter tree (see
``checkpoints/from_jax.py``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

_CHUNK_BYTES = 2 ** 30  # flax MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class CheckpointFormatError(ValueError):
    """Bytes outside the msgpack subset flax writes."""


# ------------------------------------------------------------------ reading

class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointFormatError(f"truncated at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

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
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.take(1)[0], n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8/16/32/64
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.take(1)[0]
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise CheckpointFormatError(f"msgpack type byte 0x{b:02x} at byte {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise CheckpointFormatError(f"msgpack ext type {code} at byte {self.pos}")
        inner = self.value()
        if self.pos != end or not (isinstance(inner, list) and len(inner) == 3):
            raise CheckpointFormatError(f"malformed ndarray ext ending at byte {end}")
        shape, dtype, data = inner
        if dtype == "bfloat16":  # widen: the top 16 bits of a float32
            raw = np.frombuffer(data, np.uint16)
            arr = (raw.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(data, np.dtype(dtype))
        arr = arr.reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__") is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> dict:
    """flax ``msgpack_restore`` without flax: bytes -> tree of dicts, numpy
    arrays (read-only views of ``data``) and Python scalars."""
    reader = _Reader(memoryview(data))
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise CheckpointFormatError(f"{len(reader.buf) - reader.pos} trailing bytes")
    return _unchunk(tree)


def load_checkpoint(path: str):
    """Read a ``.ckpt`` written by ``bbdm_tpu.checkpoints.io.save_checkpoint``
    (or :func:`save_checkpoint`)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return msgpack_restore(data)
    except CheckpointFormatError as e:
        raise CheckpointFormatError(f"{path}: {e}") from None


# ------------------------------------------------------------------ writing

def _head(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the narrowest of
    ``wide`` = ((type byte, bytes), ...)."""
    if n < fix_max:
        return bytes([fix | n])
    for code, width in wide:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"msgpack object too long ({n})")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v > 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * width):
                return bytes([code]) + v.to_bytes(width, "big")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                return bytes([code]) + v.to_bytes(width, "big", signed=True)
    raise ValueError(f"integer {v} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _head(len(b), 0xA0, 32, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + b


def _bin_head(n: int) -> bytes:
    return _head(n, 0, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _head(n, 0, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4))) + bytes([code])


def _ndarray_parts(arr: np.ndarray, code: int) -> list:
    """Header bytes + the array's buffer, as flax's ``_ndarray_to_bytes``."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"cannot serialize dtype {arr.dtype}")
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray makes a 0-d array 1-d)
        arr = arr.copy(order="C")
    shape = b"".join(_int(int(d)) for d in arr.shape)
    inner = (bytes([0x93]) + _head(arr.ndim, 0x90, 16, ((0xDC, 2), (0xDD, 4))) + shape
             + _str(arr.dtype.name) + _bin_head(arr.nbytes))
    body = arr.reshape(-1).view(np.uint8) if arr.nbytes else b""
    return [_ext_head(code, len(inner) + arr.nbytes) + inner, body]


def _chunk(arr: np.ndarray) -> dict:
    """flax ``_chunk``: an array over 2^30 bytes as a map of flat chunks."""
    step = max(1, _CHUNK_BYTES // arr.dtype.itemsize)
    flat = np.ascontiguousarray(arr).reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, flat.size, step)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(v, out: list) -> None:
    if isinstance(v, dict):
        out.append(_head(len(v), 0x80, 16, ((0xDE, 2), (0xDF, 4))))
        for key in v:
            if not isinstance(key, str):
                raise TypeError(f"checkpoint keys are str, got {key!r}")
            out.append(_str(key))
            _pack(v[key], out)
    elif isinstance(v, np.ndarray):
        if v.nbytes > _CHUNK_BYTES:
            _pack(_chunk(v), out)
        else:
            out.extend(_ndarray_parts(v, _EXT_NDARRAY))
    elif isinstance(v, np.generic):
        out.extend(_ndarray_parts(np.asarray(v), _EXT_NPSCALAR))
    elif v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif type(v) is int:
        out.append(_int(v))
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        out.append(_str(v))
    elif type(v) is list:
        out.append(_head(len(v), 0x90, 16, ((0xDC, 2), (0xDD, 4))))
        for item in v:
            _pack(item, out)
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} into a checkpoint")


def _sorted(tree):
    """Dicts with sorted keys, as jax.tree_util leaves the JAX package's trees."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def msgpack_serialize(tree) -> list:
    """The msgpack of ``tree`` (dicts with str keys, numpy arrays and scalars,
    Python scalars, lists) as a list of byte buffers to write in order."""
    out: list = []
    _pack(_sorted(tree), out)
    return out


def save_checkpoint(tree, path: str) -> None:
    """Write ``tree`` to ``path`` atomically (tmp + rename), readable by
    ``bbdm_tpu.checkpoints.io.load_checkpoint``."""
    parts = msgpack_serialize(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for part in parts:
            f.write(part)
    os.replace(tmp, path)


def extract_vqgan_tree(tree):
    """The VQGAN parameter tree from a bare tree, a ``{'vqgan': ...}`` tree or a
    VQGAN training checkpoint ``{'model': {'vqgan': ...}}``
    (``bbdm_tpu/checkpoints/io.py:123-132``)."""
    if "vqgan" in tree:
        return tree["vqgan"]
    if "model" in tree and "vqgan" in tree["model"]:
        return tree["model"]["vqgan"]
    return tree
