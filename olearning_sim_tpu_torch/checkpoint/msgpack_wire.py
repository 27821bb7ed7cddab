"""flax's msgpack wire format, written out: the model files of both packages.

The JAX package writes a model file with ``flax.serialization.to_bytes``
and reads one with ``from_bytes``; the port writes and reads the same
bytes here, without ``msgpack`` or ``flax``. What is covered is what
those functions emit and read for parameter trees
(``flax/serialization.py``):

- maps with str keys, in the tree's insertion order (a JAX export's tree
  comes out of ``jax.device_get``, whose maps are key-sorted:
  :func:`sorted_tree`);
- str, bin, int, float (float64), bool and nil; lists and tuples as arrays;
- ext type 1, an array: the payload is the msgpack of ``(shape,
  dtype name, C-order bytes)`` with bin for the bytes;
- ext type 3, a numpy scalar, the same payload for a 0-d array;
- arrays over :data:`MAX_CHUNK_SIZE` bytes as flax's chunked form, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat chunk, ...}}``, on write and on read.

Leaves are numpy arrays and scalars, or torch tensors. numpy has no
bfloat16, so a ``bfloat16`` array is written from, and read into, a torch
tensor (``torch.frombuffer``); every other array is read as a read-only
numpy view of the file's bytes, as flax reads it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 - 1 bytes per
# object; flax leaves a margin.
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ------------------------------------------------------------------ encode
# The encoder appends pieces to a list and joins them once: array data goes
# in as a view of the array's memory, so a model file's bytes are copied
# once, not once per nesting level.
def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack("b", n))
    elif 0xFF < n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif -0x8000 <= n < -0x80:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif -0x80000000 <= n < -0x8000:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"int {n} does not fit msgpack")


def _len_header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
    """A length header: a fix form up to ``fix_max``, else 8/16/32-bit
    (``codes`` lists the header bytes for each width; None skips one)."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    if codes[0] is not None and n <= 0xFF:
        return struct.pack(">BB", codes[0], n)
    if n <= 0xFFFF:
        return struct.pack(">BH", codes[1], n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", codes[2], n)
    raise OverflowError(f"length {n} does not fit msgpack")


_BIN = (None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _array_parts(arr) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, a view of the C-order bytes) of a numpy array or
    torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", memoryview(t.view(torch.int16).numpy()).cast("B")
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    data = np.ascontiguousarray(arr)
    view = memoryview(data.reshape(-1).view(np.uint8)) if data.size else memoryview(b"")
    return arr.shape, arr.dtype.name, view


def _pack_array(code: int, arr, out: list) -> None:
    """An ext of type ``code`` whose payload is the msgpack of (shape,
    dtype name, bytes)."""
    shape, name, data = _array_parts(arr)
    head: list = [b"\x93"]
    _pack(tuple(int(d) for d in shape), head)
    _pack(name, head)
    head.append(_len_header(len(data), *_BIN))
    head = b"".join(head)
    out.append(_ext_header(code, len(head) + len(data)))
    out.append(head)
    out.append(data)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(arr) -> Dict[str, Any]:
    """flax's ``_chunk``: a flat array cut into chunks of MAX_CHUNK_SIZE
    bytes, with the shape kept as a map of its dimensions."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + step]
                       for j, i in enumerate(range(0, size, step))}}


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out.append(_len_header(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(data)
    elif type(obj) in (bytes, bytearray, memoryview):
        out.append(_len_header(len(obj), *_BIN))
        out.append(obj)
    elif type(obj) in (list, tuple):
        out.append(_len_header(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        out.append(_len_header(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif _is_array(obj):
        _pack_array(_EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _pack_array(_EXT_NPSCALAR, np.asarray(obj), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: oversized arrays
    that are the root or a map's values become their chunked form."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) if isinstance(v, dict) else
                (_chunk(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE else v)
                for k, v in tree.items()}
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (a tree
    of str-keyed dicts, lists and array or scalar leaves)."""
    out: list = []
    _pack(_chunk_leaves(tree), out)
    return b"".join(out)


def sorted_tree(tree):
    """``tree`` with every map's keys in sorted order, the order a JAX
    param tree has after ``jax.device_get``."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _unpack_array_payload(data: bytes):
    r = _Reader(data)
    shape, name, buf = _read(r, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _unpack_array_payload(data)
    if code == _EXT_NPSCALAR:
        arr = _unpack_array_payload(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader, raw: bool = False):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return _read_list(r, b & 0x0F, raw)
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r.take(n), raw)
    if b in (0xDC, 0xDD):
        return _read_list(r, r.unpack({0xDC: ">H", 0xDD: ">I"}[b]), raw)
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack({0xDE: ">H", 0xDF: ">I"}[b]), raw)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _str(data: memoryview, raw: bool):
    return bytes(data) if raw else bytes(data).decode("utf-8")


def _read_list(r: _Reader, n: int, raw: bool) -> List[Any]:
    return [_read(r, raw) for _ in range(n)]


def _read_map(r: _Reader, n: int, raw: bool) -> Dict[Any, Any]:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk_leaves(tree)


def restore_into(template, state, path: str = ""):
    """``flax.serialization.from_state_dict`` for a tree of dicts: ``state``
    in ``template``'s structure, raising where a key of the template is
    missing, as flax does."""
    if not isinstance(template, dict):
        return state
    if not isinstance(state, dict):
        raise ValueError(f"expected a map at {path or '/'}, found {type(state).__name__}")
    missing = set(map(str, template)) - set(state)
    if missing:
        raise ValueError(
            "The target dict keys and state dict keys do not match, target dict"
            f" contains keys {missing} which are not present in state dict at path"
            f" {path or '/'}")
    return {k: restore_into(v, state[str(k)], f"{path}/{k}") for k, v in template.items()}
