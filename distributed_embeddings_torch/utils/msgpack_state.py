"""A small msgpack codec for the subset ``flax.serialization`` writes, and
the dense half of a train state as flax's state-dict tree.

The JAX package saves the dense params, the dense optimizer state and
the step counter as ``flax.serialization.to_bytes`` of ``{"dense_params":
..., "dense_opt_state": ..., "step": ...}`` (``dense.msgpack`` in a
checkpoint, ``utils/checkpoint.py``). The port writes and reads the same
bytes without flax or msgpack:

* maps with str keys, arrays, str, bin, int, float (float64), bool and
  nil, as msgpack-python packs them (smallest encodings, str8 and bin
  types);
* ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
  bytes)``; ext 3, a numpy scalar, the same of a 0-d array (decoded
  only: the port writes arrays). ``bfloat16``
  arrays carry their uint16 bits and decode to ``torch.bfloat16``; every
  decoded array is a CPU tensor.

In flax's tree, tuples are ``{"0": ..., "1": ...}``, NamedTuples their
field dicts, optax's ``EmptyState`` ``{}``, and the dense module's
parameters ``{"params": {"Dense_<i>": {"bias": [out], "kernel": [in,
out]}}}`` (:func:`~.convert.flax_dense_tree`).
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .convert import _dense_state, flax_dense_tree, load_flax_dense

EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


# ------------------------------------------------------------------ encode


def _array_payload(a) -> bytes:
    """The ext payload of an array: ``packb((shape, name, bytes))``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"cannot serialize a {t.dtype} tensor")
        name = _TORCH_NAMES[t.dtype]
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               ).numpy().tobytes()
        shape = tuple(t.shape)
    else:
        arr = np.ascontiguousarray(a)
        if arr.dtype.hasobject or arr.dtype.kind == "V":
            raise TypeError(f"cannot serialize a {arr.dtype} array")
        name, raw, shape = arr.dtype.name, arr.tobytes(), arr.shape
    return packb([list(shape), name, raw])


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes([0xc7, n])
    elif n < 1 << 16:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: bytearray) -> None:
    """Header of a str/bin/array/map of length ``n``: the fix form when
    ``fix`` is given, else 8-, 16- or 32-bit lengths."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes([codes[0], n])
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out += struct.pack(">b", obj)
        elif obj >= 0:
            for code, fmt, lim in ((0xcc, ">B", 1 << 8),
                                   (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32),
                                   (0xcf, ">Q", 1 << 64)):
                if obj < lim:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(f"int {obj} too large for msgpack")
        else:
            for code, fmt, lim in ((0xd0, ">b", 1 << 7),
                                   (0xd1, ">h", 1 << 15),
                                   (0xd2, ">i", 1 << 31),
                                   (0xd3, ">q", 1 << 63)):
                if obj >= -lim:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(f"int {obj} too small for msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 31, (0xd9, 0xda, 0xdb), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k)}")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (see the module docstring for the subset:
    numpy arrays and tensors go out as flax's ext 1)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ------------------------------------------------------------------ decode


def _array_from_payload(data: bytes) -> torch.Tensor:
    shape, name, raw = unpackb(data, arrays=False)
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).copy().reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(name)).copy().reshape(shape)
    return torch.from_numpy(arr)


class _Reader:
    def __init__(self, data: bytes, arrays: bool):
        self.data, self.pos, self.arrays = memoryview(data), 0, arrays

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if not self.arrays:
            raise ValueError(f"nested ext type {code}")
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            return _array_from_payload(data).reshape(())
        raise ValueError(f"unsupported msgpack ext type {code}")

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in lens:
            return self.take(self.unpack(lens[b]))
        exts = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"unsupported msgpack type byte {b:#04x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, arrays: bool = True) -> Any:
    """Decode msgpack bytes; ext 1 / ext 3 become CPU tensors."""
    r = _Reader(data, arrays)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    if arrays and isinstance(out, dict) and _has_chunked(out):
        raise ValueError("chunked arrays (flax's form for arrays over "
                         "1 GiB) are not supported")
    return out


def _has_chunked(tree) -> bool:
    if isinstance(tree, dict):
        return "__msgpack_chunked_array__" in tree or any(
            _has_chunked(v) for v in tree.values())
    return False


# ------------------------------------------------------ dense state trees


def dense_state_dict(dense, dense_opt_state, step) -> Dict[str, Any]:
    """flax's state-dict tree of ``{"dense_params", "dense_opt_state",
    "step"}`` from the port's dense module, its optimizer state and the
    0-d int32 step. The port's optimizer state is optax's chain without
    its empty parts, so the parts say which optimizer it was:
    ``optax.sgd`` is ``{"0": {} or {"trace"}, "1": {} or {"count"}}``
    (a :class:`TraceState` for momentum, a :class:`ScheduleState` for a
    schedule), ``optax.adagrad`` ``{"0": {"sum_of_squares"}, "1": {}}``
    (a bare tuple of tensors), ``optax.adam`` ``{"0": {"count", "mu",
    "nu"}, "1": {} or {"count"}}`` (an :class:`AdamState` first)."""
    from ..parallel.optimizers import AdamState, ScheduleState, TraceState

    parts = list(dense_opt_state)
    head: Dict[str, Any] = {}
    if parts and all(isinstance(p, torch.Tensor) for p in parts):
        head = {"sum_of_squares": flax_dense_tree(dense, parts)}  # Adagrad
        parts = []
    elif parts and isinstance(parts[0], AdamState):
        st = parts.pop(0)
        head = {"count": st.count, "mu": flax_dense_tree(dense, st.mu),
                "nu": flax_dense_tree(dense, st.nu)}
    elif parts and isinstance(parts[0], TraceState):
        head = {"trace": flax_dense_tree(dense, parts.pop(0).trace)}
    tail: Dict[str, Any] = {}
    if parts and isinstance(parts[0], ScheduleState):
        tail = {"count": parts.pop(0).count}
    if parts:
        raise ValueError(f"no flax state-dict layout for the dense "
                         f"optimizer state parts {parts}")
    return {"dense_params": flax_dense_tree(dense, None),
            "dense_opt_state": {"0": head, "1": tail},
            "step": step}


def _as_parts(tree: Dict[str, Any]) -> tuple:
    """flax's ``{"0": {...}, "1": {...}}`` chain as a tuple of
    namedtuples with the same fields (what the JAX state's optax
    NamedTuples look like to ``convert._dense_state``)."""
    out = []
    for i in range(len(tree)):
        d = tree[str(i)]
        out.append(namedtuple(f"Part{i}", list(d))(**d))
    return tuple(out)


def load_dense_state_dict(tree: Dict[str, Any], dense, dense_tx):
    """The inverse of :func:`dense_state_dict`: loads ``dense_params``
    into ``dense`` IN PLACE and returns ``(dense_opt_state, step)`` as
    the port's optimizer state and a 0-d int32 tensor, on the dense
    module's device."""
    load_flax_dense(dense, tree["dense_params"])
    dev = next(dense.parameters()).device
    opt = _dense_state(dense, _as_parts(tree["dense_opt_state"]), dense_tx)
    step = torch.as_tensor(tree["step"]).to(torch.int32).reshape(()).to(dev)
    return opt, step
