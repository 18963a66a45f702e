"""DLRM dot interaction on the hand-written kernels K2 (forward) and K4
(backward) in ``csrc/dot_interact.cu``, with their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``distributed_embeddings_tpu/models/dlrm.py:dot_interact``
and of what JAX's autodiff makes of it: for the features ``[B, F, D]``
(the bottom-MLP output first) the forward is the strict lower triangle
of each sample's Gram matrix, in ``np.tril_indices(F, -1)`` order,
followed by feature 0: ``[B, F(F-1)/2 + D]``. The backward spreads each
pair's cotangent over the symmetric ``[F, F]`` matrix ``dG`` and returns
``dG @ feats`` per sample, plus the cotangent of the appended row on
feature 0.

The features come as a LIST of F ``[B, D]`` tensors (the JAX
function's own arguments, which it stacks) or as one STACKED ``[B, F,
D]`` tensor. The kernels take up to 32 features through a table of
(address, row stride) pairs passed by value, so K2 reads each feature
where it lies and the stack is never built (a stacked tensor is taken as
its ``unbind(1)`` views); K4 writes one ``[F, B, D]`` buffer and returns
its F contiguous ``[B, D]`` views (for a stacked input the ``[B, F, D]``
transpose of the buffer). More than 32 features are read from one ``[B,
F, D]`` tensor (a list is stacked once) and K4 writes ``[B, F, D]``.

Which layouts take which path on the card (both are hand-written
kernels; the plain versions run only for CPU tensors):

* the tensor-core kernels: bfloat16, 2 <= F <= 32, D a multiple of 16,
  every feature's rows 16-B aligned (its address and row stride; a list
  feature or a column slice of a wider tensor qualifies);
* the CUDA-core kernels: float32, D not a multiple of 16, or F > 32;
* refused with a ``ValueError`` naming the feature: a last dimension that
  is not contiguous, and, on the tensor-core shapes, rows that are not
  16-B aligned. Nothing is copied to make a layout fit.

Both wrappers launch through ``ops/_kernels.py``'s launch records: the
first call with a set of features (their addresses, shapes, strides and
dtype) validates it and builds the launch parameters once; a later call
with the same features only reads the output's (and dy's) address and
replays. ``DotInteract``'s backward finds K4's record through the
forward's K2 record (the same features), so it builds no key of the
features again.
"""

from __future__ import annotations

import functools
import operator
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the features a launch's table holds (``csrc/dot_interact.cu``'s kTable)
TABLE = 32
#: the most features the kernels take
MAX_FEATURES = 255

Feats = Union[torch.Tensor, Sequence[torch.Tensor]]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the plain versions'
    gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def _is_list(feats: Feats) -> bool:
    return not isinstance(feats, torch.Tensor)


def _shape(feats: Feats) -> Tuple[int, int, int]:
    """``(B, F, D)`` of either form (raising on a malformed one)."""
    if not _is_list(feats):
        if feats.dim() != 3:
            raise ValueError(f"feats must be [B, F, D], got "
                             f"{tuple(feats.shape)}")
        return tuple(feats.shape)
    if len(feats) < 1:
        raise ValueError("feats must hold at least one feature")
    first = feats[0]
    if first.dim() != 2:
        raise ValueError(f"feature 0 must be [B, D], got "
                         f"{tuple(first.shape)}")
    return first.shape[0], len(feats), first.shape[1]


def _stacked(feats: Feats) -> torch.Tensor:
    """The ``[B, F, D]`` stack of either form (the plain versions')."""
    return torch.stack(list(feats), dim=1) if _is_list(feats) else feats


def dot_interact_fwd_plain(feats: Feats) -> torch.Tensor:
    """Plain PyTorch version of :func:`dot_interact_fwd`: fp32 Gram,
    triangle by index, one rounding to the input dtype."""
    x = _stacked(feats)
    f = x.to(_acc_dtype(x.dtype))
    gram = torch.bmm(f, f.transpose(1, 2))
    li, lj = np.tril_indices(x.shape[1], k=-1)
    lower = gram[:, torch.as_tensor(li, device=x.device),
                 torch.as_tensor(lj, device=x.device)]
    return torch.cat([lower.to(x.dtype), x[:, 0]], dim=1)


def dot_interact_bwd_plain(feats: Feats, dy: torch.Tensor):
    """Plain PyTorch version of :func:`dot_interact_bwd`: the symmetric
    ``dG`` built by index, ``bmm`` in fp32, one rounding to the input
    dtype; the list form gets F ``[B, D]`` views of one ``[F, B, D]``
    buffer."""
    x = _stacked(feats)
    b, f, d = x.shape
    acc = _acc_dtype(x.dtype)
    li, lj = np.tril_indices(f, k=-1)
    li = torch.as_tensor(li, device=x.device)
    lj = torch.as_tensor(lj, device=x.device)
    lower = dy[:, :len(li)].to(acc)
    dg = torch.zeros((b, f, f), dtype=acc, device=x.device)
    dg[:, li, lj] = lower
    dg[:, lj, li] = lower
    out = torch.bmm(dg, x.to(acc))
    out[:, 0] += dy[:, len(li):].to(acc)
    if not _is_list(feats):
        return out.to(x.dtype)
    return tuple(out.transpose(0, 1).to(x.dtype).contiguous().unbind(0))


def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _tensor_cores(dtype: torch.dtype, f: int, d: int) -> bool:
    """Whether the card takes these features on the tensor-core path."""
    return dtype == torch.bfloat16 and 2 <= f <= TABLE and d % 16 == 0


def check_feats(feats: Feats) -> Tuple[int, int, int]:
    """Validate either form as the wrappers do (on any device) and
    return ``(B, F, D)``: one dtype, one device, one ``[B, D]`` shape,
    2..255 features, a contiguous last dimension, and on the tensor-core
    shapes 16-B aligned rows; a ``ValueError`` names what is refused."""
    b, f, d = _shape(feats)
    if not 2 <= f <= MAX_FEATURES:
        raise ValueError(f"dot_interact takes 2..{MAX_FEATURES} features, "
                         f"got {f}")
    listed = _is_list(feats)
    ts = feats if listed else (feats,)
    first = ts[0]
    _check_device(first.device)
    tc = _tensor_cores(first.dtype, f, d)
    es = first.element_size()
    # the facts of all features at once; a feature at fault is named below
    strides = list(map(_STRIDE, ts))
    rows = ([st[0] for st in strides] if listed
            else [strides[0][0], strides[0][1]])
    ok = (len(set(map(_SHAPE, ts))) == 1 and len(set(map(_DTYPE, ts))) == 1
          and len(set(map(_kernels._DEVICE, ts))) == 1
          and (d == 1 or all(st[-1] == 1 for st in strides))
          and not (tc and (functools.reduce(operator.or_, map(_PTR, ts))
                           % 16 or any(r * es % 16 for r in rows))))
    if ok:
        if first.device.type == "cuda" and first.dtype not in _DTYPE_CODE:
            raise ValueError("the kernels take float32/bfloat16 features, "
                             f"got {first.dtype}")
        return b, f, d
    for k, t in enumerate(ts):
        what = f"feature {k}" if listed else "feats"
        if listed and tuple(t.shape) != (b, d):
            raise ValueError(f"{what} must be [{b}, {d}] as feature 0, got "
                             f"{tuple(t.shape)}")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{what} is {t.dtype} on {t.device}, feature 0 "
                             f"{first.dtype} on {first.device}")
        if d > 1 and t.stride(-1) != 1:
            raise ValueError(f"{what}'s last dimension is not contiguous "
                             f"(strides {t.stride()}); the kernels read "
                             "rows in place and copy nothing")
        rs = t.stride()[:-1]
        if tc and (t.data_ptr() % 16 or any(r * es % 16 for r in rs)):
            raise ValueError(
                f"{what}'s rows are not 16-B aligned (address "
                f"{t.data_ptr():#x}, strides {t.stride()}): the "
                "tensor-core kernels read them as 16-B chunks")
    raise AssertionError("check_feats: no feature at fault")


def _rows(feats: Feats):
    """The kernel's view of the features: ``(ptrs, strides, n_table,
    feature stride)`` (elements), the table form for a list, the stacked
    form for a tensor."""
    if _is_list(feats):
        ptrs = np.array([t.data_ptr() for t in feats], np.int64)
        strides = np.array([t.stride(0) for t in feats], np.int64)
        return ptrs, strides, len(feats), 0
    return (np.array([feats.data_ptr()], np.int64),
            np.array([feats.stride(0)], np.int64), 0, feats.stride(1))


def _first(feats: Feats) -> torch.Tensor:
    """Feature 0 of a list, or the stack."""
    return feats[0] if _is_list(feats) else feats


def _record(feats: Feats, out_shape, out_strides, dy_aligned: bool,
            what: str, extra=()) -> _kernels.LaunchRecord:
    """Validate a call (:func:`check_feats`) and build its launch record:
    for CUDA tensors the prepared launch of ``detpu_<what>_launch``; the
    payload is ``(out shape, dtype, device, tensor-core paths, *extra,
    (prepared buffer, its arrays))``. CPU tensors (the tests) get a
    record without launches."""
    b, f, d = check_feats(feats)
    first = _first(feats)
    dev = first.device
    lib = buf = arrays = paths = None
    calls = []
    if dev.type == "cuda":
        lib = _kernels.library("dot_interact")
        buf = np.zeros(lib.detpu_dot_interact_prepared_bytes(), np.uint8)
        arrays = _rows(feats)
        ptrs, strides, n_table, fstride = arrays
        _kernels.check(lib, lib.detpu_dot_interact_prepare(
            ptrs.ctypes.data, strides.ctypes.data, n_table, fstride, b, f,
            d, _DTYPE_CODE[first.dtype], out_strides[0], out_strides[1],
            int(dy_aligned), buf.ctypes.data), what)
        paths = lib.detpu_dot_interact_paths(buf.ctypes.data)
        if b:
            calls = [(getattr(lib, f"detpu_{what}_launch"),
                      (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, what, calls, _kernels.device_index(dev),
        payload=(out_shape, first.dtype, dev, paths, *extra, (buf, arrays)))


_PTR, _SHAPE, _STRIDE = _kernels._PTR, _kernels._SHAPE, _kernels._STRIDE
_DTYPE = _kernels._DTYPE


def fwd_record_key(feats: Feats) -> tuple:
    """Every fact K2's launch record rests on: per feature (or of the
    stack) its address, shape, strides and dtype, and the form (the
    number of tensors). One C-level pass a fact over the tensors, as
    :func:`~._kernels.tensor_key` does (not through it: a tuple less to
    build on every call), less the device index: under CUDA's unified
    addressing an address belongs to one device (or the host), so the
    addresses already fix every feature's device. The addresses are in
    the key rather than passed each call: the step's features come back
    at the same addresses (``chip_smoke.py`` counts the records built in
    its timed windows), and a table of 27 addresses a call costs more
    host time than the key."""
    ts = (feats,) if isinstance(feats, torch.Tensor) else feats
    return (len(ts), *map(_PTR, ts), *map(_SHAPE, ts), *map(_STRIDE, ts),
            *map(_DTYPE, ts))


def build_fwd_record(feats: Feats) -> _kernels.LaunchRecord:
    """Validate a K2 call (raising as :func:`dot_interact_fwd` does) and
    build its launch record (:func:`_record`; the output is ``[B,
    F(F-1)/2 + D]``)."""
    b, f, d = _shape(feats)
    return _record(feats, (b, f * (f - 1) // 2 + d), (0, 0), False,
                   "dot_interact_fwd")


def find_fwd_record(cache: _kernels.LaunchCache, feats: Feats,
                    build_on_cpu: bool = False):
    """K2's launch record of a call (the features as :func:`_as_form`
    gives them): found in ``cache`` by :func:`fwd_record_key`, or built
    (:func:`build_fwd_record`) and kept (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, fwd_record_key(feats), build_fwd_record,
        _first(feats).device.type == "cpu", build_on_cpu, feats)


_FWD = _kernels.LaunchCache()


def _as_form(feats: Feats) -> Feats:
    """The features as the kernels take them: up to :data:`TABLE` as a
    tuple of ``[B, D]`` tensors (a ``[B, F, D]`` tensor as its
    ``unbind(1)`` views), more as one ``[B, F, D]`` tensor (a list of CUDA
    features stacked once, for the CUDA-core kernels)."""
    if isinstance(feats, torch.Tensor):
        if feats.dim() == 3 and feats.shape[1] <= TABLE:
            return feats.unbind(1)
        return feats
    if not isinstance(feats, tuple):
        feats = tuple(feats)
    if len(feats) > TABLE and feats[0].device.type == "cuda":
        check_feats(feats)
        return torch.stack(feats, dim=1)
    return feats


def dot_interact_fwd(feats: Feats, record: Optional[list] = None
                     ) -> torch.Tensor:
    """K2: the features (a list of F ``[B, D]`` tensors, bottom-MLP
    output first, or one ``[B, F, D]`` tensor; float32 or bfloat16) ->
    ``[B, F(F-1)/2 + D]`` in their dtype, products accumulated in fp32.
    A CPU tensor runs :func:`dot_interact_fwd_plain` after the same
    checks; a CUDA tensor launches the kernel or raises (see the module
    docstring for which layouts take which path). ``record``, a list,
    gets the call's launch record appended (None on the CPU), as
    ``DotInteract`` keeps it for the backward. The cache never holds a
    CPU record, so a hit is a card call."""
    feats = _as_form(feats)
    rec = _FWD.get(fwd_record_key(feats))
    if rec is None and _first(feats).device.type != "cuda":
        find_fwd_record(_FWD, feats)  # validates, keeps nothing
        if record is not None:
            record.append(None)
        return dot_interact_fwd_plain(feats)
    if rec is None:
        rec = find_fwd_record(_FWD, feats)
    if record is not None:
        record.append(rec)
    shape, dtype, dev = rec.payload[:3]
    out = torch.empty(*shape, dtype=dtype, device=dev)
    dot_interact_fwd.launches += rec.replay(out.data_ptr())
    return out


dot_interact_fwd.launches = 0


# ---------------------------------------------------------------- K4


def bwd_record_key(feats: Feats, dy: torch.Tensor) -> tuple:
    """Every fact K4's launch record rests on: the features' (as in
    :func:`fwd_record_key`), the layout of ``dy`` and whether its
    address is 16-B aligned (its address is read per call)."""
    return (*fwd_record_key(feats), *_dy_key(dy))


def _dy_key(dy: torch.Tensor) -> tuple:
    return _kernels.layout_key(dy), dy.data_ptr() % 16 == 0


def build_bwd_record(feats: Feats, dy: torch.Tensor) -> _kernels.LaunchRecord:
    """Validate a K4 call (raising as :func:`dot_interact_bwd` does) and
    build its launch record (:func:`_record`, the table form after the
    paths in the payload): the table form's output is ``[F, B, D]`` (each
    feature's gradient a contiguous view), the stacked form's ``[B, F,
    D]``."""
    b, f, d = _shape(feats)
    want = (b, f * (f - 1) // 2 + d)
    if dy.dim() != 2 or tuple(dy.shape) != want:
        raise ValueError(f"dy must be {want}, got {tuple(dy.shape)}")
    first = _first(feats)
    _check_device(dy.device)
    if dy.dtype != first.dtype or dy.device != first.device or \
            not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor of the features' "
                         f"dtype and device ({first.dtype} on "
                         f"{first.device}), got {dy.dtype} on {dy.device}")
    listed = _is_list(feats)
    shape, strides = ((f, b, d), (b * d, d)) if listed else \
        ((b, f, d), (d, f * d))
    return _record(feats, shape, strides, dy.data_ptr() % 16 == 0,
                   "dot_interact_bwd", extra=(listed,))


def find_bwd_record(cache: _kernels.LaunchCache, feats: Feats,
                    dy: torch.Tensor, build_on_cpu: bool = False,
                    key: Optional[tuple] = None):
    """K4's launch record of a call (the features as :func:`_as_form`
    gives them): found in ``cache`` by ``key`` (by default
    :func:`bwd_record_key`), or built (:func:`build_bwd_record`) and
    kept."""
    return _kernels.find_or_build(
        cache, bwd_record_key(feats, dy) if key is None else key,
        build_bwd_record, _first(feats).device.type == "cpu", build_on_cpu,
        feats, dy)


_BWD = _kernels.LaunchCache()


def dot_interact_bwd(feats: Feats, dy: torch.Tensor,
                     fwd_record: Optional[_kernels.LaunchRecord] = None):
    """K4: the cotangent of :func:`dot_interact_fwd`'s input. ``dy [B,
    F(F-1)/2 + D]`` (contiguous, the features' dtype) -> for a list of
    features a tuple of F ``[B, D]`` gradients (up to :data:`TABLE`
    features: contiguous views of one ``[F, B, D]`` buffer; more: of the
    stack's ``[B, F, D]``), for a ``[B, F, D]`` tensor one ``[B, F, D]``
    tensor (up to :data:`TABLE` features the ``[F, B, D]`` buffer's
    transpose); accumulated in fp32, rounded once. ``fwd_record``, K2's
    record of the same features (``DotInteract`` keeps it), keys K4's
    record without the features' facts. A CPU tensor runs
    :func:`dot_interact_bwd_plain` after the same checks; a CUDA tensor
    launches the kernel or raises."""
    stacked = isinstance(feats, torch.Tensor)
    form = _as_form(feats)
    key = bwd_record_key(form, dy) if fwd_record is None else \
        (fwd_record, *_dy_key(dy))
    rec = _BWD.get(key)
    if rec is None:
        if _first(form).device.type != "cuda":
            find_bwd_record(_BWD, form, dy)  # validates, keeps nothing
            return dot_interact_bwd_plain(feats, dy)
        rec = find_bwd_record(_BWD, form, dy, key=key)
    shape, dtype, dev, _, listed = rec.payload[:5]
    out = torch.empty(*shape, dtype=dtype, device=dev)
    dot_interact_bwd.launches += rec.replay(dy.data_ptr(), out.data_ptr())
    if listed:
        return out.transpose(0, 1) if stacked else out.unbind(0)
    return out if stacked else out.unbind(1)


dot_interact_bwd.launches = 0


def tensor_core_paths(feats: Feats, dy: Optional[torch.Tensor] = None
                      ) -> int:
    """Which of a call's kernels run on the tensor cores (bit 0: K2, bit
    1: K4), from its launch record (the card only)."""
    feats = _as_form(feats)
    rec = find_fwd_record(_FWD, feats) if dy is None else \
        find_bwd_record(_BWD, feats, dy)
    return rec.payload[3]


class DotInteract(torch.autograd.Function):
    """``dot_interact_fwd`` (K2) with ``dot_interact_bwd`` (K4) as its
    gradient: ``DotInteract.apply(*features)`` for F ``[B, D]`` features
    (each gets its own gradient), or ``DotInteract.apply(feats)`` for one
    ``[B, F, D]`` tensor."""

    @staticmethod
    def _form(feats):
        return feats[0] if len(feats) == 1 and feats[0].dim() == 3 \
            else feats

    @staticmethod
    def forward(ctx, *feats):
        ctx.save_for_backward(*feats)
        found = []
        out = dot_interact_fwd(DotInteract._form(feats), record=found)
        ctx.record = found[0] if found else None
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = dot_interact_bwd(DotInteract._form(ctx.saved_tensors),
                                 dy.contiguous(), fwd_record=ctx.record)
        return grads if isinstance(grads, tuple) else (grads,)
