"""Sparse SGD row update on the hand-written kernels K3
(``csrc/sgd_scatter.cu``) and K18 (``csrc/sgd_promoted.cu``), one
sorted-segment engine (``csrc/segment_scatter.cuh``) with two rounding
chains, with their plain PyTorch versions.

Counterpart of the scatter in
``distributed_embeddings_tpu/parallel/optimizers.py``
(``_sorted_scatter_add`` under ``SparseSGD.apply_rows``):
``slab.at[ids].add(-lr * vals.astype(slab.dtype), mode="drop")``, here
IN PLACE on the slab. The update's rounding chain is JAX's:

* a constant ``lr`` (a Python number) is rounded to the slab dtype,
  the product ``-lr * vals`` is rounded to it again, and every add into
  the slab rounds to the slab dtype (K3);
* a device scalar ``lr`` (a float32 tensor, what a callable schedule
  gives) multiplies in float32. Into a float32 slab that is K3's chain.
  Into a bfloat16 slab the update is float32, so JAX promotes the whole
  slab to float32 for the scatter, adds in float32 in stream order and
  rounds each element once (K18, :func:`sgd_scatter_promoted`; no
  float32 copy of the slab is made here).

``cast_vals=False`` gives the chain of ``SparseSGD``'s
``DETPU_SGD_DEDUP`` branch, ``slab.at[uids].add((-lr *
uvals).astype(slab.dtype))``: the product is taken in the vals dtype (a
constant lr) or in float32 (a tensor lr) and rounded once to the slab
dtype, every add rounding to the slab dtype (K3).

Ids index the slab as JAX indexing does: a negative id counts from the
end once (``-1`` is the last row); ids past the slab, or still negative,
are DROPPED. The dropped-row sentinel (``rows_cap``) relies on that.

On the card both kernels sort (row, stream position) stably and apply
each distinct row once, its updates in stream order, with no atomics: K3
gives the plain version's bits on every row hit at most :data:`SPLIT`
times and the same bits on every run; K18 gives the plain version's bits
on every row. Both launch through a launch record (``ops/_kernels.py``)
that owns the sort's scratch, zeroed once: nothing is reset between
calls, on the host or in a CUDA-graph replay (one stream at a time a
record).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Lr = Union[float, torch.Tensor]

#: K3's chunk L (``csrc/segment_scatter.cuh`` kSplit): a row hit at most
#: this many times is added in stream order, bit-exact to the plain
#: version; a longer segment is summed in chunks of it
SPLIT = 256
#: the (row, position) pairs a sort tile takes (kTile)
SORT_TILE = 4096
#: K18: the segments this long or longer take the block path
LONG_SEGMENT = 256


def _neg_lr(lr: Lr, dtype: torch.dtype) -> torch.Tensor:
    """``-lr`` as the multiplier of the update: a 0-d tensor in ``dtype``
    (the slab's, or the vals' in the dedup chain) for a constant lr, in
    float32 for a tensor lr."""
    if isinstance(lr, torch.Tensor):
        return -lr.to(torch.float32)
    return torch.tensor(-float(lr), dtype=dtype)


def _as_lr(lr) -> Lr:
    """The lr as the port takes it: a numpy float scalar is a strongly
    typed float32 in JAX (only a Python number is weak), so it becomes a
    float32 tensor; anything else is returned as it is."""
    if isinstance(lr, np.floating):
        return torch.tensor(float(lr), dtype=torch.float32)
    return lr


def _promoted(slab: torch.Tensor, lr: Lr, cast_vals: bool) -> bool:
    """Whether the update is JAX's promoted chain (K18)."""
    return (cast_vals and isinstance(lr, torch.Tensor)
            and slab.dtype == torch.bfloat16)


def _keep(ids: torch.Tensor, rows: int):
    """``(rows hit, mask of the kept ids)`` under JAX's indexing."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + rows, ids)
    return ids, (ids >= 0) & (ids < rows)


def add_in_stream_order(slab: torch.Tensor, rows: torch.Tensor,
                        upd: torch.Tensor) -> torch.Tensor:
    """``slab[rows[i]] += upd[i]`` in place for i in stream order, every
    add rounded to the slab dtype: JAX's scatter-add order and rounding.
    One pass for each repeat of the most repeated row (the k-th pass adds
    every row's k-th update). Returns ``slab``."""
    m = rows.numel()
    if m == 0:
        return slab
    order = torch.sort(rows, stable=True).indices
    r = rows[order]
    at = torch.arange(m, device=rows.device)
    first = torch.ones(m, dtype=torch.bool, device=rows.device)
    first[1:] = r[1:] != r[:-1]
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    by_rank = order[torch.sort(rank, stable=True).indices]
    lo = 0
    for hi in torch.cumsum(torch.bincount(rank), 0).tolist():
        sel = by_rank[lo:hi]
        rr = rows[sel]
        slab[rr] = (slab[rr].float() + upd[sel].float()).to(slab.dtype)
        lo = hi
    return slab


def sgd_scatter_plain(slab: torch.Tensor, ids: torch.Tensor,
                      vals: torch.Tensor, lr: Lr,
                      cast_vals: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`sgd_scatter`: mask, then add the
    updates (the promoted chain through
    :func:`sgd_scatter_promoted_plain`). On the CPU they are added in
    stream order, each add rounded to the slab dtype, as JAX adds them:
    ``index_add_`` for a float32 slab (it adds the rows of a 2-D source
    one after another), :func:`add_in_stream_order` for a bfloat16 one
    (the CPU ``index_add_`` sums a bfloat16 row in float32). On the card
    ``index_add_``'s atomics add in an order of their choosing. Returns
    ``slab``."""
    lr = _as_lr(lr)
    if _promoted(slab, lr, cast_vals):
        return sgd_scatter_promoted_plain(slab, ids, vals, lr)
    ids, keep = _keep(ids, slab.shape[0])
    if cast_vals:
        nl = _neg_lr(lr, slab.dtype).to(slab.device)
        upd = (vals.to(slab.dtype).to(nl.dtype) * nl).to(slab.dtype)
    else:
        nl = _neg_lr(lr, vals.dtype).to(slab.device)
        upd = (nl * vals.to(nl.dtype)).to(slab.dtype)
    if slab.device.type == "cpu" and slab.dtype != torch.float32:
        return add_in_stream_order(slab, ids[keep], upd[keep])
    return slab.index_add_(0, ids[keep], upd[keep])


def _check_args(slab, ids, vals, dtypes, what):
    if slab.dtype not in dtypes or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError(f"{what}: slab must be a contiguous 2-D "
                         f"{'/'.join(str(d)[6:] for d in dtypes)} tensor, "
                         f"got {slab.dtype} {tuple(slab.shape)}")
    n = ids.shape[0] if ids.dim() == 1 else -1
    w = slab.shape[1]
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64) \
            or ids.device != slab.device or not ids.is_contiguous():
        raise ValueError(f"{what}: ids: expected a contiguous [n] "
                         f"int32/int64 tensor on {slab.device}, got "
                         f"{ids.dtype} {tuple(ids.shape)} on {ids.device}")
    if vals.dtype not in _DTYPE_CODE or tuple(vals.shape) != (n, w) \
            or vals.device != slab.device or not vals.is_contiguous():
        raise ValueError(f"{what}: vals: expected a contiguous {(n, w)} "
                         f"float32/bfloat16 tensor on {slab.device}, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    if n >= 2 ** 31 or slab.shape[0] >= 2 ** 32:
        raise ValueError(f"{what}: {n} ids into {slab.shape[0]} rows; the "
                         "kernel takes fewer than 2^31 ids and 2^32 rows")
    return n, w


def _card_lr(lr: Lr, slab: torch.Tensor) -> Lr:
    """A tensor lr as the float32 scalar the kernels read on the slab's
    card (a copy only when it is not one already)."""
    if isinstance(lr, torch.Tensor) and (lr.dtype != torch.float32
                                         or lr.device != slab.device):
        return lr.to(device=slab.device, dtype=torch.float32)
    return lr


def _lr_fact(lr: Lr):
    """The facts of the lr a record rests on: a constant's value, or a
    tensor's layout (its address is read per call)."""
    if isinstance(lr, torch.Tensor):
        return _kernels.layout_key(lr)
    return float(lr)


def _check_lr(lr: torch.Tensor) -> None:
    if lr.numel() != 1 or not lr.dtype.is_floating_point:
        raise ValueError(f"a tensor lr must hold one float value, got "
                         f"{lr.dtype} of shape {tuple(lr.shape)}")


def _check_constants(lib, what: str) -> None:
    if lib.detpu_segment_prepared_bytes() <= 0 or (
            what == "sgd_scatter"
            and (lib.detpu_segment_split() != SPLIT
                 or lib.detpu_segment_sort_tile() != SORT_TILE)) or (
            what == "sgd_promoted"
            and lib.detpu_segment_long() != LONG_SEGMENT):
        raise RuntimeError("csrc/segment_scatter.cuh and ops/scatter_add.py "
                           "disagree on the engine's constants")


def sgd_record_key(slab, ids, vals, lr, cast_vals=True) -> tuple:
    """Every fact K3's launch record rests on: the layouts (shape,
    strides, dtype, device) of the slab, ids and vals, whose addresses
    are read per call, the lr (a constant's value or a tensor's layout)
    and the chain."""
    return ("sgd_scatter", _kernels.layout_key(slab),
            _kernels.layout_key(ids), _kernels.layout_key(vals),
            _lr_fact(lr), bool(cast_vals))


def build_sgd_record(slab, ids, vals, lr,
                     cast_vals=True) -> _kernels.LaunchRecord:
    """Validate a K3 call as :func:`sgd_scatter` always has and build its
    launch record: for CUDA tensors the engine's scratch (owned by the
    record, zeroed once) and the prepared launch. Payload: ``(scratch,
    prepared launch)``. CPU tensors (the tests) get a record without
    launches."""
    n, w = _check_args(slab, ids, vals, _DTYPE_CODE, "sgd_scatter")
    if isinstance(lr, torch.Tensor):
        _check_lr(lr)
        neg_lr, on_card = 0.0, 1
    else:
        nl_dtype = slab.dtype if cast_vals else vals.dtype
        neg_lr, on_card = float(_neg_lr(lr, nl_dtype)), 0
    dev = slab.device
    lib, calls, buf, scratch = None, [], None, None
    if dev.type == "cuda":
        lib = _kernels.library("sgd_scatter")
        _check_constants(lib, "sgd_scatter")
        scratch = torch.zeros(lib.detpu_sgd_scatter_scratch_bytes(n, w),
                              dtype=torch.uint8, device=dev)
        buf = np.zeros(lib.detpu_segment_prepared_bytes(), np.uint8)
        _kernels.check(lib, lib.detpu_sgd_scatter_prepare(
            slab.shape[0], w, _DTYPE_CODE[slab.dtype],
            int(ids.dtype == torch.int64), n, _DTYPE_CODE[vals.dtype],
            neg_lr, on_card, int(bool(cast_vals)), scratch.data_ptr(),
            buf.ctypes.data), "sgd_scatter")
        if n:
            calls = [(lib.detpu_sgd_scatter_launch, (buf.ctypes.data,))]
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return _kernels.LaunchRecord(lib, "sgd_scatter", calls,
                                 _kernels.device_index(dev),
                                 payload=(scratch, buf))


def find_sgd_record(cache: _kernels.LaunchCache, slab, ids, vals, lr,
                    cast_vals=True, build_on_cpu: bool = False):
    """K3's launch record of a call: found in ``cache`` by
    :func:`sgd_record_key`, or built (:func:`build_sgd_record`) and kept."""
    return _kernels.find_or_build(
        cache, sgd_record_key(slab, ids, vals, lr, cast_vals),
        build_sgd_record, slab.device.type == "cpu", build_on_cpu, slab, ids,
        vals, lr, cast_vals)


_K3 = _kernels.LaunchCache()


def sgd_scatter(slab: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                lr: Lr, cast_vals: bool = True) -> torch.Tensor:
    """K3: ``slab[ids] += round(-lr * round(vals))`` in place, dropping
    out-of-range ids (see the module docstring). Returns ``slab``.

    ``slab [R, w]`` float32/bfloat16 (contiguous), ``ids [n]``
    int32/int64, ``vals [n, w]`` float32/bfloat16 (contiguous), ``lr`` a
    Python number or a one-element float tensor (read as float32; a
    numpy float scalar counts as one, as it is strongly typed in JAX). A
    bfloat16 slab with a tensor lr takes JAX's promoted chain through
    :func:`sgd_scatter_promoted` (K18; ``cast_vals=False`` stays on K3).
    A CPU slab runs the plain versions; a CUDA slab launches the kernel
    or raises. Deterministic: a row's updates are added in stream order
    (rows hit more than :data:`SPLIT` times: in chunks of it, summed in
    a fixed order)."""
    lr = _as_lr(lr)
    if _promoted(slab, lr, cast_vals):
        return sgd_scatter_promoted(slab, ids, vals, lr)
    if slab.device.type == "cpu":
        return sgd_scatter_plain(slab, ids, vals, lr, cast_vals)
    lr = _card_lr(lr, slab)
    rec = (_K3.get(sgd_record_key(slab, ids, vals, lr, cast_vals))
           or find_sgd_record(_K3, slab, ids, vals, lr, cast_vals))
    if rec.calls:
        sgd_scatter.launches += rec.replay(
            slab.data_ptr(), ids.data_ptr(), vals.data_ptr(),
            lr.data_ptr() if isinstance(lr, torch.Tensor) else None)
    return slab


sgd_scatter.launches = 0


def sgd_scatter_promoted_plain(slab: torch.Tensor, ids: torch.Tensor,
                               vals: torch.Tensor,
                               lr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sgd_scatter_promoted`: gather the
    distinct hit rows to float32, ``index_add_`` the float32 products
    ``f32(-lr) * f32(bf16(vals))`` into them, round once and write the
    rows back. On the CPU ``index_add_`` of a 2-D source adds its rows
    one after another in stream order, JAX's CPU scatter order; only
    the hit rows are ever float32. Returns ``slab``."""
    ids, keep = _keep(ids, slab.shape[0])
    ids = ids[keep]
    if ids.numel() == 0:
        return slab
    nl = -lr.to(torch.float32).reshape(()).to(slab.device)
    upd = nl * vals[keep].to(torch.bfloat16).to(torch.float32)
    rows, inv = torch.unique(ids, return_inverse=True)
    acc = slab.index_select(0, rows).to(torch.float32)
    acc.index_add_(0, inv, upd)
    slab.index_copy_(0, rows, acc.to(slab.dtype))
    return slab


def promoted_record_key(slab, ids, vals, lr) -> tuple:
    """Every fact K18's launch record rests on (as :func:`sgd_record_key`;
    the lr is always a tensor)."""
    return ("sgd_promoted", _kernels.layout_key(slab),
            _kernels.layout_key(ids), _kernels.layout_key(vals),
            _lr_fact(lr))


def build_promoted_record(slab, ids, vals, lr) -> _kernels.LaunchRecord:
    """Validate a K18 call as :func:`sgd_scatter_promoted` always has and
    build its launch record (scratch and prepared launch, as K3's)."""
    if not isinstance(lr, torch.Tensor):
        raise TypeError("sgd_scatter_promoted takes a tensor lr (a "
                        "constant lr rounds to the slab dtype: K3's chain)")
    n, w = _check_args(slab, ids, vals, (torch.bfloat16,),
                       "sgd_scatter_promoted")
    _check_lr(lr)
    dev = slab.device
    lib, calls, buf, scratch = None, [], None, None
    if dev.type == "cuda":
        lib = _kernels.library("sgd_promoted")
        _check_constants(lib, "sgd_promoted")
        scratch = torch.zeros(lib.detpu_sgd_promoted_scratch_bytes(n, w),
                              dtype=torch.uint8, device=dev)
        buf = np.zeros(lib.detpu_segment_prepared_bytes(), np.uint8)
        _kernels.check(lib, lib.detpu_sgd_promoted_prepare(
            slab.shape[0], w, int(ids.dtype == torch.int64), n,
            _DTYPE_CODE[vals.dtype], scratch.data_ptr(), buf.ctypes.data),
            "sgd_scatter_promoted")
        if n:
            calls = [(lib.detpu_sgd_promoted_launch, (buf.ctypes.data,))]
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return _kernels.LaunchRecord(lib, "sgd_scatter_promoted", calls,
                                 _kernels.device_index(dev),
                                 payload=(scratch, buf))


def find_promoted_record(cache: _kernels.LaunchCache, slab, ids, vals, lr,
                         build_on_cpu: bool = False):
    """K18's launch record of a call: found in ``cache`` by
    :func:`promoted_record_key`, or built and kept."""
    return _kernels.find_or_build(
        cache, promoted_record_key(slab, ids, vals, lr),
        build_promoted_record, slab.device.type == "cpu", build_on_cpu, slab,
        ids, vals, lr)


_K18 = _kernels.LaunchCache()


def sgd_scatter_promoted(slab: torch.Tensor, ids: torch.Tensor,
                         vals: torch.Tensor,
                         lr: torch.Tensor) -> torch.Tensor:
    """K18: JAX's promoted scatter into a bfloat16 slab, in place: every
    row hit by a kept id becomes ``bf16_rn(f32(slab[r]) + sum_i
    f32(-lr) * f32(bf16(vals[i])))``, the sum taken in float32 in stream
    order; rows not hit keep their bits. Ids follow K3's rules.

    ``slab [R, w]`` bfloat16 (contiguous), ``ids [n]`` int32/int64,
    ``vals [n, w]`` float32/bfloat16 (contiguous), ``lr`` a one-element
    float tensor. A CPU slab runs :func:`sgd_scatter_promoted_plain`; a
    CUDA slab launches the kernel (the engine's stable sort of (row,
    position), then each distinct row once) or raises. Deterministic:
    the card gives the plain version's bits. Returns ``slab``."""
    if not isinstance(lr, torch.Tensor):
        raise TypeError("sgd_scatter_promoted takes a tensor lr (a "
                        "constant lr rounds to the slab dtype: K3's chain)")
    if slab.device.type == "cpu":
        return sgd_scatter_promoted_plain(slab, ids, vals, lr)
    lr = _card_lr(lr, slab)
    rec = (_K18.get(promoted_record_key(slab, ids, vals, lr))
           or find_promoted_record(_K18, slab, ids, vals, lr))
    if rec.calls:
        sgd_scatter_promoted.launches += rec.replay(
            slab.data_ptr(), ids.data_ptr(), vals.data_ptr(), lr.data_ptr())
    return slab


sgd_scatter_promoted.launches = 0
