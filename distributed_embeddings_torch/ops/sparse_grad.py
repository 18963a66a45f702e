"""Dedup of sparse gradient rows on the hand-written kernel K5
(``csrc/dedup.cu``), with its plain PyTorch version.

Counterpart of ``distributed_embeddings_tpu/ops/sparse_grad.py:
dedup_sparse_grad``: sort the ids, sum the rows of duplicates. The
optimizers whose update is nonlinear in the gradient (``SparseAdagrad``'s
sparse regime) need it before their per-row read-modify-write;
``SparseSGD`` runs it only under ``DETPU_SGD_DEDUP=1``.

The contract is JAX's: ``U = min(n, max_unique)`` outputs; position
``k`` below the number of distinct ids holds the k-th smallest distinct
id (signed order) and the sum of its rows; the tail holds ``pad_id``
(and zero rows). Both versions sum in float32, in stable sorted order
(the kernel adds a hot id's rows in fixed pieces of 256, in order), and
round once to the rows' dtype; JAX sums in the rows' dtype, so bfloat16
sums differ from it by up to one ulp per add.

The ragged backward (ROADMAP B6) runs on the hand-written kernel K9
(``csrc/ragged_grad.cu``): :func:`ragged_grad` expands each CSR row's
cotangent to its value positions (times the position's weight, divided
by the row's length on mean slots) and, for the optimizer stream, gives
each position its slab row or the dropped-row sentinel; the op-level
:func:`combiner_grad_values` is the same expansion without ids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .embedding_lookup import (_INT, _expect, _expect_rows, _rnd,
                               _row_bounds, _stream, ragged_row_ids_plain,
                               weight_floats)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ragged_grad_plain(g: torch.Tensor, splits: torch.Tensor, *,
                      cap: Optional[int] = None,
                      values: Optional[torch.Tensor] = None,
                      rows: Optional[torch.Tensor] = None,
                      roff: Optional[torch.Tensor] = None,
                      sentinel: int = 0, ids_dtype=None,
                      mean: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      reciprocal: bool = False):
    """Plain PyTorch version of :func:`ragged_grad`, slot by slot, with
    the same rounding after each op."""
    n, b, w = g.shape
    dt = g.dtype
    cap = values.shape[1] if cap is None else int(cap)
    vals = torch.empty((n, cap, w), dtype=dt, device=g.device)
    ids = None
    if values is not None:
        ids = torch.empty((n, cap), dtype=ids_dtype or values.dtype,
                          device=g.device)
    start, end = _row_bounds(splits, cap)
    count = _rnd((splits[:, 1:] - splits[:, :-1]).clamp(min=1).float(), dt)
    for k in range(n):
        # the row of each position (b past the last row), as the kernel's
        # row ranges give it
        seg = ragged_row_ids_plain(
            torch.cat([start[k, :1], end[k]]), cap).long()
        live = seg < b
        segc = seg.clamp(0, max(b - 1, 0))
        x = torch.zeros((cap, w), dtype=torch.float32, device=g.device)
        if b:
            x = torch.where(live[:, None], g[k].float()[segc], x)
        if weights is not None:
            wf = _rnd(weight_floats(weights[k:k + 1, :cap])[0], dt)
            x = _rnd(x * wf[:, None], dt)
        if mean is not None and int(mean[k]) != 0:
            c = count[k][segc][:, None]
            x = (_rnd(x * _rnd(1.0 / c, dt), dt) if reciprocal
                 else _rnd(x / c, dt))
        vals[k] = x.to(dt)
        if ids is not None:
            v = values[k, :cap].long()
            ok = live & (v >= 0) & (v < rows[k])
            ids[k] = torch.where(ok, v + roff[k], sentinel).to(ids.dtype)
    return ids, vals


def ragged_grad(g: torch.Tensor, splits: torch.Tensor, *,
                cap: Optional[int] = None,
                values: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None,
                roff: Optional[torch.Tensor] = None, sentinel: int = 0,
                ids_dtype=None, mean: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None,
                reciprocal: bool = False):
    """K9: the per-position cotangent stream of a CSR lookup.

    ``g [n, b, w]`` (float32/bfloat16, unit element stride; slots and
    rows may be strided, as a view into the cotangent block) holds each
    slot's row cotangents, ``splits [n, b + 1]`` (int64) the CSR offsets
    of the forward. For every position ``p < cap`` of every slot it
    gives the row ``g[row(p)]`` times ``weights[k, p]`` (float32, or the
    float32 bits in an int32/int64 id block) rounded to ``g``'s dtype,
    then, where ``mean[k]`` (int32) is set, divided by (or, with
    ``reciprocal``, multiplied by the rounded reciprocal of) the row's
    claimed length ``max(splits[r + 1] - splits[r], 1)`` rounded to that
    dtype; positions past the last row get zero rows. With ``values
    [n, cap']`` (``cap' >= cap``, int32/int64 table-local ids), it also
    gives each position's slab row ``values[k, p] + roff[k]`` where the
    position lies in a row and the id in ``[0, rows[k])``, else
    ``sentinel``, in ``ids_dtype`` (default: the values').

    Returns ``(ids [n, cap] or None, vals [n, cap, w])``. A CPU ``g``
    runs :func:`ragged_grad_plain`; a CUDA ``g`` launches the kernel
    (``csrc/ragged_grad.cu``) or raises."""
    if g.dim() != 3 or splits.dim() != 2:
        raise ValueError(f"g must be [n, b, w] and splits [n, b + 1], got "
                         f"{tuple(g.shape)}, {tuple(splits.shape)}")
    if cap is None:
        if values is None:
            raise ValueError("ragged_grad needs cap= without values")
        cap = values.shape[1]
    if values is not None and (rows is None or roff is None):
        raise ValueError("an id stream needs rows= and roff=")
    kw = dict(cap=int(cap), values=values, rows=rows, roff=roff,
              sentinel=int(sentinel), ids_dtype=ids_dtype, mean=mean,
              weights=weights, reciprocal=reciprocal)
    if g.device.type == "cpu":
        return ragged_grad_plain(g, splits, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    n, b, w = g.shape
    dev = g.device
    if g.dtype not in _DTYPE_CODE or (w > 1 and g.stride(2) != 1):
        raise ValueError(f"g: expected float32/bfloat16 of unit element "
                         f"stride, got {g.dtype} strides {g.stride()}")
    _expect(splits, (torch.int64,), (n, b + 1), dev, "splits")
    ids = None
    if values is not None:
        _expect_rows(values, _INT, n, dev, "values")
        if values.shape[1] < cap:
            raise ValueError(f"values: {values.shape[1]} per slot for a "
                             f"capacity of {cap}")
        _expect(rows, (torch.int64,), (n,), dev, "rows")
        _expect(roff, (torch.int64,), (n,), dev, "roff")
        ids = torch.empty((n, cap), dtype=ids_dtype or values.dtype,
                          device=dev)
        if ids.dtype not in _INT:
            raise ValueError(f"ids_dtype {ids.dtype} is not int32/int64")
    if mean is not None:
        _expect(mean, (torch.int32,), (n,), dev, "mean")
    if weights is not None:
        _expect_rows(weights, (torch.float32,) + _INT, n, dev, "weights")
        if weights.shape[1] < cap:
            raise ValueError(f"weights: {weights.shape[1]} per slot for a "
                             f"capacity of {cap}")
    vals = torch.empty((n, cap, w), dtype=g.dtype, device=dev)
    if n * cap == 0:
        return ids, vals
    lib = _kernels.library("ragged_grad")
    err = lib.detpu_ragged_grad(
        g.data_ptr(), g.stride(0), g.stride(1), w, _DTYPE_CODE[g.dtype],
        splits.data_ptr(), None if values is None else values.data_ptr(),
        int(values is not None and values.dtype == torch.int64),
        0 if values is None else values.stride(0),
        None if rows is None else rows.data_ptr(),
        None if roff is None else roff.data_ptr(), int(sentinel),
        None if ids is None else ids.data_ptr(),
        int(ids is not None and ids.dtype == torch.int64),
        None if mean is None else mean.data_ptr(), int(bool(reciprocal)),
        None if weights is None else weights.data_ptr(),
        0 if weights is None else weights.element_size(),
        0 if weights is None else weights.stride(0), vals.data_ptr(), n, b,
        int(cap), _stream(g))
    _kernels.check(lib, err, "ragged_grad")
    ragged_grad.launches += 1
    return ids, vals


ragged_grad.launches = 0


def combiner_grad_values(out_grad: torch.Tensor, row_splits: torch.Tensor,
                         capacity: int, combiner: str) -> torch.Tensor:
    """Per-id gradient rows ``[capacity, w]`` of a CSR lookup with a
    combiner, from its output cotangent ``out_grad [batch, w]`` and the
    forward's ``row_splits [batch + 1]``: each position gets its row's
    cotangent (``'mean'``: times the rounded reciprocal of the row's
    length, as JAX computes it), padding positions zeros. On K9."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner!r}")
    dev = out_grad.device
    mean = (torch.ones(1, dtype=torch.int32, device=dev)
            if combiner == "mean" else None)
    splits = torch.as_tensor(row_splits).to(dev).long().reshape(1, -1)
    _, vals = ragged_grad(out_grad[None], splits, cap=int(capacity),
                          mean=mean, reciprocal=True)
    return vals[0]


def _prepare(ids, pad_id, valid, max_unique):
    n = ids.shape[0]
    u = n if max_unique is None else min(n, int(max_unique))
    if valid is not None:
        ids = torch.where(valid, ids, torch.tensor(pad_id, dtype=ids.dtype,
                                                   device=ids.device))
    return ids, u


def dedup_sparse_grad_plain(ids: torch.Tensor, grads: torch.Tensor, *,
                            pad_id: int,
                            valid: Optional[torch.Tensor] = None,
                            max_unique: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dedup_sparse_grad`: stable
    ``torch.sort``, boundary flags, ``cumsum``, float32 ``index_add_``."""
    ids, u = _prepare(ids, pad_id, valid, max_unique)
    n, w = grads.shape[0], grads.shape[1]
    sorted_ids, perm = torch.sort(ids, stable=True)
    boundary = torch.ones(n, dtype=torch.bool, device=ids.device)
    boundary[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(boundary, 0) - 1
    keep = seg < u
    sums = torch.zeros((u, w), dtype=torch.float32, device=grads.device)
    sums.index_add_(0, seg[keep], grads[perm[keep]].float())
    uids = torch.full((u,), pad_id, dtype=ids.dtype, device=ids.device)
    first = keep & boundary
    uids[seg[first]] = sorted_ids[first]
    return uids, sums.to(grads.dtype)


def dedup_sparse_grad(ids: torch.Tensor, grads: torch.Tensor, *,
                      pad_id: int, valid: Optional[torch.Tensor] = None,
                      max_unique: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(unique_ids [U], unique_grads [U, w])`` of ``ids [n]``
    (int32/int64) and ``grads [n, w]`` (float32/bfloat16); see the module
    docstring. ``valid`` (``[n]`` bool) turns entries into ``pad_id``
    before the sort. ``max_unique`` bounds the distinct ids, the
    sentinel included; a bound below the true count drops the largest
    ids' rows, as in JAX.

    CPU tensors run :func:`dedup_sparse_grad_plain`; CUDA tensors launch
    the kernel chain (scratch from the caching allocator, sized by n) or
    raise."""
    if ids.device.type == "cpu":
        return dedup_sparse_grad_plain(ids, grads, pad_id=pad_id,
                                       valid=valid, max_unique=max_unique)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids: expected [n] int32/int64, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    n = ids.shape[0]
    if grads.dtype not in _DTYPE_CODE or grads.dim() != 2 \
            or grads.shape[0] != n or grads.device != ids.device:
        raise ValueError(f"grads: expected [{n}, w] float32/bfloat16 on "
                         f"{ids.device}, got {grads.dtype} "
                         f"{tuple(grads.shape)} on {grads.device}")
    if n >= 2 ** 31:
        raise ValueError(f"dedup of {n} ids: at most 2^31 - 1")
    ids, u = _prepare(ids, pad_id, valid, max_unique)
    ids, grads = ids.contiguous(), grads.contiguous()
    w = grads.shape[1]
    uids = torch.empty((u,), dtype=ids.dtype, device=ids.device)
    ugrads = torch.empty((u, w), dtype=grads.dtype, device=grads.device)
    if u == 0:
        return uids, ugrads
    lib = _kernels.library("dedup")
    i64 = int(ids.dtype == torch.int64)
    scratch = torch.empty((lib.detpu_dedup_scratch_bytes(n, w, i64),),
                          dtype=torch.uint8, device=ids.device)
    err = lib.detpu_dedup(
        ids.data_ptr(), i64, n, grads.data_ptr(), _DTYPE_CODE[grads.dtype],
        w, int(pad_id), u, uids.data_ptr(), ugrads.data_ptr(),
        scratch.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream)
    _kernels.check(lib, err, "dedup")
    dedup_sparse_grad.launches += 1
    return uids, ugrads


dedup_sparse_grad.launches = 0
