"""Functional embedding lookup (counterpart of
``distributed_embeddings_tpu/ops/embedding_lookup.py``).

The DENSE branch (``combiner=None`` gathers, and ``sum``/``mean`` over a
``[batch, hotness]`` id block with optional per-id weights) runs on the
hand-written gather kernel :func:`gather_combine` (K1,
``csrc/gather_combine.cu``). The :class:`Ragged` branch, and the
:class:`SparseIds` branch through :func:`row_to_split`, run on the CSR
gather-combine :func:`ragged_combine` (K8, ``csrc/ragged_combine.cu``).
The CSR bookkeeping (:func:`row_to_split`, :func:`ragged_row_ids` and
the per-slot :func:`lengths_to_splits`) runs on K10 (``csrc/csr.cu``).

Out-of-range ids CLIP, as the JAX gather's ``mode="clip"`` does: a
negative id reads row 0 and an id past the table its last row
(``torch.index_select`` would raise instead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import _kernels


@dataclasses.dataclass
class Ragged:
    """Static-capacity CSR ragged batch of ids: ``values[k]`` for
    ``k < row_splits[-1]`` are the ids, later positions padding;
    ``row_splits`` has ``batch_size + 1`` entries starting at 0.
    ``weights`` (optional, ``[capacity]`` float) multiply each id's row;
    a ``'mean'`` combiner divides by the row's id COUNT."""

    values: torch.Tensor
    row_splits: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def nrows(self) -> int:
        return self.row_splits.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @classmethod
    def from_lists(cls, rows, capacity: Optional[int] = None,
                   dtype=torch.int32, weights=None) -> "Ragged":
        """Build from a python list of per-row id lists; ``weights``
        takes the same nested-list shape."""
        flat = [i for row in rows for i in row]
        splits = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in rows], out=splits[1:])
        cap = capacity if capacity is not None else max(len(flat), 1)
        if len(flat) > cap:
            raise ValueError(f"total nnz {len(flat)} exceeds capacity {cap}")
        vals = np.zeros(cap, dtype=np.int64)
        vals[: len(flat)] = flat
        warr = None
        if weights is not None:
            wflat = [w for row in weights for w in row]
            if len(wflat) != len(flat):
                raise ValueError("weights must mirror rows' nesting")
            wbuf = np.zeros(cap, dtype=np.float32)
            wbuf[: len(wflat)] = wflat
            warr = torch.from_numpy(wbuf)
        return cls(values=torch.from_numpy(vals).to(dtype),
                   row_splits=torch.from_numpy(splits).to(dtype),
                   weights=warr)


@dataclasses.dataclass
class SparseIds:
    """Static-capacity COO sparse batch of ids: ``indices[k] = (row,
    col)`` with rows ascending; padding rows use ``row >=
    dense_shape[0]``."""

    indices: torch.Tensor
    values: torch.Tensor
    dense_shape: Tuple[int, int]
    weights: Optional[torch.Tensor] = None

    @property
    def nrows(self) -> int:
        return self.dense_shape[0]


IdsLike = Union[torch.Tensor, Ragged, SparseIds]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gather_combine_plain(slab: torch.Tensor, ids: torch.Tensor,
                         rows: torch.Tensor, roff: torch.Tensor,
                         div: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_combine`: the same
    arithmetic (fp32 accumulation, one rounding to the slab dtype)."""
    n = ids.shape[0]
    ids64 = ids.long()
    r = rows.view(n, 1, 1)
    loc = torch.minimum(ids64.clamp(min=0), r - 1)
    grow = (loc + roff.view(n, 1, 1)).clamp(max=slab.shape[0] - 1)
    g = slab[grow].float()  # [n, b, hot, w]
    f = None if weights is None else weights.float()
    if mask is not None:
        inr = ((ids64 >= 0) & (ids64 < r)) | (mask.view(n, 1, 1) == 0)
        f = inr.float() if f is None else f * inr.float()
    if f is not None:
        g = g * f[..., None]
    return (g.sum(2) / div.view(n, 1, 1)).to(slab.dtype)


def gather_combine(slab: torch.Tensor, ids: torch.Tensor,
                   rows: torch.Tensor, roff: torch.Tensor,
                   div: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: per-slot clipped row gather and hotness combine.

    ``slab [R, w]`` (float32 or bfloat16) holds the slots' tables;
    ``ids [n, b, hot]`` (int32/int64) are table-local ids. Slot ``k``
    reads ``slab[clip(id, 0, rows[k]-1) + roff[k]]`` (int64 ``rows``,
    ``roff``), optionally times ``weights [n, b, hot]`` (float32) and
    times 0 where ``mask[k]`` (int32) is set and the id lies outside
    ``[0, rows[k])``, sums over ``hot`` in fp32, divides by ``div[k]``
    (float32; ``hot`` for mean slots) and returns ``[n, b, w]`` in the
    slab's dtype.

    A CPU slab runs :func:`gather_combine_plain`; a CUDA slab launches
    the kernel (``csrc/gather_combine.cu``) or raises.
    """
    if ids.dim() != 3:
        raise ValueError(f"ids must be [n, b, hot], got {tuple(ids.shape)}")
    n, b, hot = ids.shape
    if slab.device.type == "cpu":
        return gather_combine_plain(slab, ids, rows, roff, div, mask, weights)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    if slab.dtype not in _DTYPE_CODE or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    _expect(ids, (torch.int32, torch.int64), (n, b, hot), slab.device, "ids")
    _expect(rows, (torch.int64,), (n,), slab.device, "rows")
    _expect(roff, (torch.int64,), (n,), slab.device, "roff")
    _expect(div, (torch.float32,), (n,), slab.device, "div")
    if mask is not None:
        _expect(mask, (torch.int32,), (n,), slab.device, "mask")
    if weights is not None:
        _expect(weights, (torch.float32,), (n, b, hot), slab.device,
                "weights")
    w = slab.shape[1]
    out = torch.empty((n, b, w), dtype=slab.dtype, device=slab.device)
    if n * b == 0:
        return out
    lib = _kernels.library("gather_combine")
    err = lib.detpu_gather_combine(
        slab.data_ptr(), slab.shape[0], w, ids.data_ptr(),
        int(ids.dtype == torch.int64), rows.data_ptr(), roff.data_ptr(),
        div.data_ptr(), None if mask is None else mask.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        n, b, hot, _DTYPE_CODE[slab.dtype],
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "gather_combine")
    gather_combine.launches += 1
    return out


gather_combine.launches = 0


def _expect(t: torch.Tensor, dtypes, shape, device, what: str) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {shape} tensor of "
            f"{[str(d) for d in dtypes]} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def _expect_rows(t: torch.Tensor, dtypes, n: int, device,
                 what: str) -> None:
    """``t`` is ``[n, k]`` of one of ``dtypes`` on ``device`` with unit
    element stride (rows may be strided: a view into an id block)."""
    if t.dtype not in dtypes or t.dim() != 2 or t.shape[0] != n \
            or t.device != device or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(
            f"{what}: expected an [{n}, k] tensor of unit element stride "
            f"of {[str(d) for d in dtypes]} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


_INT = (torch.int32, torch.int64)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ K10: CSR


def lengths_to_splits_plain(lengths: torch.Tensor,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of :func:`lengths_to_splits`."""
    n, b = lengths.shape
    ln = lengths.long()
    if valid is not None:
        ln = ln * (valid != 0).long()[:, None]
    splits = torch.zeros((n, b + 1), dtype=torch.int64,
                         device=lengths.device)
    torch.cumsum(ln, dim=1, out=splits[:, 1:])
    return splits


def lengths_to_splits(lengths: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: per-slot CSR offsets ``[n, b + 1]`` (int64, starting at 0)
    from row lengths ``[n, b]`` (int32/int64, rows may be a strided view
    into an id block), the ``splits`` half of
    ``parallel/lookup.py:csr_seg``. ``valid`` (``[n]`` int32): a slot
    whose flag is 0 gets zero lengths.

    A CPU tensor runs :func:`lengths_to_splits_plain`; a CUDA tensor
    launches the kernel (``csrc/csr.cu``) or raises."""
    if lengths.dim() != 2:
        raise ValueError(f"lengths must be [n, b], got "
                         f"{tuple(lengths.shape)}")
    if lengths.device.type == "cpu":
        return lengths_to_splits_plain(lengths, valid)
    if lengths.device.type != "cuda":
        raise ValueError(f"unsupported device {lengths.device}")
    n, b = lengths.shape
    _expect_rows(lengths, _INT, n, lengths.device, "lengths")
    if valid is not None:
        _expect(valid, (torch.int32,), (n,), lengths.device, "valid")
    splits = torch.empty((n, b + 1), dtype=torch.int64,
                         device=lengths.device)
    if n == 0:
        return splits
    lib = _kernels.library("csr")
    err = lib.detpu_lengths_to_splits(
        lengths.data_ptr(), int(lengths.dtype == torch.int64),
        lengths.stride(0) if n > 1 else b, n, b,
        None if valid is None else valid.data_ptr(), splits.data_ptr(),
        _stream(lengths))
    _kernels.check(lib, err, "lengths_to_splits")
    lengths_to_splits.launches += 1
    return splits


lengths_to_splits.launches = 0


def row_to_split_plain(indices: torch.Tensor, dim_0: int,
                       dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_to_split`
    (``torch.searchsorted``)."""
    rows = (indices[:, 0] if indices.dim() == 2 else indices).contiguous()
    targets = torch.arange(dim_0 + 1, dtype=rows.dtype, device=rows.device)
    out = torch.searchsorted(rows, targets, side="left")
    return out.to(rows.dtype if dtype is None else dtype)


def row_to_split(indices: torch.Tensor, dim_0: int,
                 dtype=None) -> torch.Tensor:
    """K10: COO row ids (``[nnz, 2]`` indices or ``[nnz]`` rows,
    ascending) -> CSR ``row_splits [dim_0 + 1]``: ``row_splits[t]`` is
    the number of entries whose row is below ``t``, so padding rows
    (``>= dim_0``) fall past the end. ``dtype`` defaults to the rows'.

    A CPU tensor runs :func:`row_to_split_plain`; a CUDA tensor launches
    the kernel (``csrc/csr.cu``) or raises."""
    if indices.dim() not in (1, 2) or (indices.dim() == 2
                                       and indices.shape[1] != 2):
        raise ValueError(f"indices must be [nnz] or [nnz, 2], got "
                         f"{tuple(indices.shape)}")
    if indices.device.type == "cpu":
        return row_to_split_plain(indices, dim_0, dtype)
    if indices.device.type != "cuda":
        raise ValueError(f"unsupported device {indices.device}")
    if indices.dtype not in _INT or not indices.is_contiguous():
        raise ValueError(f"indices: expected a contiguous int32/int64 "
                         f"tensor, got {indices.dtype} strides "
                         f"{indices.stride()}")
    out_dt = indices.dtype if dtype is None else dtype
    if out_dt not in _INT:
        raise ValueError(f"row_to_split: dtype {out_dt} is not int32/int64")
    splits = torch.empty((int(dim_0) + 1,), dtype=out_dt,
                         device=indices.device)
    lib = _kernels.library("csr")
    err = lib.detpu_row_to_split(
        indices.data_ptr(), int(indices.dtype == torch.int64),
        indices.dim(), indices.shape[0], int(dim_0), splits.data_ptr(),
        int(out_dt == torch.int64), _stream(indices))
    _kernels.check(lib, err, "row_to_split")
    row_to_split.launches += 1
    return splits


row_to_split.launches = 0


def ragged_row_ids_plain(row_splits: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ragged_row_ids`: the JAX marks +
    cumsum form, over any leading dims."""
    lead = row_splits.shape[:-1]
    sp = row_splits.reshape(-1, row_splits.shape[-1])
    ends = sp[:, 1:].long().clamp(0, capacity)
    marks = torch.zeros((sp.shape[0], capacity + 1), dtype=torch.int64,
                        device=sp.device)
    marks.scatter_add_(1, ends, torch.ones_like(ends))
    seg = torch.cumsum(marks[:, :capacity], dim=1).to(row_splits.dtype)
    return seg.reshape(*lead, capacity)


def ragged_row_ids(row_splits: torch.Tensor, capacity: int) -> torch.Tensor:
    """K10: the row of every value position of a CSR batch:
    ``row_splits [..., nrows + 1]`` -> ``[..., capacity]``, position
    ``p`` getting the number of rows whose end (clipped to
    ``[0, capacity]``) is at or before ``p``; positions past the last
    row get ``nrows``. In the splits' dtype.

    A CPU tensor runs :func:`ragged_row_ids_plain`; a CUDA tensor
    launches the kernel (``csrc/csr.cu``, one binary search per
    position; splits must not decrease) or raises."""
    if row_splits.device.type == "cpu":
        return ragged_row_ids_plain(row_splits, capacity)
    if row_splits.device.type != "cuda":
        raise ValueError(f"unsupported device {row_splits.device}")
    if row_splits.dtype not in _INT or row_splits.dim() < 1 \
            or not row_splits.is_contiguous():
        raise ValueError(f"row_splits: expected a contiguous int32/int64 "
                         f"tensor, got {row_splits.dtype} "
                         f"{tuple(row_splits.shape)}")
    lead = row_splits.shape[:-1]
    nrows = row_splits.shape[-1] - 1
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = torch.empty((*lead, int(capacity)), dtype=row_splits.dtype,
                      device=row_splits.device)
    lib = _kernels.library("csr")
    err = lib.detpu_ragged_row_ids(
        row_splits.data_ptr(), int(row_splits.dtype == torch.int64), n,
        nrows, int(capacity), out.data_ptr(), _stream(row_splits))
    _kernels.check(lib, err, "ragged_row_ids")
    ragged_row_ids.launches += 1
    return out


ragged_row_ids.launches = 0


# ----------------------------------------------- K8: ragged gather-combine


def _rnd(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` (and back to float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def weight_floats(weights: torch.Tensor) -> torch.Tensor:
    """Per-id weights as float32: float32 as they are, int32 bits
    reinterpreted, int64 elements by their low 32 bits (the form the
    weights take inside an int64 id block)."""
    if weights.dtype == torch.int64:
        weights = weights.to(torch.int32)
    if weights.dtype == torch.int32:
        return weights.view(torch.float32)
    return weights.float()


def _row_bounds(splits: torch.Tensor, cap: int):
    """Each row's first and past-the-last position, as the kernels walk
    them: ``[min(splits[r], cap), min(splits[r + 1], cap))``, the first
    row starting at 0 (the positions the JAX segment ids give it)."""
    start = splits[:, :-1].clamp(0, cap)
    start[:, 0] = 0
    end = torch.maximum(splits[:, 1:].clamp(max=cap), start)
    return start, end


def ragged_combine_plain(slab: torch.Tensor, values: torch.Tensor,
                         splits: torch.Tensor, rows: torch.Tensor,
                         roff: torch.Tensor,
                         mean: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`ragged_combine`, with the same
    arithmetic in the same order: one pass per position of the longest
    row, adding in float32 in position order."""
    n, cap = values.shape
    b = splits.shape[1] - 1
    w = slab.shape[1]
    dt = slab.dtype
    start, end = _row_bounds(splits, cap)
    count = _rnd((splits[:, 1:] - splits[:, :-1]).clamp(min=1).float(), dt)
    ids = values.long()
    r = rows.view(n, 1)
    wf = None if weights is None else _rnd(weight_floats(weights), dt)
    acc = torch.zeros((n, b, w), dtype=torch.float32, device=slab.device)
    longest = int((end - start).max()) if n * b else 0
    for j in range(longest):
        live = (start + j) < end
        p = (start + j).clamp(max=max(cap - 1, 0))
        idj = ids.gather(1, p)
        loc = torch.minimum(idj.clamp(min=0), r - 1)
        grow = (loc + roff.view(n, 1)).clamp(max=slab.shape[0] - 1)
        x = slab[grow].float()
        if wf is not None:
            x = _rnd(x * wf.gather(1, p)[..., None], dt)
        if mask is not None:
            inr = ((idj >= 0) & (idj < r)) | (mask.view(n, 1) == 0)
            x = x * inr.float()[..., None]
        acc = torch.where(live[..., None], acc + x, acc)
    out = _rnd(acc, dt)
    if mean is not None:
        out = torch.where((mean != 0).view(n, 1, 1),
                          _rnd(out / count[..., None], dt), out)
    return out.to(dt).to(out_dtype or dt)


def ragged_combine(slab: torch.Tensor, values: torch.Tensor,
                   splits: torch.Tensor, rows: torch.Tensor,
                   roff: torch.Tensor, mean: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
    """K8: per-slot CSR gather and combine.

    ``slab [R, w]`` (float32/bfloat16) holds the slots' tables;
    ``values [n, cap]`` (int32/int64) the table-local ids of each slot's
    CSR batch and ``splits [n, b + 1]`` (int64) its row offsets. Row
    ``r`` of slot ``k`` sums, over positions ``p`` in
    ``[min(splits[r], cap), min(splits[r + 1], cap))``,
    ``slab[clip(values[p], 0, rows[k] - 1) + roff[k]]`` times
    ``weights[k, p]`` (float32, or the float32 bits in an int32/int64
    id block) rounded to the slab dtype, times 0 where ``mask[k]``
    (int32) is set and the id lies outside ``[0, rows[k])``. The sum is
    taken in float32 in position order and rounded to the slab dtype;
    where ``mean[k]`` (int32) is set it is divided by
    ``max(splits[r + 1] - splits[r], 1)`` (the claimed length, rounded to
    the slab dtype). Returns ``[n, b, w]`` in ``out_dtype`` (default: the
    slab's). ``values`` and ``weights`` may be strided row views.

    A CPU slab runs :func:`ragged_combine_plain`; a CUDA slab launches
    the kernel (``csrc/ragged_combine.cu``) or raises.
    """
    if values.dim() != 2 or splits.dim() != 2:
        raise ValueError(f"values must be [n, cap] and splits [n, b + 1], "
                         f"got {tuple(values.shape)}, {tuple(splits.shape)}")
    if slab.device.type == "cpu":
        return ragged_combine_plain(slab, values, splits, rows, roff, mean,
                                    mask, weights, out_dtype)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    if slab.dtype not in _DTYPE_CODE or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    out_dtype = out_dtype or slab.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} is not float32/bfloat16")
    n, cap = values.shape
    b = splits.shape[1] - 1
    dev = slab.device
    _expect_rows(values, _INT, n, dev, "values")
    _expect(splits, (torch.int64,), (n, b + 1), dev, "splits")
    _expect(rows, (torch.int64,), (n,), dev, "rows")
    _expect(roff, (torch.int64,), (n,), dev, "roff")
    for t, what in ((mean, "mean"), (mask, "mask")):
        if t is not None:
            _expect(t, (torch.int32,), (n,), dev, what)
    if weights is not None:
        _expect_rows(weights, (torch.float32,) + _INT, n, dev, "weights")
        if weights.shape[1] < cap:
            raise ValueError(f"weights: {weights.shape[1]} per slot for a "
                             f"capacity of {cap}")
    w = slab.shape[1]
    out = torch.empty((n, b, w), dtype=out_dtype, device=dev)
    if n * b == 0:
        return out
    lib = _kernels.library("ragged_combine")
    err = lib.detpu_ragged_combine(
        slab.data_ptr(), slab.shape[0], w, _DTYPE_CODE[slab.dtype],
        values.data_ptr(), int(values.dtype == torch.int64),
        values.stride(0), splits.data_ptr(), rows.data_ptr(),
        roff.data_ptr(), None if mean is None else mean.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if weights is None else weights.data_ptr(),
        0 if weights is None else weights.element_size(),
        0 if weights is None else weights.stride(0), out.data_ptr(),
        _DTYPE_CODE[out_dtype], n, b, cap, _stream(slab))
    _kernels.check(lib, err, "ragged_combine")
    ragged_combine.launches += 1
    return out


ragged_combine.launches = 0


def embedding_lookup(params: torch.Tensor, ids: IdsLike,
                     combiner: Optional[str] = None,
                     weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Look up (and optionally reduce) rows of ``params [vocab, w]``.

    * ``combiner=None``: gather, output ``ids.shape + (w,)``;
    * ``[batch, hotness]`` ids + ``'sum'``/``'mean'``: reduce over the
      hotness, with optional ``weights [batch, hotness]`` multiplying
      each id's row (cast to the table dtype first, as the JAX package
      does); ``'mean'`` divides by the hotness;
    * :class:`Ragged` + combiner: the CSR lookup-reduce (K8), weights
      from ``weights`` or the batch's own; ``'mean'`` divides by each
      row's id count (1 for an empty row, whose result is 0);
    * :class:`SparseIds` + combiner: converted to CSR by
      :func:`row_to_split` (K10), then as :class:`Ragged`.
    """
    if combiner not in (None, "sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner!r}")
    if isinstance(ids, (Ragged, SparseIds)):
        return _ragged_lookup(params, ids, combiner, weights)
    dev = params.device
    vocab, w = params.shape
    if combiner is None:
        flat = ids.reshape(1, -1, 1).contiguous()
        out = gather_combine(params, flat, *_slot_meta(vocab, 1, dev))
        return out.reshape(*ids.shape, w)
    if ids.dim() != 2:
        raise ValueError("Only 2D dense input is supported with a "
                         f"combiner, got {ids.dim()}D")
    hot = ids.shape[1]
    wts = None
    if weights is not None:
        wts = (weights.to(params.dtype).float()
               .reshape(1, *ids.shape).contiguous())
    div = hot if combiner == "mean" else 1
    out = gather_combine(params, ids.reshape(1, *ids.shape).contiguous(),
                         *_slot_meta(vocab, div, dev), weights=wts)
    return out[0]


def _ragged_lookup(params, ids, combiner, weights):
    """The :class:`Ragged` / :class:`SparseIds` branch of
    :func:`embedding_lookup`: ``[nrows, w]`` in the table's dtype."""
    if combiner is None:
        raise ValueError("combiner=None requires dense ids")
    dev = params.device
    if weights is None:
        weights = ids.weights
    values = torch.as_tensor(ids.values).to(dev)
    if isinstance(ids, SparseIds):
        splits = row_to_split(torch.as_tensor(ids.indices).to(dev),
                              ids.dense_shape[0], dtype=values.dtype)
    else:
        splits = torch.as_tensor(ids.row_splits).to(dev)
    vocab = params.shape[0]
    rows, roff, _ = _slot_meta(vocab, 1, dev)
    mean = torch.full((1,), int(combiner == "mean"), dtype=torch.int32,
                      device=dev)
    wts = (None if weights is None else
           torch.as_tensor(weights).to(dev).float().reshape(1, -1))
    out = ragged_combine(params, values.reshape(1, -1),
                         splits.long().reshape(1, -1), rows, roff,
                         mean=mean, weights=wts)
    return out[0]


def _slot_meta(vocab: int, div: int, dev):
    """``(rows, roff, div)`` of a one-slot lookup over a whole table."""
    return (torch.full((1,), vocab, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.full((1,), float(div), dtype=torch.float32, device=dev))
