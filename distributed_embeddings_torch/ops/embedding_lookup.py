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


def vector_bytes(slab: torch.Tensor) -> int:
    """K1's lane load for ``slab``: the widest of 16, 8, 4 and 2 bytes
    (at least one element) that divides a row's bytes and the slab's
    address (the output, a fresh allocation, is aligned to more)."""
    es = slab.element_size()
    row = slab.shape[1] * es
    vb = 16
    while vb > es and (row % vb or slab.data_ptr() % vb):
        vb //= 2
    return vb


def _check_device(dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _prepared(lib, what: str) -> np.ndarray:
    """Host memory for one prepared launch of ``what``'s library."""
    size = getattr(lib, f"detpu_{what}_prepared_bytes")()
    return np.zeros(size, np.uint8)


def gather_record_key(slab, ids, rows, roff, div, mask=None,
                      weights=None) -> tuple:
    """Every fact K1's launch record rests on: per slab, ``rows``,
    ``roff``, ``div`` and ``mask`` its address, shape, strides, dtype and
    device (the vector width and the dtype code follow from the slab's),
    and the layouts of ``ids`` (``n``, ``b``, ``hot``) and ``weights``,
    whose addresses are read per call."""
    ts = (slab, rows, roff, div) if mask is None else (slab, rows, roff,
                                                       div, mask)
    return (len(ts), *_kernels.tensor_key(ts), _kernels.layout_key(ids),
            _kernels.layout_key(weights))


def build_gather_record(slab, ids, rows, roff, div, mask=None,
                        weights=None) -> _kernels.LaunchRecord:
    """Validate a K1 call as :func:`gather_combine` always has (raising as
    it did) and build its launch record: for CUDA tensors the prepared
    launch (``csrc/gather_combine.cu``), bound to the library. The
    payload is ``(out shape, out dtype, device, vector bytes, prepared
    launch)``; CPU tensors (the tests) get a record without launches."""
    if ids.dim() != 3:
        raise ValueError(f"ids must be [n, b, hot], got {tuple(ids.shape)}")
    n, b, hot = ids.shape
    dev = slab.device
    _check_device(dev)
    if slab.dtype not in _DTYPE_CODE or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    _expect(ids, (torch.int32, torch.int64), (n, b, hot), dev, "ids")
    _expect(rows, (torch.int64,), (n,), dev, "rows")
    _expect(roff, (torch.int64,), (n,), dev, "roff")
    _expect(div, (torch.float32,), (n,), dev, "div")
    if mask is not None:
        _expect(mask, (torch.int32,), (n,), dev, "mask")
    if weights is not None:
        _expect(weights, (torch.float32,), (n, b, hot), dev, "weights")
    w = slab.shape[1]
    vb = vector_bytes(slab)
    lib, calls, buf = None, [], None
    if dev.type == "cuda":
        lib = _kernels.library("gather_combine")
        buf = _prepared(lib, "gather_combine")
        _kernels.check(lib, lib.detpu_gather_combine_prepare(
            slab.data_ptr(), slab.shape[0], w, int(ids.dtype == torch.int64),
            rows.data_ptr(), roff.data_ptr(), div.data_ptr(),
            None if mask is None else mask.data_ptr(),
            int(weights is not None), n, b, hot, _DTYPE_CODE[slab.dtype],
            vb, buf.ctypes.data), "gather_combine")
        if n * b:
            calls = [(lib.detpu_gather_combine_launch, (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, "gather_combine", calls, _kernels.device_index(dev),
        payload=((n, b, w), slab.dtype, dev, vb, buf))


def find_gather_record(cache: _kernels.LaunchCache, slab, ids, rows, roff,
                       div, mask=None, weights=None,
                       build_on_cpu: bool = False):
    """K1's launch record of a call: found in ``cache`` by
    :func:`gather_record_key`, or built (:func:`build_gather_record`) and
    kept (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, gather_record_key(slab, ids, rows, roff, div, mask, weights),
        build_gather_record, slab.device.type == "cpu", build_on_cpu, slab,
        ids, rows, roff, div, mask, weights)


_GATHER = _kernels.LaunchCache()


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
    the kernel (``csrc/gather_combine.cu``) or raises. The first call
    with a slab, metadata and id layout validates them and builds a
    launch record; a later one only reads the ids', weights' and
    output's addresses and replays it.
    """
    if slab.device.type == "cpu":
        if ids.dim() != 3:
            raise ValueError(f"ids must be [n, b, hot], got "
                             f"{tuple(ids.shape)}")
        return gather_combine_plain(slab, ids, rows, roff, div, mask, weights)
    rec = (_GATHER.get(gather_record_key(slab, ids, rows, roff, div, mask,
                                         weights))
           or find_gather_record(_GATHER, slab, ids, rows, roff, div, mask,
                                 weights))
    shape, dtype, dev = rec.payload[:3]
    out = torch.empty(*shape, dtype=dtype, device=dev)
    gather_combine.launches += rec.replay(
        ids.data_ptr(), None if weights is None else weights.data_ptr(),
        out.data_ptr())
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

#: lengths a block of the lengths -> splits scan covers
#: (``csrc/csr.cu``'s kScanTile)
SCAN_TILE = 4096


def scan_scratch_bytes(n: int, b: int) -> int:
    """The card scratch of a lengths -> splits record: per scan tile an
    int64 aggregate, inclusive prefix and status word, and the 64-bit
    tile counter (``detpu_lengths_to_splits_scratch_bytes``)."""
    tiles = n * max(1, -(-b // SCAN_TILE))
    return tiles * 24 + 8


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


def splits_record_key(lengths, valid=None) -> tuple:
    """Every fact the lengths -> splits record rests on: ``valid``'s
    address, shape, strides, dtype and device, and the layout of
    ``lengths`` (its address is read per call)."""
    return (None if valid is None else _kernels.tensor_key((valid,)),
            _kernels.layout_key(lengths))


def build_splits_record(lengths, valid=None) -> _kernels.LaunchRecord:
    """Validate a lengths -> splits call as :func:`lengths_to_splits`
    always has and build its record: for CUDA tensors the scan's scratch
    (owned by the record, zeroed once: the kernel's tile counter numbers
    the calls, so no call resets it) and the prepared launch. Payload:
    ``(out shape, out dtype, device, scratch, prepared launch)``."""
    if lengths.dim() != 2:
        raise ValueError(f"lengths must be [n, b], got "
                         f"{tuple(lengths.shape)}")
    dev = lengths.device
    _check_device(dev)
    n, b = lengths.shape
    _expect_rows(lengths, _INT, n, dev, "lengths")
    if valid is not None:
        _expect(valid, (torch.int32,), (n,), dev, "valid")
    lib, calls, buf, scratch = None, [], None, None
    if dev.type == "cuda":
        lib = _kernels.library("csr")
        nbytes = scan_scratch_bytes(n, b)
        if lib.detpu_csr_scan_tile() != SCAN_TILE or \
                lib.detpu_lengths_to_splits_scratch_bytes(n, b) != nbytes:
            raise RuntimeError("csrc/csr.cu and ops/embedding_lookup.py "
                               "disagree on the scan's tile or scratch")
        scratch = torch.zeros(-(-nbytes // 8), dtype=torch.int64,
                              device=dev)
        buf = _prepared(lib, "csr")
        _kernels.check(lib, lib.detpu_lengths_to_splits_prepare(
            int(lengths.dtype == torch.int64),
            lengths.stride(0) if n > 1 else b, n, b,
            None if valid is None else valid.data_ptr(),
            scratch.data_ptr(), buf.ctypes.data), "lengths_to_splits")
        if n:
            calls = [(lib.detpu_csr_launch, (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, "lengths_to_splits", calls, _kernels.device_index(dev),
        payload=((n, b + 1), torch.int64, dev, scratch, buf))


def find_splits_record(cache: _kernels.LaunchCache, lengths, valid=None,
                       build_on_cpu: bool = False):
    """The lengths -> splits record of a call, found in ``cache`` by
    :func:`splits_record_key` or built and kept
    (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, splits_record_key(lengths, valid), build_splits_record,
        lengths.device.type == "cpu", build_on_cpu, lengths, valid)


_SPLITS = _kernels.LaunchCache()


def lengths_to_splits(lengths: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: per-slot CSR offsets ``[n, b + 1]`` (int64, starting at 0)
    from row lengths ``[n, b]`` (int32/int64, rows may be a strided view
    into an id block), the ``splits`` half of
    ``parallel/lookup.py:csr_seg``. ``valid`` (``[n]`` int32): a slot
    whose flag is 0 gets zero lengths.

    A CPU tensor runs :func:`lengths_to_splits_plain`; a CUDA tensor
    launches the kernel (``csrc/csr.cu``) or raises, through a launch
    record kept per ``valid`` and lengths layout. The record's scan
    scratch serves one stream at a time, and a CUDA graph that captures
    a call reads it on every replay: keep such a record among the cache's
    last :data:`~._kernels.LAUNCH_CACHE`."""
    if lengths.device.type == "cpu":
        if lengths.dim() != 2:
            raise ValueError(f"lengths must be [n, b], got "
                             f"{tuple(lengths.shape)}")
        return lengths_to_splits_plain(lengths, valid)
    rec = (_SPLITS.get(splits_record_key(lengths, valid))
           or find_splits_record(_SPLITS, lengths, valid))
    shape, dtype, dev = rec.payload[:3]
    splits = torch.empty(*shape, dtype=dtype, device=dev)
    lengths_to_splits.launches += rec.replay(lengths.data_ptr(),
                                             splits.data_ptr())
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


def _check_indices(indices: torch.Tensor) -> None:
    if indices.dim() not in (1, 2) or (indices.dim() == 2
                                       and indices.shape[1] != 2):
        raise ValueError(f"indices must be [nnz] or [nnz, 2], got "
                         f"{tuple(indices.shape)}")


def row_split_record_key(indices, dim_0: int, dtype=None) -> tuple:
    """Every fact the ``row_to_split`` record rests on: the layout of
    ``indices`` (its address is read per call), ``dim_0`` and the output
    dtype."""
    return (_kernels.layout_key(indices), int(dim_0), dtype)


def build_row_split_record(indices, dim_0: int,
                           dtype=None) -> _kernels.LaunchRecord:
    """Validate a ``row_to_split`` call as the wrapper always has and
    build its record (the prepared launch for CUDA tensors). Payload:
    ``(out shape, out dtype, device, prepared launch)``."""
    _check_indices(indices)
    dev = indices.device
    _check_device(dev)
    if indices.dtype not in _INT or not indices.is_contiguous():
        raise ValueError(f"indices: expected a contiguous int32/int64 "
                         f"tensor, got {indices.dtype} strides "
                         f"{indices.stride()}")
    out_dt = indices.dtype if dtype is None else dtype
    if out_dt not in _INT:
        raise ValueError(f"row_to_split: dtype {out_dt} is not int32/int64")
    lib, calls, buf = None, [], None
    if dev.type == "cuda":
        lib = _kernels.library("csr")
        buf = _prepared(lib, "csr")
        _kernels.check(lib, lib.detpu_row_to_split_prepare(
            int(indices.dtype == torch.int64), indices.dim(),
            indices.shape[0], int(dim_0), int(out_dt == torch.int64),
            buf.ctypes.data), "row_to_split")
        calls = [(lib.detpu_csr_launch, (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, "row_to_split", calls, _kernels.device_index(dev),
        payload=((int(dim_0) + 1,), out_dt, dev, buf))


def find_row_split_record(cache: _kernels.LaunchCache, indices, dim_0: int,
                          dtype=None, build_on_cpu: bool = False):
    """The ``row_to_split`` record of a call, found in ``cache`` by
    :func:`row_split_record_key` or built and kept
    (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, row_split_record_key(indices, dim_0, dtype),
        build_row_split_record, indices.device.type == "cpu", build_on_cpu,
        indices, dim_0, dtype)


_ROW_SPLITS = _kernels.LaunchCache()


def row_to_split(indices: torch.Tensor, dim_0: int,
                 dtype=None) -> torch.Tensor:
    """K10: COO row ids (``[nnz, 2]`` indices or ``[nnz]`` rows,
    ascending) -> CSR ``row_splits [dim_0 + 1]``: ``row_splits[t]`` is
    the number of entries whose row is below ``t``, so padding rows
    (``>= dim_0``) fall past the end. ``dtype`` defaults to the rows'.

    A CPU tensor runs :func:`row_to_split_plain`; a CUDA tensor launches
    the kernel (``csrc/csr.cu``) or raises, through a launch record kept
    per indices layout, ``dim_0`` and dtype."""
    if indices.device.type == "cpu":
        _check_indices(indices)
        return row_to_split_plain(indices, dim_0, dtype)
    rec = (_ROW_SPLITS.get(row_split_record_key(indices, dim_0, dtype))
           or find_row_split_record(_ROW_SPLITS, indices, dim_0, dtype))
    shape, out_dt, dev = rec.payload[:3]
    splits = torch.empty(*shape, dtype=out_dt, device=dev)
    row_to_split.launches += rec.replay(indices.data_ptr(),
                                        splits.data_ptr())
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


def row_ids_record_key(row_splits, capacity: int) -> tuple:
    """Every fact the ``ragged_row_ids`` record rests on: the layout of
    the splits (their address is read per call) and the capacity."""
    return (_kernels.layout_key(row_splits), int(capacity))


def build_row_ids_record(row_splits, capacity: int) -> _kernels.LaunchRecord:
    """Validate a ``ragged_row_ids`` call as the wrapper always has and
    build its record (the prepared launch for CUDA tensors). Payload:
    ``(out shape, out dtype, device, prepared launch)``."""
    dev = row_splits.device
    _check_device(dev)
    if row_splits.dtype not in _INT or row_splits.dim() < 1 \
            or not row_splits.is_contiguous():
        raise ValueError(f"row_splits: expected a contiguous int32/int64 "
                         f"tensor, got {row_splits.dtype} "
                         f"{tuple(row_splits.shape)}")
    lead = tuple(row_splits.shape[:-1])
    nrows = row_splits.shape[-1] - 1
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    cap = int(capacity)
    lib, calls, buf = None, [], None
    if dev.type == "cuda":
        lib = _kernels.library("csr")
        buf = _prepared(lib, "csr")
        _kernels.check(lib, lib.detpu_ragged_row_ids_prepare(
            int(row_splits.dtype == torch.int64), n, nrows, cap,
            buf.ctypes.data), "ragged_row_ids")
        if n * cap:
            calls = [(lib.detpu_csr_launch, (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, "ragged_row_ids", calls, _kernels.device_index(dev),
        payload=((*lead, cap), row_splits.dtype, dev, buf))


def find_row_ids_record(cache: _kernels.LaunchCache, row_splits,
                        capacity: int, build_on_cpu: bool = False):
    """The ``ragged_row_ids`` record of a call, found in ``cache`` by
    :func:`row_ids_record_key` or built and kept
    (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, row_ids_record_key(row_splits, capacity),
        build_row_ids_record, row_splits.device.type == "cpu", build_on_cpu,
        row_splits, capacity)


_ROW_IDS = _kernels.LaunchCache()


def ragged_row_ids(row_splits: torch.Tensor, capacity: int) -> torch.Tensor:
    """K10: the row of every value position of a CSR batch:
    ``row_splits [..., nrows + 1]`` -> ``[..., capacity]``, position
    ``p`` getting the number of rows whose end (clipped to
    ``[0, capacity]``) is at or before ``p``; positions past the last
    row get ``nrows``. In the splits' dtype.

    A CPU tensor runs :func:`ragged_row_ids_plain`; a CUDA tensor
    launches the kernel (``csrc/csr.cu``, a fill of each row's positions;
    splits must not decrease) or raises, through a launch record kept per
    splits layout and capacity."""
    if row_splits.device.type == "cpu":
        return ragged_row_ids_plain(row_splits, capacity)
    rec = (_ROW_IDS.get(row_ids_record_key(row_splits, capacity))
           or find_row_ids_record(_ROW_IDS, row_splits, capacity))
    shape, dtype, dev = rec.payload[:3]
    out = torch.empty(*shape, dtype=dtype, device=dev)
    ragged_row_ids.launches += rec.replay(row_splits.data_ptr(),
                                          out.data_ptr())
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


def ragged_record_key(slab, values, splits, rows, roff, mean=None,
                      mask=None, weights=None, out_dtype=None) -> tuple:
    """Every fact K8's launch record rests on: per slab, ``rows``,
    ``roff``, ``mean`` and ``mask`` its address, shape, strides, dtype and
    device (which of the optional two are given leads the key), the
    LAYOUTS of ``values``, ``splits`` and ``weights`` (their addresses are
    read per call) and the output dtype."""
    ts = (slab, rows, roff) if mean is None and mask is None else tuple(
        t for t in (slab, rows, roff, mean, mask) if t is not None)
    return ((mean is not None) + 2 * (mask is not None),
            *_kernels.tensor_key(ts), _kernels.layout_key(values),
            _kernels.layout_key(splits), _kernels.layout_key(weights),
            out_dtype)


def build_ragged_record(slab, values, splits, rows, roff, mean=None,
                        mask=None, weights=None,
                        out_dtype=None) -> _kernels.LaunchRecord:
    """Validate a K8 call as :func:`ragged_combine` always has (raising as
    it did) and build its launch record: for CUDA tensors the prepared
    launch (``csrc/ragged_combine.cu``: the vector width, the source
    words a pass sized from the CTA's shared memory, the grid). Payload:
    ``(out shape, out dtype, device, prepared launch)``; CPU tensors (the
    tests) get a record without launches."""
    if values.dim() != 2 or splits.dim() != 2:
        raise ValueError(f"values must be [n, cap] and splits [n, b + 1], "
                         f"got {tuple(values.shape)}, {tuple(splits.shape)}")
    dev = slab.device
    _check_device(dev)
    if slab.dtype not in _DTYPE_CODE or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    out_dtype = out_dtype or slab.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} is not float32/bfloat16")
    n, cap = values.shape
    b = splits.shape[1] - 1
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
    lib, calls, buf = None, [], None
    if dev.type == "cuda":
        lib = _kernels.library("ragged_combine")
        buf = _prepared(lib, "ragged_combine")
        _kernels.check(lib, lib.detpu_ragged_combine_prepare(
            slab.data_ptr(), slab.shape[0], w, _DTYPE_CODE[slab.dtype],
            int(values.dtype == torch.int64), values.stride(0),
            rows.data_ptr(), roff.data_ptr(),
            None if mean is None else mean.data_ptr(),
            None if mask is None else mask.data_ptr(),
            0 if weights is None else weights.element_size(),
            0 if weights is None else weights.stride(0),
            _DTYPE_CODE[out_dtype], n, b, cap, buf.ctypes.data),
            "ragged_combine")
        if n * b:
            calls = [(lib.detpu_ragged_combine_launch, (buf.ctypes.data,))]
    return _kernels.LaunchRecord(
        lib, "ragged_combine", calls, _kernels.device_index(dev),
        payload=((n, b, w), out_dtype, dev, buf))


def find_ragged_record(cache: _kernels.LaunchCache, slab, values, splits,
                       rows, roff, mean=None, mask=None, weights=None,
                       out_dtype=None, build_on_cpu: bool = False):
    """K8's launch record of a call: found in ``cache`` by
    :func:`ragged_record_key`, or built (:func:`build_ragged_record`) and
    kept (:func:`~._kernels.find_or_build`)."""
    return _kernels.find_or_build(
        cache, ragged_record_key(slab, values, splits, rows, roff, mean,
                                 mask, weights, out_dtype),
        build_ragged_record, slab.device.type == "cpu", build_on_cpu, slab,
        values, splits, rows, roff, mean, mask, weights, out_dtype)


_RAGGED = _kernels.LaunchCache()


def ragged_combine(slab: torch.Tensor, values: torch.Tensor,
                   splits: torch.Tensor, rows: torch.Tensor,
                   roff: torch.Tensor, mean: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
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
    the kernel (``csrc/ragged_combine.cu``) or raises. The first call
    with a slab, slot metadata and per-call layouts validates them and
    builds a launch record; a later one only reads the values', splits',
    weights' and output's addresses and replays it.
    """
    if values.dim() != 2 or splits.dim() != 2:
        raise ValueError(f"values must be [n, cap] and splits [n, b + 1], "
                         f"got {tuple(values.shape)}, {tuple(splits.shape)}")
    if slab.device.type == "cpu":
        return ragged_combine_plain(slab, values, splits, rows, roff, mean,
                                    mask, weights, out_dtype)
    rec = (_RAGGED.get(ragged_record_key(slab, values, splits, rows, roff,
                                         mean, mask, weights, out_dtype))
           or find_ragged_record(_RAGGED, slab, values, splits, rows, roff,
                                 mean, mask, weights, out_dtype))
    shape, dtype, dev = rec.payload[:3]
    out = torch.empty(*shape, dtype=dtype, device=dev)
    ragged_combine.launches += rec.replay(
        values.data_ptr(), splits.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr())
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
