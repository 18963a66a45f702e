"""Functional embedding lookup (counterpart of
``distributed_embeddings_tpu/ops/embedding_lookup.py``).

This slice carries the DENSE branch: ``combiner=None`` gathers, and
``sum``/``mean`` over a ``[batch, hotness]`` id block with optional
per-id weights, all on the hand-written gather kernel
:func:`gather_combine` (K1, ``csrc/gather_combine.cu``). The
:class:`Ragged` and :class:`SparseIds` containers are ported; lookups
over them (the CSR gather-combine) are ROADMAP queue B5 and raise here.

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

_RAGGED_TODO = ("ragged / sparse lookups (the CSR gather-combine) are not "
                "ported yet: ROADMAP queue B5")


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


def embedding_lookup(params: torch.Tensor, ids: IdsLike,
                     combiner: Optional[str] = None,
                     weights: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Look up (and optionally reduce) rows of ``params [vocab, w]``.

    * ``combiner=None``: gather, output ``ids.shape + (w,)``;
    * ``[batch, hotness]`` ids + ``'sum'``/``'mean'``: reduce over the
      hotness, with optional ``weights [batch, hotness]`` multiplying
      each id's row (cast to the table dtype first, as the JAX package
      does); ``'mean'`` divides by the hotness.
    """
    if combiner not in (None, "sum", "mean"):
        raise ValueError(f"Unsupported combiner {combiner!r}")
    if isinstance(ids, (Ragged, SparseIds)):
        raise NotImplementedError(_RAGGED_TODO)
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


def _slot_meta(vocab: int, div: int, dev):
    """``(rows, roff, div)`` of a one-slot lookup over a whole table."""
    return (torch.full((1,), vocab, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.full((1,), float(div), dtype=torch.float32, device=dev))
