"""Sparse SGD row update on the hand-written kernel K3
(``csrc/sgd_scatter.cu``), with its plain PyTorch version.

Counterpart of the scatter in
``distributed_embeddings_tpu/parallel/optimizers.py``
(``_sorted_scatter_add`` under ``SparseSGD.apply_rows``):
``slab.at[ids].add(-lr * vals.astype(slab.dtype), mode="drop")``, here
IN PLACE on the slab. The update's rounding chain is JAX's:

* a constant ``lr`` (a Python number) is rounded to the slab dtype,
  the product ``-lr * vals`` is rounded to it again;
* a device scalar ``lr`` (a float32 tensor, what a callable schedule
  gives) multiplies in float32; it is taken for float32 slabs only. (For
  a bfloat16 slab JAX promotes the whole slab to float32 for that
  scatter and rounds each row's sum once; that chain is ROADMAP B2's
  open item, and such a call raises here);
* every add into the slab rounds to the slab dtype.

Ids index the slab as JAX indexing does: a negative id counts from the
end once (``-1`` is the last row); ids past the slab, or still negative,
are DROPPED. The dropped-row sentinel (``rows_cap``) relies on that.
"""

from __future__ import annotations

from typing import Union

import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Lr = Union[float, torch.Tensor]


def _neg_lr(lr: Lr, dtype: torch.dtype) -> torch.Tensor:
    """``-lr`` as the multiplier of the update: a 0-d tensor in the slab
    dtype for a constant lr, in float32 for a tensor lr."""
    if isinstance(lr, torch.Tensor):
        if dtype != torch.float32:
            raise NotImplementedError(
                "a tensor lr (a callable schedule) into a bfloat16 slab is "
                "not ported yet: ROADMAP B2")
        return -lr.to(torch.float32)
    return torch.tensor(-float(lr), dtype=dtype)


def sgd_scatter_plain(slab: torch.Tensor, ids: torch.Tensor,
                      vals: torch.Tensor, lr: Lr) -> torch.Tensor:
    """Plain PyTorch version of :func:`sgd_scatter`: mask, then
    ``index_add_``. Returns ``slab``."""
    rows = slab.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + rows, ids)
    keep = (ids >= 0) & (ids < rows)
    nl = _neg_lr(lr, slab.dtype).to(slab.device)
    upd = (vals.to(slab.dtype).to(nl.dtype) * nl).to(slab.dtype)
    return slab.index_add_(0, ids[keep], upd[keep])


def sgd_scatter(slab: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                lr: Lr) -> torch.Tensor:
    """K3: ``slab[ids] += round(-lr * round(vals))`` in place, dropping
    out-of-range ids (see the module docstring). Returns ``slab``.

    ``slab [R, w]`` float32/bfloat16 (contiguous), ``ids [n]``
    int32/int64, ``vals [n, w]`` float32/bfloat16 (contiguous), ``lr`` a
    Python number or, for a float32 slab, a one-element float tensor
    (read as float32). A CPU
    slab runs :func:`sgd_scatter_plain`; a CUDA slab launches the kernel
    or raises. Duplicate ids add in an order of the card's choosing.
    """
    if slab.device.type == "cpu":
        return sgd_scatter_plain(slab, ids, vals, lr)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    if slab.dtype not in _DTYPE_CODE or slab.dim() != 2 \
            or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous 2-D float32/bfloat16 "
                         f"tensor, got {slab.dtype} {tuple(slab.shape)}")
    n = ids.shape[0] if ids.dim() == 1 else -1
    w = slab.shape[1]
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64) \
            or ids.device != slab.device or not ids.is_contiguous():
        raise ValueError(f"ids: expected a contiguous [n] int32/int64 "
                         f"tensor on {slab.device}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    if vals.dtype not in _DTYPE_CODE or tuple(vals.shape) != (n, w) \
            or vals.device != slab.device or not vals.is_contiguous():
        raise ValueError(f"vals: expected a contiguous {(n, w)} float32/"
                         f"bfloat16 tensor on {slab.device}, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    nl = _neg_lr(lr, slab.dtype)
    if isinstance(lr, torch.Tensor):
        if nl.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        nl = nl.to(slab.device).contiguous()  # read by the kernel
        neg_lr, nl_ptr = 0.0, nl.data_ptr()
    else:
        neg_lr, nl_ptr = float(nl), None
    if n == 0:
        return slab
    lib = _kernels.library("sgd_scatter")
    err = lib.detpu_sgd_scatter(
        slab.data_ptr(), slab.shape[0], w, _DTYPE_CODE[slab.dtype],
        ids.data_ptr(), int(ids.dtype == torch.int64), n, vals.data_ptr(),
        _DTYPE_CODE[vals.dtype], neg_lr, nl_ptr,
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "sgd_scatter")
    sgd_scatter.launches += 1
    return slab


sgd_scatter.launches = 0
