"""Sparse SGD row update on the hand-written kernels K3
(``csrc/sgd_scatter.cu``) and K18 (``csrc/sgd_promoted.cu``), with their
plain PyTorch versions.

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
"""

from __future__ import annotations

from typing import Union

import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Lr = Union[float, torch.Tensor]


def _neg_lr(lr: Lr, dtype: torch.dtype) -> torch.Tensor:
    """``-lr`` as the multiplier of the update: a 0-d tensor in ``dtype``
    (the slab's, or the vals' in the dedup chain) for a constant lr, in
    float32 for a tensor lr."""
    if isinstance(lr, torch.Tensor):
        return -lr.to(torch.float32)
    return torch.tensor(-float(lr), dtype=dtype)


def _promoted(slab: torch.Tensor, lr: Lr, cast_vals: bool) -> bool:
    """Whether the update is JAX's promoted chain (K18)."""
    return (cast_vals and isinstance(lr, torch.Tensor)
            and slab.dtype == torch.bfloat16)


def _keep(ids: torch.Tensor, rows: int):
    """``(rows hit, mask of the kept ids)`` under JAX's indexing."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + rows, ids)
    return ids, (ids >= 0) & (ids < rows)


def sgd_scatter_plain(slab: torch.Tensor, ids: torch.Tensor,
                      vals: torch.Tensor, lr: Lr,
                      cast_vals: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`sgd_scatter`: mask, then
    ``index_add_`` (the promoted chain through
    :func:`sgd_scatter_promoted_plain`). Returns ``slab``."""
    if _promoted(slab, lr, cast_vals):
        return sgd_scatter_promoted_plain(slab, ids, vals, lr)
    ids, keep = _keep(ids, slab.shape[0])
    if cast_vals:
        nl = _neg_lr(lr, slab.dtype).to(slab.device)
        upd = (vals.to(slab.dtype).to(nl.dtype) * nl).to(slab.dtype)
    else:
        nl = _neg_lr(lr, vals.dtype).to(slab.device)
        upd = (nl * vals.to(nl.dtype)).to(slab.dtype)
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
    return n, w


def _device_neg_lr(lr: torch.Tensor, device) -> torch.Tensor:
    """The float32 ``-lr`` the kernels read on the card."""
    if lr.numel() != 1:
        raise ValueError(f"a tensor lr must hold one value, got shape "
                         f"{tuple(lr.shape)}")
    return (-lr.to(torch.float32)).reshape(()).to(device).contiguous()


def sgd_scatter(slab: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                lr: Lr, cast_vals: bool = True) -> torch.Tensor:
    """K3: ``slab[ids] += round(-lr * round(vals))`` in place, dropping
    out-of-range ids (see the module docstring). Returns ``slab``.

    ``slab [R, w]`` float32/bfloat16 (contiguous), ``ids [n]``
    int32/int64, ``vals [n, w]`` float32/bfloat16 (contiguous), ``lr`` a
    Python number or a one-element float tensor (read as float32). A
    bfloat16 slab with a tensor lr takes JAX's promoted chain through
    :func:`sgd_scatter_promoted` (K18; ``cast_vals=False`` stays on K3).
    A CPU slab runs the plain versions; a CUDA slab launches the kernel
    or raises. Duplicate ids add in an order of the card's choosing.
    """
    if _promoted(slab, lr, cast_vals):
        return sgd_scatter_promoted(slab, ids, vals, lr)
    if slab.device.type == "cpu":
        return sgd_scatter_plain(slab, ids, vals, lr, cast_vals)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    n, w = _check_args(slab, ids, vals, _DTYPE_CODE, "sgd_scatter")
    if isinstance(lr, torch.Tensor):
        nl = _device_neg_lr(lr, slab.device)  # read by the kernel
        neg_lr, nl_ptr = 0.0, nl.data_ptr()
    else:
        nl_dtype = slab.dtype if cast_vals else vals.dtype
        neg_lr, nl_ptr = float(_neg_lr(lr, nl_dtype)), None
    if n == 0:
        return slab
    lib = _kernels.library("sgd_scatter")
    err = lib.detpu_sgd_scatter(
        slab.data_ptr(), slab.shape[0], w, _DTYPE_CODE[slab.dtype],
        ids.data_ptr(), int(ids.dtype == torch.int64), n, vals.data_ptr(),
        _DTYPE_CODE[vals.dtype], neg_lr, nl_ptr, int(cast_vals),
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "sgd_scatter")
    sgd_scatter.launches += 1
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
    CUDA slab launches the kernel (a stable sort of (row, position),
    then one warp per distinct row) or raises. Deterministic: the card
    gives the plain version's bits. Returns ``slab``."""
    if not isinstance(lr, torch.Tensor):
        raise TypeError("sgd_scatter_promoted takes a tensor lr (a "
                        "constant lr rounds to the slab dtype: K3's chain)")
    if slab.device.type == "cpu":
        return sgd_scatter_promoted_plain(slab, ids, vals, lr)
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
    n, w = _check_args(slab, ids, vals, (torch.bfloat16,),
                       "sgd_scatter_promoted")
    nl = _device_neg_lr(lr, slab.device)
    if n == 0:
        return slab
    if n >= 2 ** 31:
        raise ValueError(f"sgd_scatter_promoted: {n} ids, at most 2^31 - 1")
    lib = _kernels.library("sgd_promoted")
    rows = slab.shape[0]
    scratch = torch.empty(
        lib.detpu_sgd_promoted_scratch_bytes(n, rows), dtype=torch.uint8,
        device=slab.device)
    err = lib.detpu_sgd_promoted(
        slab.data_ptr(), rows, w, ids.data_ptr(),
        int(ids.dtype == torch.int64), n, vals.data_ptr(),
        _DTYPE_CODE[vals.dtype], nl.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "sgd_scatter_promoted")
    sgd_scatter_promoted.launches += 1
    return slab


sgd_scatter_promoted.launches = 0
