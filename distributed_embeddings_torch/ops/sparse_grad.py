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

``combiner_grad_values`` (the ragged backward, ROADMAP B6) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
