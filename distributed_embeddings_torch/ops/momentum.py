"""The momentum row update of ``SparseMomentum`` on the hand-written
kernel K12 (``csrc/momentum.cu``), with its plain PyTorch version.

Counterpart of the body of
``distributed_embeddings_tpu/parallel/optimizers.py:SparseMomentum.
apply_rows`` after its dedup (``optax.trace`` numerics, lazy: only the
given rows move), IN PLACE on the slab and its trace:

    trace_new = g + m * trace
    slab     += (-lr * step).astype(slab.dtype)
    step = trace_new, or with Nesterov g + m * trace_new

with JAX's rounding chain: ``g`` and the trace are in the trace dtype,
``m`` is rounded to it, and every product and sum rounds to it (a
bfloat16 chain rounds after every op). A constant ``lr`` is rounded to
the trace dtype (``-lr * step`` stays in it); a float32 device ``lr``
(what a callable schedule gives) promotes ``-lr * step`` to float32.
The update rounds once to the slab dtype before the add. Every op is
correctly rounded, so the kernel equals its plain version bit for bit.

:func:`momentum_rows` takes the dedup output, with the index rules of
``ops/adagrad.py:row_plan`` (ids at or past the rows skipped, a
negative id read at row 0 before the update and written at ``id +
rows``, its delta added before that row's own).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from .adagrad import Lr, add_rows, row_plan
from .adam import _DTYPE_CODE, _lr_f32, _rnd, check_rows, vector_ok


def momentum_rows_plain(slab: torch.Tensor, trace: torch.Tensor,
                        uids: torch.Tensor, uvals: torch.Tensor, lr: Lr,
                        momentum: float, nesterov: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`momentum_rows`. Returns ``(slab,
    trace)``."""
    dt = trace.dtype
    keep, rd, wr, neg, last = row_plan(uids, slab.shape[0])
    g = uvals[keep].to(dt)
    m = torch.tensor(_rnd(momentum, dt), dtype=dt, device=slab.device)
    t_new = g + m * trace[rd]
    step = g + m * t_new if nesterov else t_new
    if isinstance(lr, torch.Tensor):
        upd = -_lr_f32(lr, slab.device) * step.float()
    else:
        upd = torch.tensor(_rnd(-float(lr), dt), dtype=dt,
                           device=slab.device) * step
    trace[wr[last]] = t_new[last]
    add_rows(slab, wr, upd.to(slab.dtype), neg)
    return slab, trace


def momentum_rows(slab: torch.Tensor, trace: torch.Tensor,
                  uids: torch.Tensor, uvals: torch.Tensor, lr: Lr,
                  momentum: float, nesterov: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: the momentum transition of the rows ``uids [U]`` (unique, the
    dedup's output) from their summed gradients ``uvals [U, w]`` (in the
    trace dtype), in place on ``slab [R, w]`` and ``trace [R, w]``
    (float32/bfloat16 each). ``lr`` is a float or a one-element float32
    tensor. Returns ``(slab, trace)``. CPU tensors run
    :func:`momentum_rows_plain`; CUDA tensors launch the kernel or
    raise."""
    if slab.device.type == "cpu":
        return momentum_rows_plain(slab, trace, uids, uvals, lr, momentum,
                                   nesterov)
    check_rows(slab, {"trace": trace}, uids, uvals)
    u, w = uids.shape[0], slab.shape[1]
    lr_t = None
    if isinstance(lr, torch.Tensor):
        lr_t = _lr_f32(lr, slab.device).contiguous()
    if u == 0:
        return slab, trace
    dt = trace.dtype
    lib = _kernels.library("momentum")
    err = lib.detpu_momentum_rows(
        slab.data_ptr(), _DTYPE_CODE[slab.dtype], trace.data_ptr(),
        _DTYPE_CODE[dt], slab.shape[0], w, uids.data_ptr(),
        int(uids.dtype == torch.int64), u, uvals.data_ptr(),
        _rnd(momentum, dt), int(bool(nesterov)),
        0.0 if lr_t is not None else _rnd(-float(lr), dt),
        None if lr_t is None else lr_t.data_ptr(),
        int(vector_ok(w, slab, trace, uvals)),
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "momentum_rows")
    momentum_rows.launches += 1
    return slab, trace


momentum_rows.launches = 0
