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

:func:`momentum_rows` takes the dedup output (``ops/sparse_grad.py``:
sorted, negative ids first and the pad tail last) with the index rules
of ``ops/adagrad.py:row_plan`` (ids at or past the rows skipped, a
negative id read at row 0 before the update and written at ``id +
rows``, its delta added before that row's own). The kernel walks only
the live rows, which it finds on the card in the sorted ids (the walk K6
and K11 share, ``csrc/row_update.cuh:walk_live_rows``). It launches
through the shared launch path (``_kernels.LaunchRecord``): a record
keyed on the layouts, the dtypes, ``momentum``, Nesterov and a constant
``lr`` holds the constants, rounded once; each call passes five
pointers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .adagrad import _DTYPE_CODE, Lr, add_rows, check_layout, row_plan
from .adam import _lr_f32, _rnd


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


#: K12's launch records, by layout and constants
_CACHE = _kernels.LaunchCache()


def record_key(slab: torch.Tensor, trace: torch.Tensor, uids: torch.Tensor,
               uvals: torch.Tensor, lr: Lr, momentum: float,
               nesterov: bool = False) -> tuple:
    """Every fact K12's launch record rests on: ``momentum``, Nesterov,
    the constant ``lr`` (or a tensor ``lr``'s layout), and the layouts
    (shape, strides, dtype, device index) of the slab, the trace, the ids
    and the gradient rows. No address: each call passes its own (a
    vector load's alignment is decided on the card side each call)."""
    ts = (slab, trace, uids, uvals)
    return (_kernels.layout_key(lr) if isinstance(lr, torch.Tensor) else lr,
            momentum, bool(nesterov), *map(_kernels._SHAPE, ts),
            *map(_kernels._STRIDE, ts), *map(_kernels._DTYPE, ts),
            *map(_kernels._DEVICE, ts))


def build_record(slab: torch.Tensor, trace: torch.Tensor, uids: torch.Tensor,
                 uvals: torch.Tensor, lr: Lr, momentum: float,
                 nesterov: bool = False, sms: Optional[int] = None
                 ) -> _kernels.LaunchRecord:
    """Validate a call as :func:`momentum_rows` does (raising as it does)
    and build its launch record: the constants rounded once to the trace
    dtype as :func:`momentum_rows_plain` rounds them (``record.payload``:
    ``(lr_as_is, constants, prepared)``, ``lr_as_is`` false where a
    tensor lr is converted to float32 on the card each call) and, for
    CUDA tensors with ids, the prepared launch bound to the library. CPU
    tensors (the tests) get a record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    check_layout(slab, {"trace": trace}, uids, uvals)
    dt = trace.dtype
    lr_as_is = True
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        lr_as_is = lr.dtype == torch.float32 and lr.device == dev
    consts = {"m": _rnd(momentum, dt),
              "neg_lr": 0.0 if isinstance(lr, torch.Tensor)
              else _rnd(-float(lr), dt)}
    lib, calls, prepared = None, [], None
    if dev.type == "cuda" and uids.shape[0] > 0:
        lib = _kernels.library("momentum")
        prepared = np.zeros(lib.detpu_momentum_prepared_bytes(), np.uint8)
        _kernels.check(lib, lib.detpu_momentum_prepare(
            _DTYPE_CODE[slab.dtype], _DTYPE_CODE[dt], slab.shape[0],
            slab.shape[1], int(uids.dtype == torch.int64), uids.shape[0],
            consts["m"], int(bool(nesterov)), consts["neg_lr"],
            int(isinstance(lr, torch.Tensor)),
            sms or _kernels.sm_count(dev.index or 0),
            prepared.ctypes.data), "momentum_rows")
        calls.append((lib.detpu_momentum_launch, (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "momentum_rows", calls,
                                 _kernels.device_index(dev),
                                 payload=(lr_as_is, consts, prepared))


def find_record(slab, trace, uids, uvals, lr: Lr, momentum: float,
                nesterov: bool = False, build_on_cpu: bool = False
                ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_CACHE` by
    :func:`record_key` or built (:func:`build_record`) and kept. A miss
    on CPU tensors is validated and gives None (the wrapper runs the
    plain version) unless ``build_on_cpu``."""
    args = (slab, trace, uids, uvals, lr, momentum, nesterov)
    return _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                  slab.device.type == "cpu", build_on_cpu,
                                  *args)


def momentum_rows(slab: torch.Tensor, trace: torch.Tensor,
                  uids: torch.Tensor, uvals: torch.Tensor, lr: Lr,
                  momentum: float, nesterov: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: the momentum transition of the rows ``uids [U]`` (the dedup's
    output: sorted, each live id once) from their summed gradients
    ``uvals [U, w]`` (in the trace dtype), in place on ``slab [R, w]``
    and ``trace [R, w]`` (float32/bfloat16 each). ``lr`` is a float or a
    one-element tensor (a float32 one on the card is read there). Returns
    ``(slab, trace)``. CPU tensors run :func:`momentum_rows_plain`; CUDA
    tensors launch the kernel (through the launch record of their
    layouts: the first call validates and prepares, later ones pass the
    pointers) or raise."""
    if slab.device.type == "cpu":
        return momentum_rows_plain(slab, trace, uids, uvals, lr, momentum,
                                   nesterov)
    args = (slab, trace, uids, uvals, lr, momentum, nesterov)
    rec = _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                 False, False, *args)
    lr_p = None
    if isinstance(lr, torch.Tensor):
        lr_p = (lr if rec.payload[0] else _lr_f32(lr, slab.device)
                ).data_ptr()
    momentum_rows.launches += rec.replay(slab.data_ptr(), trace.data_ptr(),
                                         uids.data_ptr(), uvals.data_ptr(),
                                         lr_p)
    return slab, trace


momentum_rows.launches = 0
