"""The Adam row update of ``SparseAdam`` on the hand-written kernel K11
(``csrc/adam.cu``), with its plain PyTorch version.

Counterpart of the body of
``distributed_embeddings_tpu/parallel/optimizers.py:SparseAdam.
apply_rows`` after its dedup (``optax.scale_by_adam`` numerics, lazy:
only the given rows move), IN PLACE on the slab and its moments:

    mu_new = b1 * mu + (1 - b1) * g
    nu_new = b2 * nu + (1 - b2) * g * g
    slab  -= (lr * (mu_new / c1)
              / (sqrt(nu_new / c2 + eps_root) + eps)).astype(slab.dtype)

with ``c1 = 1 - b1**t``, ``c2 = 1 - b2**t`` from the slab's float32 step
count ``t`` (the global count: the LazyAdam convention), and JAX's
rounding chain:

* ``g`` and the moments are in the moments' dtype; ``b1``, ``1 - b1``
  (a Python double), ``b2`` and ``1 - b2`` are rounded to it when used,
  and each moment product and sum rounds to it (a bfloat16 chain rounds
  after every op; ``(1 - b2) * g * g`` is ``((1 - b2) * g) * g``);
* the count is float32, so the bias-corrected update promotes to
  float32 (``lr``, ``eps`` and ``eps_root`` with it) and rounds once to
  the slab dtype before the subtraction.

The powers ``b1**t``, ``b2**t`` come from :func:`bias_powers` on the
device in the plain version (``torch.pow``; XLA's ``pow`` may differ
from it by an ulp, so the port is held to JAX within that) and from the
same float32 ``powf`` inside the kernel, which reads the count on the
card; both subtract them from 1 in float32. Every other op of the
kernel is correctly rounded, as PyTorch's elementwise ops are (the
plain version takes the square root in float64 and rounds once:
PyTorch's float32 one on the CPU can be an ulp off), so the kernel
equals its plain version bit for bit.

:func:`adam_rows` takes the dedup output (``ops/sparse_grad.py``:
sorted, negative ids first and the pad tail last) with the index rules
of ``ops/adagrad.py:row_plan`` (ids at or past the rows skipped, a
negative id read at row 0 before the update and written at ``id +
rows``, its delta added before that row's own). The kernel walks only
the live rows, which it finds on the card in the sorted ids. It
launches through the shared launch path (``_kernels.LaunchRecord``): a
record keyed on the layouts, the dtypes and the hyperparameters holds
the constants, rounded once; each call passes seven pointers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .adagrad import _DTYPE_CODE, Lr, add_rows, check_layout, row_plan


def _rnd(x: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype`` (JAX's weak-typed constant)."""
    return float(torch.tensor(float(x), dtype=dtype))


_BASES = {}


def bias_powers(count: torch.Tensor, b1: float, b2: float) -> torch.Tensor:
    """``[b1**t, b2**t]`` (float32, on ``count``'s device) of the step
    count ``t`` (a one-element tensor, already advanced), in one
    launch; the bias corrections are ``1 - `` these. The float32 bases
    are made once per device."""
    key = (count.device, float(b1), float(b2))
    base = _BASES.get(key)
    if base is None:
        base = _BASES[key] = torch.tensor([b1, b2], dtype=torch.float32,
                                          device=count.device)
    return torch.pow(base, count.reshape(1).float())


def _lr_f32(lr: Lr, device) -> torch.Tensor:
    """``lr`` as a float32 one-element tensor on ``device``."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        return lr.reshape(()).to(device=device, dtype=torch.float32)
    return torch.tensor(float(lr), dtype=torch.float32, device=device)


def adam_rows_plain(slab: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                    count: torch.Tensor, uids: torch.Tensor,
                    uvals: torch.Tensor, lr: Lr, b1: float, b2: float,
                    eps: float, eps_root: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`adam_rows`. Returns ``(slab, mu,
    nu)``."""
    dt = mu.dtype
    keep, rd, wr, neg, last = row_plan(uids, slab.shape[0])
    g = uvals[keep].to(dt)

    def c(x):
        return torch.tensor(_rnd(x, dt), dtype=dt, device=mu.device)

    mu_new = c(b1) * mu[rd] + c(1.0 - b1) * g
    nu_new = c(b2) * nu[rd] + c(1.0 - b2) * g * g
    bc = 1.0 - bias_powers(count, b1, b2)
    f32 = torch.float32
    # float64 then one rounding: the correctly rounded float32 square
    # root (PyTorch's float32 one on the CPU can be an ulp off)
    den = torch.sqrt((nu_new.to(f32) / bc[1] + _rnd(eps_root, f32))
                     .double()).float() + _rnd(eps, f32)
    upd = _lr_f32(lr, mu.device) * (mu_new.to(f32) / bc[0]) / den
    mu[wr[last]] = mu_new[last]
    nu[wr[last]] = nu_new[last]
    add_rows(slab, wr, -upd.to(slab.dtype), neg)
    return slab, mu, nu


#: K11's launch records, by layout and constants
_CACHE = _kernels.LaunchCache()


def record_key(slab: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               count: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor,
               lr: Lr, b1: float, b2: float, eps: float, eps_root: float
               ) -> tuple:
    """Every fact K11's launch record rests on: the hyperparameters, the
    constant ``lr`` (or a tensor ``lr``'s layout), and the layouts (shape,
    strides, dtype, device index) of the slab, the moments, the count,
    the ids and the gradient rows. No address: each call passes its own
    (a vector load's alignment is decided on the card side each call)."""
    ts = (slab, mu, nu, count, uids, uvals)
    return (_kernels.layout_key(lr) if isinstance(lr, torch.Tensor) else lr,
            b1, b2, eps, eps_root, *map(_kernels._SHAPE, ts),
            *map(_kernels._STRIDE, ts), *map(_kernels._DTYPE, ts),
            *map(_kernels._DEVICE, ts))


def build_record(slab: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 count: torch.Tensor, uids: torch.Tensor,
                 uvals: torch.Tensor, lr: Lr, b1: float, b2: float,
                 eps: float, eps_root: float, sms: Optional[int] = None
                 ) -> _kernels.LaunchRecord:
    """Validate a call as :func:`adam_rows` does (raising as it does) and
    build its launch record: the constants rounded once (``record.
    payload``: ``(lr_as_is, constants, prepared)``, ``lr_as_is`` false
    where a tensor lr is converted to float32 on the card each call)
    and, for CUDA tensors with ids, the prepared launch bound to the
    library. CPU tensors (the tests) get a record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    check_layout(slab, {"mu": mu, "nu": nu}, uids, uvals)
    if count.numel() != 1 or count.dtype != torch.float32 \
            or count.device != dev:
        raise ValueError(f"count: expected one float32 value on "
                         f"{dev}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    lr_as_is = True
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        lr_as_is = lr.dtype == torch.float32 and lr.device == dev
    dt, f32 = mu.dtype, torch.float32
    consts = {"b1": _rnd(b1, dt), "omb1": _rnd(1.0 - b1, dt),
              "b2": _rnd(b2, dt), "omb2": _rnd(1.0 - b2, dt),
              "pb1": _rnd(b1, f32), "pb2": _rnd(b2, f32),
              "lr": 0.0 if isinstance(lr, torch.Tensor) else _rnd(lr, f32),
              "eps": _rnd(eps, f32), "eps_root": _rnd(eps_root, f32)}
    lib, calls, prepared = None, [], None
    if dev.type == "cuda" and uids.shape[0] > 0:
        lib = _kernels.library("adam")
        prepared = np.zeros(lib.detpu_adam_prepared_bytes(), np.uint8)
        c = consts
        _kernels.check(lib, lib.detpu_adam_prepare(
            _DTYPE_CODE[slab.dtype], _DTYPE_CODE[dt], slab.shape[0],
            slab.shape[1], int(uids.dtype == torch.int64), uids.shape[0],
            c["b1"], c["omb1"], c["b2"], c["omb2"], c["pb1"], c["pb2"],
            c["lr"], int(isinstance(lr, torch.Tensor)), c["eps"],
            c["eps_root"], sms or _kernels.sm_count(dev.index or 0),
            prepared.ctypes.data), "adam_rows")
        calls.append((lib.detpu_adam_launch, (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "adam_rows", calls,
                                 _kernels.device_index(dev),
                                 payload=(lr_as_is, consts, prepared))


def find_record(slab, mu, nu, count, uids, uvals, lr: Lr, b1: float,
                b2: float, eps: float, eps_root: float,
                build_on_cpu: bool = False
                ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_CACHE` by
    :func:`record_key` or built (:func:`build_record`) and kept. A miss
    on CPU tensors is validated and gives None (the wrapper runs the
    plain version) unless ``build_on_cpu``."""
    args = (slab, mu, nu, count, uids, uvals, lr, b1, b2, eps, eps_root)
    return _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                  slab.device.type == "cpu", build_on_cpu,
                                  *args)


def adam_rows(slab: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              count: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor,
              lr: Lr, b1: float, b2: float, eps: float, eps_root: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: the Adam transition of the rows ``uids [U]`` (the dedup's
    output: sorted, each live id once) from their summed gradients
    ``uvals [U, w]`` (in the moments' dtype), in place on ``slab [R, w]``
    and the moments ``mu``, ``nu [R, w]`` (float32/bfloat16, one dtype),
    at the float32 step ``count`` (one element, already advanced for this
    step; read on the device). ``lr`` is a float or a one-element float32
    tensor. Returns ``(slab, mu, nu)``. CPU tensors run
    :func:`adam_rows_plain`; CUDA tensors launch the kernel (through the
    launch record of their layouts: the first call validates and
    prepares, later ones pass the pointers) or raise."""
    if slab.device.type == "cpu":
        return adam_rows_plain(slab, mu, nu, count, uids, uvals, lr, b1, b2,
                               eps, eps_root)
    args = (slab, mu, nu, count, uids, uvals, lr, b1, b2, eps, eps_root)
    rec = _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                 False, False, *args)
    lr_p = None
    if isinstance(lr, torch.Tensor):
        lr_p = (lr if rec.payload[0] else _lr_f32(lr, slab.device)
                ).data_ptr()
    adam_rows.launches += rec.replay(slab.data_ptr(), mu.data_ptr(),
                                     nu.data_ptr(), uids.data_ptr(),
                                     uvals.data_ptr(), count.data_ptr(), lr_p)
    return slab, mu, nu


adam_rows.launches = 0
