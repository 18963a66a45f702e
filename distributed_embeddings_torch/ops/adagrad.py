"""The Adagrad row update of ``SparseAdagrad`` on the hand-written
kernels K6 (per unique row) and K7 (elementwise over a slab), both in
``csrc/adagrad.cu``, and on the sorted-segment engine's Adagrad mode (the
whole dense-apply branch in one call, ``csrc/sgd_scatter.cu``), with
their plain PyTorch versions.

Counterpart of the two branches of
``distributed_embeddings_tpu/parallel/optimizers.py:SparseAdagrad.
apply_rows`` (optax ``scale_by_rss`` numerics), IN PLACE on the slab and
its accumulator:

    acc_new = acc + g * g
    slab   -= (lr * g * rsqrt(acc_new + eps)).astype(slab.dtype)

with JAX's rounding chain: ``g``, the accumulator and every
intermediate are in the accumulator dtype (rounded after each operation
when it is bfloat16), a constant ``lr`` and ``eps`` are rounded to it
first, a float32 device ``lr`` (what a callable schedule gives) promotes
the ``lr * g * r`` products to float32, and the update is rounded to the
slab dtype before the subtraction. The kernels' float32 ``rsqrt`` is
correctly rounded; the plain versions take it in float64 and round to
float32 once, which is the same number (PyTorch's own float32 ``rsqrt``
is ``1 / sqrt`` on the CPU and ``rsqrtf`` on the card, within 2 ulps).
XLA's CPU ``rsqrt`` is an approximation, so against the JAX package the
slab rows agree to an ulp of the update, not bit for bit.

:func:`adagrad_rows` takes the dedup output (``ops/sparse_grad.py``:
sorted, each id once) with the index rules of :func:`row_plan`, those
of JAX's ``take(mode="clip")`` reads and ``.at[].set/.add(mode="drop")``
writes: an id at or past the slab's rows (the sentinel, the pad tail)
is skipped; a negative id reads row 0 as it was before the update and
writes row ``id + rows``; when the same stream also holds that row's
own id, the slab row takes both deltas (the negative id's first) and
the state row the row's own transition. K6 walks only the live rows,
which it finds on the card in the SORTED ids (the dedup's signed
order). It launches through the shared launch path
(``_kernels.LaunchRecord``): a record keyed on the layouts, the dtypes,
``eps`` and a constant ``lr`` holds the constants, rounded once; each
call passes five pointers.

:func:`adagrad_dense_scatter` is the dense-apply branch: the scatter-sum
of the stream into a zero gradient slab (K3's chain with lr -1), then K7
over the slab. On the card it is one call of the engine whose epilogue
applies the transition to each hit row where its sum is complete: no
gradient slab, and the rows no id hits are neither read nor written.
Those rows keep their bits under the slab-wide transition too whenever
``g = 0`` is a no-op there, which :func:`untouched_rows_keep_bits`
decides from host constants; ``SparseAdagrad`` runs the slab-wide chain
(a gradient slab, K3, K7) where it is not (``eps = 0`` over a zero
accumulator: JAX turns those elements into NaN).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import _kernels
from .scatter_add import _check_constants, sgd_scatter_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Lr = Union[float, torch.Tensor]


def _transition(a: torch.Tensor, g: torch.Tensor, lr: Lr, eps: float,
                slab_dtype: torch.dtype):
    """``(acc_new, update)`` of elements ``a``, ``g`` (accumulator dtype);
    the update in ``slab_dtype``."""
    dt = a.dtype
    na = a + g * g
    r = torch.rsqrt((na + torch.tensor(eps, dtype=dt, device=a.device))
                    .double()).float().to(dt)
    if isinstance(lr, torch.Tensor):
        u = lr.to(device=a.device, dtype=torch.float32) * g.float() \
            * r.float()
    else:
        u = torch.tensor(lr, dtype=dt, device=a.device) * g * r
    return na, u.to(slab_dtype)


def row_plan(uids: torch.Tensor, rows: int):
    """How JAX's row optimizers index the dedup output ``uids [U]``
    (``take(mode="clip")`` reads, ``.at[uids].set/.add(mode="drop",
    indices_are_sorted=True)`` writes). Returns ``(keep, rd, wr, neg,
    last)``: the mask of the ids that write (below ``rows``, and a
    negative id's wrapped row ``id + rows`` not negative) and, over
    those, the row each reads (0 for a negative id), the row it writes,
    whether it is negative, and whether its state transition is the one
    that stays (a negative id whose wrapped row is also in the stream
    sorts before it, so that row's own set comes later and wins)."""
    uid = uids.long()
    wr = torch.where(uid < 0, uid + rows, uid)
    keep = (uid < rows) & (wr >= 0)
    uid, wr = uid[keep], wr[keep]
    neg = uid < 0
    last = ~(neg & torch.isin(wr, wr[~neg]))
    return keep, uid.clamp(min=0), wr, neg, last


def add_rows(slab: torch.Tensor, wr: torch.Tensor, delta: torch.Tensor,
             neg: torch.Tensor) -> None:
    """``slab[wr] += delta`` in place, each add rounded to the slab
    dtype, the negative ids' deltas first: a row that a negative id and
    its own id both write takes both, in JAX's scatter order."""
    for part in (neg, ~neg):
        rows = wr[part]
        slab[rows] = slab[rows] + delta[part]


def adagrad_rows_plain(slab: torch.Tensor, acc: torch.Tensor,
                       uids: torch.Tensor, ugrads: torch.Tensor, lr: Lr,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`adagrad_rows`. Returns ``(slab,
    acc)``."""
    keep, rd, wr, neg, last = row_plan(uids, slab.shape[0])
    na, upd = _transition(acc[rd], ugrads[keep].to(acc.dtype), lr, eps,
                          slab.dtype)
    acc[wr[last]] = na[last]
    add_rows(slab, wr, -upd, neg)
    return slab, acc


def adagrad_dense_plain(slab: torch.Tensor, acc: torch.Tensor,
                        grad: torch.Tensor, lr: Lr, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`adagrad_dense`. Returns ``(slab,
    acc)``."""
    na, upd = _transition(acc, grad.to(acc.dtype), lr, eps, slab.dtype)
    acc.copy_(na)
    slab.sub_(upd)
    return slab, acc


def _lr_args(lr: Lr, acc_dtype: torch.dtype, device):
    """``(lr as a float rounded to the accumulator dtype, None)`` for a
    constant lr, ``(0.0, float32 one-element tensor on device)`` for a
    tensor lr (the kernel reads it there)."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        return 0.0, lr.to(device=device, dtype=torch.float32).contiguous()
    return float(torch.tensor(float(lr), dtype=acc_dtype)), None


def check_layout(slab: torch.Tensor, state: dict, uids: torch.Tensor,
                 uvals: torch.Tensor, vals_name: str = "uvals") -> None:
    """The layout checks of the row kernels (K6, K11, K12): ``slab`` and
    each tensor of ``state`` (name -> tensor) contiguous, 2-D, float32/
    bfloat16 and on the slab's device, the state tensors in one dtype and
    the slab's shape; ``uids`` a contiguous ``[U]`` int32/int64 tensor
    and ``uvals`` (named ``vals_name`` in the errors) a contiguous
    ``[U, w]`` one in the state's dtype."""
    for name, t in (("slab", slab),) + tuple(state.items()):
        if t.dtype not in _DTYPE_CODE or t.dim() != 2 \
                or not t.is_contiguous() or t.device != slab.device:
            raise ValueError(f"{name}: expected a contiguous 2-D float32/"
                             f"bfloat16 tensor on {slab.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dt = next(iter(state.values())).dtype
    if any(t.shape != slab.shape or t.dtype != dt for t in state.values()):
        raise ValueError(
            " and ".join(f"{k} {t.dtype} {tuple(t.shape)}"
                         for k, t in state.items())
            + f" must share the slab's shape {tuple(slab.shape)} and one "
            "dtype")
    u, w = uids.shape[0], slab.shape[1]
    if uids.dim() != 1 or uids.dtype not in (torch.int32, torch.int64) \
            or uids.device != slab.device or not uids.is_contiguous():
        raise ValueError(f"uids: expected a contiguous [U] int32/int64 "
                         f"tensor on {slab.device}, got {uids.dtype} "
                         f"{tuple(uids.shape)} on {uids.device}")
    if uvals.dtype != dt or tuple(uvals.shape) != (u, w) \
            or uvals.device != slab.device or not uvals.is_contiguous():
        raise ValueError(f"{vals_name}: expected a contiguous {(u, w)} "
                         f"{dt} tensor, got {uvals.dtype} "
                         f"{tuple(uvals.shape)} on {uvals.device}")


#: K6's launch records, by layout and constants
_CACHE = _kernels.LaunchCache()


def record_key(slab: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
               ugrads: torch.Tensor, lr: Lr, eps: float) -> tuple:
    """Every fact K6's launch record rests on: ``eps``, the constant
    ``lr`` (or a tensor ``lr``'s layout), and the layouts (shape,
    strides, dtype, device index) of the slab, the accumulator, the ids
    and the gradient rows. No address: each call passes its own (a
    vector load's alignment is decided on the card side each call)."""
    ts = (slab, acc, uids, ugrads)
    return (_kernels.layout_key(lr) if isinstance(lr, torch.Tensor) else lr,
            eps, *map(_kernels._SHAPE, ts), *map(_kernels._STRIDE, ts),
            *map(_kernels._DTYPE, ts), *map(_kernels._DEVICE, ts))


def build_record(slab: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                 ugrads: torch.Tensor, lr: Lr, eps: float,
                 sms: Optional[int] = None) -> _kernels.LaunchRecord:
    """Validate a call as :func:`adagrad_rows` does (raising as it does)
    and build its launch record: the constants rounded once as
    :func:`_lr_args` rounds them (``record.payload``: ``(lr_as_is,
    constants, prepared)``, ``lr_as_is`` false where a tensor lr is
    converted to float32 on the card each call) and, for CUDA tensors
    with ids, the prepared launch bound to the library. CPU tensors (the
    tests) get a record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    check_layout(slab, {"acc": acc}, uids, ugrads, "ugrads")
    lr_as_is, lr_f = _lr_record(lr, acc, dev)
    consts = {"lr": lr_f, "eps": float(torch.tensor(float(eps),
                                                     dtype=acc.dtype))}
    lib, calls, prepared = None, [], None
    if dev.type == "cuda" and uids.shape[0] > 0:
        lib = _kernels.library("adagrad")
        prepared = np.zeros(lib.detpu_adagrad_prepared_bytes(), np.uint8)
        _kernels.check(lib, lib.detpu_adagrad_prepare(
            _DTYPE_CODE[slab.dtype], _DTYPE_CODE[acc.dtype], slab.shape[0],
            slab.shape[1], int(uids.dtype == torch.int64), uids.shape[0],
            consts["lr"], int(isinstance(lr, torch.Tensor)), consts["eps"],
            sms or _kernels.sm_count(dev.index or 0),
            prepared.ctypes.data), "adagrad_rows")
        calls.append((lib.detpu_adagrad_launch, (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "adagrad_rows", calls,
                                 _kernels.device_index(dev),
                                 payload=(lr_as_is, consts, prepared))


def find_record(slab, acc, uids, ugrads, lr: Lr, eps: float,
                build_on_cpu: bool = False
                ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_CACHE` by
    :func:`record_key` or built (:func:`build_record`) and kept. A miss
    on CPU tensors is validated and gives None (the wrapper runs the
    plain version) unless ``build_on_cpu``."""
    args = (slab, acc, uids, ugrads, lr, eps)
    return _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                  slab.device.type == "cpu", build_on_cpu,
                                  *args)


def adagrad_rows(slab: torch.Tensor, acc: torch.Tensor, uids: torch.Tensor,
                 ugrads: torch.Tensor, lr: Lr, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: the Adagrad transition of the rows ``uids [U]`` (the dedup's
    output: sorted, each live id once) from their summed gradients
    ``ugrads [U, w]`` (in the accumulator dtype), in place on ``slab [R,
    w]`` and ``acc [R, w]`` (float32/bfloat16 each). ``lr`` is a float
    or a one-element tensor (a float32 one on the card is read there).
    Returns ``(slab, acc)``. CPU tensors run :func:`adagrad_rows_plain`;
    CUDA tensors launch the kernel (through the launch record of their
    layouts: the first call validates and prepares, later ones pass the
    pointers) or raise."""
    if slab.device.type == "cpu":
        return adagrad_rows_plain(slab, acc, uids, ugrads, lr, eps)
    args = (slab, acc, uids, ugrads, lr, eps)
    rec = _kernels.find_or_build(_CACHE, record_key(*args), build_record,
                                 False, False, *args)
    adagrad_rows.launches += rec.replay(slab.data_ptr(), acc.data_ptr(),
                                        uids.data_ptr(), ugrads.data_ptr(),
                                        _card_lr_ptr(rec, lr, acc))
    return slab, acc


def _lr_record(lr: Lr, acc: torch.Tensor, dev: torch.device):
    """``(lr_as_is, lr as the kernels take it)`` for a record: a tensor
    lr (one value; 0.0 here, read on the card each call, ``lr_as_is``
    false where it is converted to float32 on the card first) or a
    constant rounded as :func:`_lr_args` rounds it."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a tensor lr must hold one value, got shape "
                             f"{tuple(lr.shape)}")
        return lr.dtype == torch.float32 and lr.device == dev, 0.0
    return True, _lr_args(lr, acc.dtype, dev)[0]


def _card_lr_ptr(rec: _kernels.LaunchRecord, lr: Lr, acc: torch.Tensor):
    """The address of a tensor lr as the record's kernel reads it (a
    float32 copy on the card where the record says it is converted), or
    None for a constant lr."""
    if not isinstance(lr, torch.Tensor):
        return None
    return (lr if rec.payload[0] else _lr_args(
        lr, acc.dtype, acc.device)[1]).data_ptr()


#: K7's launch records, by layout and constants
_DENSE = _kernels.LaunchCache()


def dense_record_key(slab: torch.Tensor, acc: torch.Tensor,
                     grad: torch.Tensor, lr: Lr, eps: float) -> tuple:
    """Every fact K7's launch record rests on: ``eps``, the constant
    ``lr`` (or a tensor ``lr``'s layout) and the layouts of the slab, the
    accumulator and the gradient slab. No address: each call passes its
    own (the 16-byte lanes are decided on the card side each call)."""
    ts = (slab, acc, grad)
    return ("adagrad_dense",
            _kernels.layout_key(lr) if isinstance(lr, torch.Tensor) else lr,
            eps, *map(_kernels._SHAPE, ts), *map(_kernels._STRIDE, ts),
            *map(_kernels._DTYPE, ts), *map(_kernels._DEVICE, ts))


def build_dense_record(slab: torch.Tensor, acc: torch.Tensor,
                       grad: torch.Tensor, lr: Lr,
                       eps: float) -> _kernels.LaunchRecord:
    """Validate a K7 call as :func:`adagrad_dense` does (raising as it
    does) and build its launch record: the constants rounded once
    (``record.payload``: ``(lr_as_is, constants, prepared)``) and, for
    CUDA tensors, the prepared launch. CPU tensors (the tests) get a
    record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("slab", slab), ("acc", acc)):
        if t.dtype not in _DTYPE_CODE or t.dim() != 2 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: expected a contiguous 2-D float32/"
                             f"bfloat16 tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if acc.shape != slab.shape:
        raise ValueError(f"acc {tuple(acc.shape)} != slab "
                         f"{tuple(slab.shape)}")
    if grad.dtype != acc.dtype or grad.shape != acc.shape \
            or grad.device != dev or not grad.is_contiguous():
        raise ValueError(f"grad: expected a contiguous "
                         f"{tuple(acc.shape)} {acc.dtype} tensor, got "
                         f"{grad.dtype} {tuple(grad.shape)} on {grad.device}")
    lr_as_is, lr_f = _lr_record(lr, acc, dev)
    consts = {"lr": lr_f, "eps": float(torch.tensor(float(eps),
                                                     dtype=acc.dtype))}
    lib, calls, prepared = None, [], None
    if dev.type == "cuda" and slab.numel() > 0:
        lib = _kernels.library("adagrad")
        prepared = np.zeros(lib.detpu_adagrad_dense_prepared_bytes(),
                            np.uint8)
        _kernels.check(lib, lib.detpu_adagrad_dense_prepare(
            _DTYPE_CODE[slab.dtype], _DTYPE_CODE[acc.dtype], slab.numel(),
            consts["lr"], int(isinstance(lr, torch.Tensor)), consts["eps"],
            _kernels.sm_count(dev.index or 0), prepared.ctypes.data),
            "adagrad_dense")
        calls.append((lib.detpu_adagrad_dense_launch,
                      (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "adagrad_dense", calls,
                                 _kernels.device_index(dev),
                                 payload=(lr_as_is, consts, prepared))


def find_dense_record(slab, acc, grad, lr: Lr, eps: float,
                      build_on_cpu: bool = False
                      ) -> Optional[_kernels.LaunchRecord]:
    """K7's record of a call, found in :data:`_DENSE` by
    :func:`dense_record_key` or built (:func:`build_dense_record`) and
    kept. A miss on CPU tensors is validated and gives None unless
    ``build_on_cpu``."""
    args = (slab, acc, grad, lr, eps)
    return _kernels.find_or_build(_DENSE, dense_record_key(*args),
                                  build_dense_record,
                                  slab.device.type == "cpu", build_on_cpu,
                                  *args)


def adagrad_dense(slab: torch.Tensor, acc: torch.Tensor, grad: torch.Tensor,
                  lr: Lr, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the Adagrad transition of every element of ``slab [R, w]`` and
    ``acc [R, w]`` from the gradient slab ``grad [R, w]`` (accumulator
    dtype), in place. Returns ``(slab, acc)``. CPU tensors run
    :func:`adagrad_dense_plain`; CUDA tensors launch the kernel (through
    the launch record of their layouts) or raise."""
    if slab.device.type == "cpu":
        return adagrad_dense_plain(slab, acc, grad, lr, eps)
    args = (slab, acc, grad, lr, eps)
    rec = _kernels.find_or_build(_DENSE, dense_record_key(*args),
                                 build_dense_record, False, False, *args)
    adagrad_dense.launches += rec.replay(
        slab.data_ptr(), acc.data_ptr(), grad.data_ptr(),
        _card_lr_ptr(rec, lr, acc))
    return slab, acc


# ------------------------------------- the dense-apply branch on the engine


def _nonneg(x: float) -> bool:
    """``x`` is +0.0 or above (not -0.0, not NaN)."""
    return x > 0 or (x == 0 and math.copysign(1.0, x) > 0)


@functools.lru_cache(maxsize=None)
def _sum_positive(init: float, eps: float, acc_dtype: torch.dtype) -> bool:
    return bool(torch.tensor(init, dtype=acc_dtype)
                + torch.tensor(eps, dtype=acc_dtype) > 0)


def untouched_rows_keep_bits(initial_accumulator_value: float, eps: float,
                             acc_dtype: torch.dtype, lr: Lr) -> bool:
    """Whether the slab-wide Adagrad transition leaves every element with
    ``g = +0`` as it was, so that the dense-apply branch may skip the rows
    no id hits (:func:`adagrad_dense_scatter`) and still give the
    slab-wide chain's bits on every row. From host constants only:

    * the accumulator starts at ``initial_accumulator_value`` (rounded to
      ``acc_dtype``) and only grows, so it must be +0.0 or above (a -0.0
      accumulator would turn into +0.0) and ``rA(init) + rA(eps)`` above
      0, so that ``rsqrt(acc + eps)`` is finite (``eps = 0`` over a zero
      accumulator gives ``0 * inf = NaN``, which JAX writes);
    * a constant lr must be +0.0 or above (a negative one turns a -0.0
      slab element into +0.0). A tensor lr is read on the card only; it
      is taken to be one (a schedule's learning rate).

    A choice between two exact semantics, never a fallback."""
    if not isinstance(lr, torch.Tensor) and not _nonneg(float(lr)):
        return False
    init = float(initial_accumulator_value)
    return _nonneg(init) and _sum_positive(init, float(eps), acc_dtype)


def adagrad_dense_scatter_plain(slab: torch.Tensor, acc: torch.Tensor,
                                ids: torch.Tensor, vals: torch.Tensor,
                                lr: Lr, eps: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`adagrad_dense_scatter`, the JAX
    package's chain: a zero gradient slab in the accumulator dtype, the
    scatter-sum of the stream into it (:func:`~.scatter_add.
    sgd_scatter_plain` with lr -1: stream order on the CPU), then
    :func:`adagrad_dense_plain` over the slab. Returns ``(slab, acc)``."""
    g = torch.zeros(slab.shape, dtype=acc.dtype, device=slab.device)
    sgd_scatter_plain(g, ids, vals, -1.0)
    return adagrad_dense_plain(slab, acc, g, lr, eps)


#: the engine's Adagrad-mode records, by layout and constants
_SCATTER = _kernels.LaunchCache()


def scatter_record_key(slab: torch.Tensor, acc: torch.Tensor,
                       ids: torch.Tensor, vals: torch.Tensor, lr: Lr,
                       eps: float) -> tuple:
    """Every fact the Adagrad-mode record rests on: ``eps``, the constant
    ``lr`` (or a tensor ``lr``'s layout) and the layouts of the slab, the
    accumulator, the ids and the stream rows. No address: each call
    passes its own."""
    ts = (slab, acc, ids, vals)
    return ("adagrad_dense_scatter",
            _kernels.layout_key(lr) if isinstance(lr, torch.Tensor) else lr,
            eps, *map(_kernels._SHAPE, ts), *map(_kernels._STRIDE, ts),
            *map(_kernels._DTYPE, ts), *map(_kernels._DEVICE, ts))


def build_scatter_record(slab: torch.Tensor, acc: torch.Tensor,
                         ids: torch.Tensor, vals: torch.Tensor, lr: Lr,
                         eps: float) -> _kernels.LaunchRecord:
    """Validate an :func:`adagrad_dense_scatter` call (raising as it
    does) and build its launch record: the constants rounded once and,
    for CUDA tensors, the engine's scratch (owned by the record, zeroed
    once: one stream at a time a record) and the prepared launch.
    Payload: ``(lr_as_is, constants, scratch, prepared)``. CPU tensors
    (the tests) get a record without launches."""
    dev = slab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    check_layout(slab, {"acc": acc}, ids, vals, "vals")
    n, w = vals.shape
    if n >= 2 ** 31 or slab.shape[0] >= 2 ** 32:
        raise ValueError(f"adagrad_dense_scatter: {n} ids into "
                         f"{slab.shape[0]} rows; the kernel takes fewer "
                         "than 2^31 ids and 2^32 rows")
    lr_as_is, lr_f = _lr_record(lr, acc, dev)
    consts = {"lr": lr_f, "eps": float(torch.tensor(float(eps),
                                                     dtype=acc.dtype))}
    lib, calls, scratch, prepared = None, [], None, None
    if dev.type == "cuda":
        lib = _kernels.library("sgd_scatter")
        _check_constants(lib, "sgd_scatter")
        scratch = torch.zeros(lib.detpu_sgd_scatter_scratch_bytes(n, w),
                              dtype=torch.uint8, device=dev)
        prepared = np.zeros(lib.detpu_segment_prepared_bytes(), np.uint8)
        _kernels.check(lib, lib.detpu_adagrad_scatter_prepare(
            slab.shape[0], w, _DTYPE_CODE[slab.dtype],
            _DTYPE_CODE[acc.dtype], int(ids.dtype == torch.int64), n,
            consts["lr"], int(isinstance(lr, torch.Tensor)), consts["eps"],
            scratch.data_ptr(), prepared.ctypes.data),
            "adagrad_dense_scatter")
        if n:
            calls.append((lib.detpu_adagrad_scatter_launch,
                          (prepared.ctypes.data,)))
    return _kernels.LaunchRecord(lib, "adagrad_dense_scatter", calls,
                                 _kernels.device_index(dev),
                                 payload=(lr_as_is, consts, scratch,
                                          prepared))


def find_scatter_record(slab, acc, ids, vals, lr: Lr, eps: float,
                        build_on_cpu: bool = False
                        ) -> Optional[_kernels.LaunchRecord]:
    """The Adagrad-mode record of a call, found in :data:`_SCATTER` by
    :func:`scatter_record_key` or built (:func:`build_scatter_record`)
    and kept. A miss on CPU tensors is validated and gives None unless
    ``build_on_cpu``."""
    args = (slab, acc, ids, vals, lr, eps)
    return _kernels.find_or_build(_SCATTER, scatter_record_key(*args),
                                  build_scatter_record,
                                  slab.device.type == "cpu", build_on_cpu,
                                  *args)


def adagrad_dense_scatter(slab: torch.Tensor, acc: torch.Tensor,
                          ids: torch.Tensor, vals: torch.Tensor, lr: Lr,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``SparseAdagrad``'s dense-apply branch, in place on ``slab [R, w]``
    and ``acc [R, w]`` (float32/bfloat16 each): the stream ``ids [n]``
    (int32/int64; K3's index rules: a negative id counts from the end
    once, anything else outside ``[0, R)`` is dropped), ``vals [n, w]``
    in the accumulator dtype, summed by row, then the Adagrad transition
    of each hit row. ``lr`` a float or a one-element tensor (a float32
    one on the card is read there). Returns ``(slab, acc)``.

    CPU tensors run :func:`adagrad_dense_scatter_plain` (the slab-wide
    chain); CUDA tensors launch one engine call (through the launch
    record of their layouts) or raise. On the card rows no id hits are
    not touched: the caller takes this path only where
    :func:`untouched_rows_keep_bits` holds, and every row then has the
    bits of the chain of a zero slab, K3 and K7 on the card."""
    if slab.device.type == "cpu":
        return adagrad_dense_scatter_plain(slab, acc, ids, vals, lr, eps)
    args = (slab, acc, ids, vals, lr, eps)
    rec = _kernels.find_or_build(_SCATTER, scatter_record_key(*args),
                                 build_scatter_record, False, False, *args)
    if rec.calls:
        adagrad_dense_scatter.launches += rec.replay(
            slab.data_ptr(), acc.data_ptr(), ids.data_ptr(),
            vals.data_ptr(), _card_lr_ptr(rec, lr, acc))
    return slab, acc


adagrad_rows.launches = 0
adagrad_dense.launches = 0
adagrad_dense_scatter.launches = 0
