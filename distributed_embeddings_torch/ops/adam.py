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
device, for the kernel and the plain version alike (``torch.pow``;
XLA's ``pow`` may differ from it by an ulp, so the port is held to JAX
within that), and both subtract them from 1 in float32. Every other op
of the kernel is correctly rounded, as PyTorch's elementwise ops are
(the plain version takes the square root in float64 and rounds once:
PyTorch's float32 one on the CPU can be an ulp off), so the kernel
equals its plain version bit for bit.

:func:`adam_rows` takes the dedup output (``ops/sparse_grad.py``) with
the index rules of ``ops/adagrad.py:row_plan`` (ids at or past the rows
skipped, a negative id read at row 0 before the update and written at
``id + rows``, its delta added before that row's own).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from .adagrad import _DTYPE_CODE, Lr, add_rows, row_plan


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


def check_rows(slab: torch.Tensor, state: dict, uids: torch.Tensor,
               uvals: torch.Tensor) -> None:
    """The argument checks of the row kernels (K11, K12): ``slab`` and
    each tensor of ``state`` (name -> tensor) contiguous, 2-D, float32/
    bfloat16 and on one CUDA device, the state tensors in one dtype and
    the slab's shape; ``uids`` a contiguous ``[U]`` int32/int64 tensor
    and ``uvals`` a contiguous ``[U, w]`` one in the state's dtype."""
    if slab.device.type != "cuda":
        raise ValueError(f"unsupported device {slab.device}")
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
        raise ValueError(f"uvals: expected a contiguous {(u, w)} "
                         f"{dt} tensor, got {uvals.dtype} "
                         f"{tuple(uvals.shape)} on {uvals.device}")


def vector_ok(width: int, *tensors: torch.Tensor) -> bool:
    """Whether the row kernels may move 4 elements a load: the width a
    multiple of 4 and every pointer aligned to 4 of its elements."""
    return width % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def adam_rows(slab: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              count: torch.Tensor, uids: torch.Tensor, uvals: torch.Tensor,
              lr: Lr, b1: float, b2: float, eps: float, eps_root: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: the Adam transition of the rows ``uids [U]`` (unique, the
    dedup's output) from their summed gradients ``uvals [U, w]`` (in the
    moments' dtype), in place on ``slab [R, w]`` and the moments ``mu``,
    ``nu [R, w]`` (float32/bfloat16, one dtype), at the float32 step
    ``count`` (one element, already advanced for this step; read on the
    device). ``lr`` is a float or a one-element float32 tensor. Returns
    ``(slab, mu, nu)``. CPU tensors run :func:`adam_rows_plain`; CUDA
    tensors launch the kernel or raise."""
    if slab.device.type == "cpu":
        return adam_rows_plain(slab, mu, nu, count, uids, uvals, lr, b1, b2,
                               eps, eps_root)
    check_rows(slab, {"mu": mu, "nu": nu}, uids, uvals)
    if count.numel() != 1 or count.dtype != torch.float32 \
            or count.device != slab.device:
        raise ValueError(f"count: expected one float32 value on "
                         f"{slab.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    lr_t = None
    if isinstance(lr, torch.Tensor):
        lr_t = _lr_f32(lr, slab.device).contiguous()
    if uids.shape[0] == 0:
        return slab, mu, nu
    dt = mu.dtype
    bp = bias_powers(count, b1, b2)
    f32 = torch.float32
    w = slab.shape[1]
    lib = _kernels.library("adam")
    err = lib.detpu_adam_rows(
        slab.data_ptr(), _DTYPE_CODE[slab.dtype], mu.data_ptr(),
        nu.data_ptr(), _DTYPE_CODE[dt], slab.shape[0], w, uids.data_ptr(),
        int(uids.dtype == torch.int64), uids.shape[0], uvals.data_ptr(),
        _rnd(b1, dt), _rnd(1.0 - b1, dt), _rnd(b2, dt), _rnd(1.0 - b2, dt),
        bp.data_ptr(), 0.0 if lr_t is not None else _rnd(lr, f32),
        None if lr_t is None else lr_t.data_ptr(), _rnd(eps, f32),
        _rnd(eps_root, f32), int(vector_ok(w, slab, mu, nu, uvals)),
        torch.cuda.current_stream(slab.device).cuda_stream)
    _kernels.check(lib, err, "adam_rows")
    adam_rows.launches += 1
    return slab, mu, nu


adam_rows.launches = 0
