"""The dense optimizer update of the train step on the hand-written kernel
K22 (``csrc/dense_update.cu``), with its plain PyTorch version.

Counterpart of ``distributed_embeddings_tpu/parallel/trainer.py:
_apply_dense_and_assemble``: optax's ``update`` and ``apply_updates``
over every dense parameter (``optax.sgd`` plain, with momentum or
Nesterov, ``optax.adagrad``, ``optax.adam``), then the non-finite
guard's ``where(ok, new, old)``. One call updates every parameter and
its optimizer state IN PLACE, each by the chain of
``parallel/optimizers.py``'s ``update`` followed by ``p + u``:

* ``"sgd"``: ``u = g * nlr``;
* ``"momentum"`` / ``"nesterov"``: ``t = g + m * t``, ``u = t * nlr`` /
  ``u = (g + m * t) * nlr``;
* ``"adagrad"``: ``s = g * g + s``, ``u = where(s > 0, rsqrt(s + eps),
  0) * g * nlr``;
* ``"adam"``: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * (g * g)
  + b2 * nu``, ``u = (mu / (1 - bp[0])) / (sqrt(nu / (1 - bp[1]) +
  eps_root) + eps) * nlr``;

then ``p = p + u``. ``nlr`` is ``-lr``: a Python float (rounded to
float32, as ``u * -lr`` rounds it) or a 0-d float32 tensor on the card (a
schedule's ``-lr(count)``); ``bp`` is ``[b1**t, b2**t]`` of the advanced
Adam count (``ops/adam.py:bias_powers``), read on the card. The square
root and its reciprocal are taken in float64 and rounded once (the
kernel's correctly rounded float32 ones), so the kernel equals the plain
version bit for bit.

``ok`` (a 0-d bool tensor, never read on the host): when false nothing
is written. ``counts`` (0-d int32 tensors: Adam's count, a schedule's
count) advance by ``ok`` (by 1 without it).

A CPU parameter list runs :func:`dense_update_plain`; CUDA tensors
launch the kernel (float32 only; any other dtype raises, nothing is
converted) or raise. The wrapper counts its launches.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import _kernels

KINDS = {"sgd": 0, "momentum": 1, "nesterov": 2, "adagrad": 3, "adam": 4}
#: the state lists each kind updates (s0, s1)
_N_STATE = {"sgd": 0, "momentum": 1, "nesterov": 1, "adagrad": 1, "adam": 2}

Nlr = Union[float, torch.Tensor]


def _f32(x: float) -> float:
    return float(np.float32(x))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (float64, rounded once)."""
    return torch.sqrt(x.double()).float()


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``rsqrt`` as the row kernels' plain versions take it
    (float64, rounded once)."""
    return torch.rsqrt(x.double()).float()


def dense_update_plain(kind: str, params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       s0: Optional[Sequence[torch.Tensor]], s1, nlr: Nlr,
                       hyper: Dict[str, float],
                       bp: Optional[torch.Tensor] = None,
                       ok: Optional[torch.Tensor] = None,
                       counts: Sequence[torch.Tensor] = ()) -> None:
    """Plain PyTorch version of :func:`dense_update` (in place)."""
    with torch.no_grad():
        if kind == "adam":
            bc = 1.0 - bp
        for i, (p, g) in enumerate(zip(params, grads)):
            new_s = []
            if kind == "sgd":
                step = g
            elif kind in ("momentum", "nesterov"):
                m = hyper["momentum"]
                t = g + m * s0[i]
                step = g + m * t if kind == "nesterov" else t
                new_s = [t]
            elif kind == "adagrad":
                acc = g * g + s0[i]
                step = torch.where(acc > 0, rsqrt_f32(acc + hyper["eps"]),
                                   0.0) * g
                new_s = [acc]
            else:
                b1, b2 = hyper["b1"], hyper["b2"]
                mu = (1 - b1) * g + b1 * s0[i]
                nu = (1 - b2) * (g * g) + b2 * s1[i]
                step = (mu / bc[0]) / (sqrt_f32(nu / bc[1]
                                                 + hyper["eps_root"])
                                       + hyper["eps"])
                new_s = [mu, nu]
            u = (step * nlr if not isinstance(nlr, torch.Tensor)
                 else nlr.to(step.dtype) * step)
            new = p + u
            for dst, src in zip([p] + [s[i] for s in (s0, s1)[:len(new_s)]],
                                [new] + new_s):
                dst.copy_(src if ok is None else torch.where(ok, src, dst))
        for c in counts:
            c.add_(1 if ok is None else ok.to(c.dtype))


@functools.lru_cache(maxsize=None)
def _limits():
    lib = _kernels.library("dense_update")
    return lib.detpu_dense_update_max_tensors(), lib.detpu_dense_update_tile()


def _check(t: torch.Tensor, dev, what: str) -> None:
    if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 tensor on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def dense_update(kind: str, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 s0: Optional[Sequence[torch.Tensor]], s1, nlr: Nlr,
                 hyper: Dict[str, float], bp: Optional[torch.Tensor] = None,
                 ok: Optional[torch.Tensor] = None,
                 counts: Sequence[torch.Tensor] = ()) -> None:
    """K22: update ``params`` and their state ``s0`` (trace, accumulator
    or mu) and ``s1`` (nu) in place from ``grads`` (see the module
    docstring). ``hyper``: ``momentum`` (momentum kinds), ``eps``
    (adagrad, adam), ``b1``, ``b2``, ``eps_root`` (adam); ``bp``: adam's
    bias powers (float32 ``[2]`` on the card). Reads nothing on the
    host."""
    if kind not in KINDS:
        raise ValueError(f"unknown dense update {kind!r}")
    params, grads = list(params), list(grads)
    ns = _N_STATE[kind]
    states = [list(s0 or ()), list(s1 or ())][:ns]
    if len(grads) != len(params) or any(len(s) != len(params)
                                        for s in states):
        raise ValueError("params, grads and state lists must match")
    dev = (params[0].device if params else
           counts[0].device if counts else torch.device("cpu"))
    if dev.type == "cpu":
        return dense_update_plain(kind, params, grads, s0, s1, nlr, hyper,
                                  bp, ok, counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    grads = [g.contiguous() for g in grads]
    for i, p in enumerate(params):
        _check(p, dev, f"param {i}")
        _check(grads[i], dev, f"grad {i}")
        if grads[i].shape != p.shape:
            raise ValueError(f"grad {i}: shape {tuple(grads[i].shape)} != "
                             f"{tuple(p.shape)}")
        for s in states:
            _check(s[i], dev, f"state of param {i}")
            if s[i].shape != p.shape:
                raise ValueError(f"state of param {i}: shape "
                                 f"{tuple(s[i].shape)} != {tuple(p.shape)}")
    for c in counts:
        if c.dtype != torch.int32 or c.numel() != 1 or c.device != dev:
            raise ValueError(f"count: expected one int32 on {dev}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1
                           or ok.device != dev):
        raise ValueError(f"ok: expected one bool on {dev}")
    nlr_t = None
    if isinstance(nlr, torch.Tensor):
        if nlr.numel() != 1:
            raise ValueError("a tensor lr must hold one value")
        nlr_t = nlr.reshape(()).to(device=dev, dtype=torch.float32)
    if kind == "adam":
        if bp is None or bp.dtype != torch.float32 or bp.numel() != 2 \
                or bp.device != dev:
            raise ValueError("adam: bp must be float32 [2] on the card")
        bp = bp.contiguous()
    cap, tile = _limits()
    lib = _kernels.library("dense_update")
    stream = torch.cuda.current_stream(dev).cuda_stream
    h = {k: _f32(v) for k, v in hyper.items()}
    b1, b2 = hyper.get("b1", 0.0), hyper.get("b2", 0.0)
    count_ptrs = [c.data_ptr() for c in counts]
    if len(count_ptrs) > 2:
        raise ValueError("at most two counts")
    count_ptrs += [None] * (2 - len(count_ptrs))
    for lo in range(0, max(len(params), 1), cap):
        idx = range(lo, min(lo + cap, len(params)))
        descs = np.zeros((max(len(idx), 1), 6), np.int64)
        tiles = 0
        for j, i in enumerate(idx):
            descs[j] = (params[i].data_ptr(), grads[i].data_ptr(),
                        states[0][i].data_ptr() if ns > 0 else 0,
                        states[1][i].data_ptr() if ns > 1 else 0,
                        params[i].numel(), tiles)
            tiles += -(-params[i].numel() // tile)
        first = lo == 0
        err = lib.detpu_dense_update(
            descs.ctypes.data, descs.shape[0], max(tiles, 1), KINDS[kind],
            0.0 if nlr_t is not None else _f32(nlr),
            None if nlr_t is None else nlr_t.data_ptr(),
            h.get("momentum", 0.0), _f32(b1), _f32(1.0 - b1), _f32(b2),
            _f32(1.0 - b2), h.get("eps", 0.0), h.get("eps_root", 0.0),
            None if bp is None else bp.data_ptr(),
            None if ok is None else ok.data_ptr(),
            count_ptrs[0] if first else None,
            count_ptrs[1] if first else None, stream)
        _kernels.check(lib, err, "dense_update")
        dense_update.launches += 1


dense_update.launches = 0
