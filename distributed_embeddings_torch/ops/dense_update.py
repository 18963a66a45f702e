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

The launch goes through the shared launch path (``_kernels.LaunchRecord``):
the parameters and the optimizer state are updated in place and keep
their addresses from step to step, and so, through the caching
allocator, do the gradients; so the first call with a set of tensors
validates it, builds the descriptor table and the prepared launch, and
keeps them under a key of every fact they rest on (:func:`record_key`),
and each later call with that key passes only ``nlr`` (a tensor),
``bp``, ``ok`` and the counts. The tile a block updates is picked per
launch from the elements (:func:`pick_tile`).
"""

from __future__ import annotations

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


#: the most tensors one launch takes (``csrc/dense_update.cu``)
MAX_TENSORS = 512
#: the tiles (elements a block updates) a launch may take, largest first
TILES = (4096, 2048, 1024)
#: blocks an SM the tile choice aims for
BLOCKS_PER_SM = 2
#: the SMs of an H100, for the tiles of records built on CPU tensors
H100_SMS = 132
#: K22's launch records (``_kernels.LaunchRecord``), by key
_CACHE = _kernels.LaunchCache()


def pick_tile(numels: Sequence[int], sms: int) -> int:
    """The largest of :data:`TILES` that gives a launch over tensors of
    ``numels`` elements at least :data:`BLOCKS_PER_SM` blocks on each of
    ``sms`` SMs, else the smallest."""
    for tile in TILES:
        if sum(-(-n // tile) for n in numels) >= BLOCKS_PER_SM * sms:
            return tile
    return TILES[-1]


def launch_tables(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], states, sms: int):
    """``[(descriptors int64 [n, 6], tile)]``, one a launch of at most
    :data:`MAX_TENSORS` tensors: per tensor (p, g, s0, s1, numel, first
    tile) in units of the launch's tile (:func:`pick_tile`)."""
    out = []
    for lo in range(0, max(len(params), 1), MAX_TENSORS):
        idx = range(lo, min(lo + MAX_TENSORS, len(params)))
        tile = pick_tile([params[i].numel() for i in idx], sms)
        descs = np.zeros((max(len(idx), 1), 6), np.int64)
        tiles = 0
        for j, i in enumerate(idx):
            descs[j] = (params[i].data_ptr(), grads[i].data_ptr(),
                        states[0][i].data_ptr() if len(states) > 0 else 0,
                        states[1][i].data_ptr() if len(states) > 1 else 0,
                        params[i].numel(), tiles)
            tiles += -(-params[i].numel() // tile)
        out.append((descs, tile))
    return out


def _check(t: torch.Tensor, dev, what: str) -> None:
    if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous float32 tensor on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _states(kind: str, s0, s1) -> tuple:
    return (s0 or (), s1 or ())[:_N_STATE.get(kind, 0)]


def record_key(kind: str, params, grads, states, nlr: Nlr, hyper, bp, ok,
               counts) -> tuple:
    """Every fact K22's launch record rests on: the kind, the list
    lengths, the constant ``nlr`` (or a tensor ``nlr``'s layout), the
    hyperparameters, the layouts of ``bp``, ``ok`` and the counts (their
    addresses are read per call), and per parameter, gradient and state
    tensor its address, shape, strides, dtype and device."""
    ts = [*params, *grads]
    for s in states:
        ts.extend(s)
    return (kind, len(params), len(grads), *map(len, states),
            _kernels.layout_key(nlr) if isinstance(nlr, torch.Tensor)
            else nlr, tuple(hyper.items()), _kernels.layout_key(bp),
            _kernels.layout_key(ok),
            tuple(map(_kernels.layout_key, counts)),
            *_kernels.tensor_key(ts))


def build_record(kind: str, params, grads, states, nlr: Nlr, hyper, bp,
                 ok, counts, sms: Optional[int] = None):
    """``(record, nlr, bp)``: validate a call as :func:`dense_update` does
    (raising as it does) and build its launch record: the descriptor
    tables (``record.payload``, :func:`launch_tables`) and, for CUDA
    tensors, the prepared launches bound to the library. ``nlr`` and
    ``bp`` come back as the launch reads them; where one of them or a
    gradient had to be converted or copied, the record is marked not to
    be kept. CPU tensors (the tests) get a record without launches."""
    dev = params[0].device if params else (counts[0].device if counts
                                           else torch.device("cpu"))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    keep = True
    cgrads = [g.contiguous() for g in grads]
    for i, p in enumerate(params):
        _check(p, dev, f"param {i}")
        keep &= cgrads[i] is grads[i]
        _check(cgrads[i], dev, f"grad {i}")
        if cgrads[i].shape != p.shape:
            raise ValueError(f"grad {i}: shape {tuple(cgrads[i].shape)} != "
                             f"{tuple(p.shape)}")
        for s in states:
            _check(s[i], dev, f"state of param {i}")
            if s[i].shape != p.shape:
                raise ValueError(f"state of param {i}: shape "
                                 f"{tuple(s[i].shape)} != {tuple(p.shape)}")
    if len(counts) > 2:
        raise ValueError("at most two counts")
    for c in counts:
        if c.dtype != torch.int32 or c.numel() != 1 or c.device != dev:
            raise ValueError(f"count: expected one int32 on {dev}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1
                           or ok.device != dev):
        raise ValueError(f"ok: expected one bool on {dev}")
    nlr_on_card = isinstance(nlr, torch.Tensor)
    if nlr_on_card:
        if nlr.numel() != 1:
            raise ValueError("a tensor lr must hold one value")
        if nlr.dtype != torch.float32 or nlr.device != dev:
            nlr, keep = nlr.reshape(()).to(device=dev,
                                           dtype=torch.float32), False
    if kind == "adam":
        if bp is None or bp.dtype != torch.float32 or bp.numel() != 2 \
                or bp.device != dev:
            raise ValueError("adam: bp must be float32 [2] on the card")
        if not bp.is_contiguous():
            bp, keep = bp.contiguous(), False
    tables = launch_tables(params, cgrads, states,
                           sms or (_kernels.sm_count(dev.index or 0)
                                   if dev.type == "cuda" else H100_SMS))
    lib, calls, buffers = None, [], []
    if dev.type == "cuda":
        lib = _kernels.library("dense_update")
        if lib.detpu_dense_update_max_tensors() != MAX_TENSORS:
            raise RuntimeError("csrc/dense_update.cu and "
                               "ops/dense_update.py disagree on the most "
                               "tensors a launch takes")
        size = lib.detpu_dense_update_prepared_bytes()
        h = {k: _f32(v) for k, v in hyper.items()}
        b1, b2 = hyper.get("b1", 0.0), hyper.get("b2", 0.0)
        for j, (descs, tile) in enumerate(tables):
            buf = np.zeros(size, np.uint8)
            _kernels.check(lib, lib.detpu_dense_update_prepare(
                descs.ctypes.data, descs.shape[0], tile, KINDS[kind],
                0.0 if nlr_on_card else _f32(nlr), int(nlr_on_card),
                h.get("momentum", 0.0), _f32(b1), _f32(1.0 - b1), _f32(b2),
                _f32(1.0 - b2), h.get("eps", 0.0), h.get("eps_root", 0.0),
                int(j == 0), buf.ctypes.data), "dense_update")
            buffers.append(buf)
            calls.append((lib.detpu_dense_update_launch, (buf.ctypes.data,)))
    rec = _kernels.LaunchRecord(
        lib, "dense_update", calls,
        (dev.index or 0) if dev.type == "cuda" else -1, keep=keep,
        payload=(tables, buffers, cgrads if not keep else None))
    return rec, nlr, bp


def find_record(cache: _kernels.LaunchCache, kind: str, params, grads, s0,
                s1, nlr: Nlr, hyper, bp=None, ok=None, counts=(),
                build_on_cpu: bool = False):
    """``(record, nlr, bp)`` of a call: found in ``cache`` by
    :func:`record_key`, or built (:func:`build_record`) and kept. A miss
    on CPU tensors gives ``(None, nlr, bp)`` (the wrapper runs the plain
    version) unless ``build_on_cpu``."""
    states = _states(kind, s0, s1)
    key = record_key(kind, params, grads, states, nlr, hyper, bp, ok,
                     counts)
    rec = cache.get(key)
    if rec is not None:
        return rec, nlr, bp
    if kind not in KINDS:
        raise ValueError(f"unknown dense update {kind!r}")
    if len(grads) != len(params) or any(len(s) != len(params)
                                        for s in states):
        raise ValueError("params, grads and state lists must match")
    dev = params[0].device if params else (counts[0].device if counts
                                           else torch.device("cpu"))
    if dev.type == "cpu" and not build_on_cpu:
        return None, nlr, bp
    rec, nlr, bp = build_record(kind, params, grads, states, nlr, hyper,
                                bp, ok, counts)
    return cache.add(key, rec), nlr, bp


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
    host. The first call with a set of tensors validates it and builds
    its launch record; a later call with the same tensors (and layouts
    of ``nlr``, ``bp``, ``ok`` and the counts) only replays it."""
    rec, nlr, bp = find_record(_CACHE, kind, params, grads, s0, s1, nlr,
                               hyper, bp, ok, counts)
    if rec is None:
        return dense_update_plain(kind, params, grads, s0, s1, nlr, hyper,
                                  bp, ok, counts)
    dense_update.launches += rec.replay(
        nlr.data_ptr() if isinstance(nlr, torch.Tensor) else None,
        None if bp is None else bp.data_ptr(),
        None if ok is None else ok.data_ptr(),
        counts[0].data_ptr() if counts else None,
        counts[1].data_ptr() if len(counts) > 1 else None)


dense_update.launches = 0
