"""The train step's gradient-health reduction on the hand-written kernel
K21 (``csrc/grad_health.cu``), with its plain PyTorch version.

Counterpart of the reductions of ``distributed_embeddings_tpu/parallel/
trainer.py`` over the step's gradients: ``_sq_sum`` (the non-finite
guard's energies), ``_table_sentinels`` (per input: sum of squares,
max |g| and non-finite count of the embedding cotangents) and the norms
of ``_finish_metrics``. One call reads every tensor of a list once and
returns, per tensor ``i``, ``out[:, i] = (sum(float32(g)**2),
max(|g|), count(!isfinite(g)))`` as a ``[3, n]`` float32 tensor on the
tensors' device:

* the sum squares and adds in float32, as JAX's ``_sq_sum`` does, so a
  finite gradient whose squares overflow gives ``inf`` (the guard then
  skips the step, as JAX's does); the kernel folds in its own fixed order
  (the same bits on every run), so it agrees with the plain version
  within float32 rounding, not bit for bit;
* the max propagates NaN (``jnp.max`` of an array holding NaN is NaN),
  and is 0 for an empty tensor;
* the count is exact, rounded once to float32.

A CPU tensor list runs :func:`grad_health_plain`; CUDA tensors launch the
kernel (one launch a call of at most :data:`MAX_TENSORS` tensors) or
raise. The wrapper counts its launches.

The launch goes through the shared launch path (``_kernels.LaunchRecord``).
Autograd hands the step new gradient tensors every step, so a record is
keyed on their LAYOUTS (:func:`record_key`: count, shapes, strides,
dtypes, device), never on their addresses: the first call with a layout
validates it, plans its chunks (:func:`chunk_plan`), zeroes the record's
scratch (a ticket a tensor, a partial a chunk) and prepares the launch;
each later call passes only the tensors' addresses and a new output.
One stream at a time a record: its scratch is the launch's.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels

#: the most tensors one launch takes (``csrc/grad_health.cu``)
MAX_TENSORS = 512
#: the bytes a chunk covers (about: whole rows where a row fits)
CHUNK_BYTES = 131072
#: descriptor flags (``csrc/grad_health.cu``)
BF16, VEC_LAYOUT = 1, 2
#: the dtypes the kernel reads
DTYPES = (torch.float32, torch.bfloat16)
#: K21's launch records, by layout
_CACHE = _kernels.LaunchCache()


def grad_health_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of :func:`grad_health`."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("grad_health needs at least one tensor")
    dev = tensors[0].device
    cols = []
    for t in tensors:
        g = t.float()
        if g.numel():
            mx = g.abs().max()
        else:
            mx = torch.zeros((), dtype=torch.float32, device=dev)
        cols.append(torch.stack([g.square().sum(), mx,
                                 (~torch.isfinite(g)).sum().float()]))
    return torch.stack(cols, dim=1)


def view_2d(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rows, cols, row stride)`` of ``t`` as the kernel reads it: one
    row for a contiguous tensor, the rows of a view with unit column
    stride whose leading dims collapse (a column slice of a wider tensor,
    as an autograd cotangent may be); None where the kernel needs a
    contiguous copy."""
    n = t.numel()
    if t.is_contiguous():
        return 1, n, n
    if t.dim() >= 2 and t.stride(-1) == 1:
        ok = all(t.stride(i) == t.stride(i + 1) * t.shape[i + 1]
                 for i in range(t.dim() - 2))
        rows = n // t.shape[-1] if t.shape[-1] else 0
        if ok and t.stride(-2) >= t.shape[-1] and rows < 2 ** 31:
            return rows, t.shape[-1], t.stride(-2)
    return None


def chunk_plan(views: Sequence[Tuple[int, int, int]],
               dtypes: Sequence[torch.dtype]) -> np.ndarray:
    """K21's descriptors, int64 ``[n, 8]``: per tensor ``(rows, cols, row
    stride, first chunk, chunks, rows a chunk, chunks a row, flags)``.
    A chunk is about :data:`CHUNK_BYTES`: ``CHUNK_BYTES // cols`` whole
    rows where a row fits, else that many bytes of one row (the last piece
    shorter). Flags: :data:`BF16`, and :data:`VEC_LAYOUT` where 16-byte
    loads fit the layout (one row, or a row stride of whole 16-byte
    groups); the call's addresses decide the rest."""
    descs = np.zeros((len(views), 8), np.int64)
    first = 0
    for i, ((rows, cols, stride), dt) in enumerate(zip(views, dtypes)):
        esize = 2 if dt == torch.bfloat16 else 4
        ce = CHUNK_BYTES // esize
        if cols > ce:
            rpc, ppr = 1, -(-cols // ce)
            chunks = rows * ppr
        else:
            rpc, ppr = max(1, ce // max(cols, 1)), 1
            chunks = -(-rows // rpc)
        if rows == 0 or cols == 0:
            chunks = 0
        flags = (BF16 if dt == torch.bfloat16 else 0) | (
            VEC_LAYOUT if rows <= 1 or stride % (16 // esize) == 0 else 0)
        descs[i] = (rows, cols, stride, first, chunks, rpc, ppr, flags)
        first += chunks
    return descs


def record_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """Every fact K21's launch record rests on: the count, and per tensor
    its shape, strides, dtype and device index. No address: each call
    passes its own."""
    return (*map(_kernels._SHAPE, tensors), *map(_kernels._STRIDE, tensors),
            *map(_kernels._DTYPE, tensors), *map(_kernels._DEVICE, tensors))


def build_record(tensors: Sequence[torch.Tensor],
                 sms: Optional[int] = None) -> _kernels.LaunchRecord:
    """Validate a call as :func:`grad_health` does (raising as it does)
    and build its launch record: per launch of at most
    :data:`MAX_TENSORS` tensors the descriptors (:func:`chunk_plan`), the
    zeroed scratch and, for CUDA tensors, the prepared launch bound to
    the library. ``record.payload``: ``(copy, launches)``, ``copy`` the
    indices of the tensors a call hands the kernel as contiguous copies
    (a layout the kernel does not read in place), ``launches`` a list of
    ``(first tensor, descriptors, scratch, prepared)``. CPU tensors (the
    tests) get a record without launches."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for i, t in enumerate(tensors):
        if t.dtype not in DTYPES or t.device != dev:
            raise ValueError(f"tensor {i}: expected float32/bfloat16 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    views, copy = [], []
    for i, t in enumerate(tensors):
        v = view_2d(t)
        if v is None:
            copy.append(i)
            v = (1, t.numel(), t.numel())
        views.append(v)
    dtypes = [t.dtype for t in tensors]
    lib, calls, launches = None, [], []
    if dev.type == "cuda":
        lib = _kernels.library("grad_health")
        if lib.detpu_grad_health_max_tensors() != MAX_TENSORS or \
                lib.detpu_grad_health_chunk_bytes() != CHUNK_BYTES:
            raise RuntimeError("csrc/grad_health.cu and ops/grad_health.py "
                               "disagree on the launch's limits")
    for lo in range(0, len(tensors), MAX_TENSORS):
        hi = min(lo + MAX_TENSORS, len(tensors))
        descs = chunk_plan(views[lo:hi], dtypes[lo:hi])
        chunks = int(descs[-1, 3] + descs[-1, 4])
        scratch = prepared = None
        if lib is not None:
            scratch = torch.zeros(max(lib.detpu_grad_health_scratch_bytes(
                hi - lo, chunks), 8), dtype=torch.uint8, device=dev)
            prepared = np.zeros(lib.detpu_grad_health_prepared_bytes(),
                                np.uint8)
            _kernels.check(lib, lib.detpu_grad_health_prepare(
                descs.ctypes.data, hi - lo, scratch.data_ptr(),
                sms or _kernels.sm_count(dev.index or 0), len(tensors),
                prepared.ctypes.data), "grad_health")
            calls.append((lib.detpu_grad_health_launch,
                          (prepared.ctypes.data,)))
        launches.append((lo, descs, scratch, prepared))
    return _kernels.LaunchRecord(lib, "grad_health", calls,
                                 _kernels.device_index(dev),
                                 payload=(tuple(copy), launches))


def find_record(tensors: Sequence[torch.Tensor],
                build_on_cpu: bool = False
                ) -> Optional[_kernels.LaunchRecord]:
    """The record of a call, found in :data:`_CACHE` by
    :func:`record_key` or built (:func:`build_record`) and kept. A miss
    on CPU tensors is validated and gives None (the wrapper runs the
    plain version) unless ``build_on_cpu``."""
    return _kernels.find_or_build(_CACHE, record_key(tensors), build_record,
                                  tensors[0].device.type == "cpu",
                                  build_on_cpu, tensors)


@functools.lru_cache(maxsize=None)
def _packer(n: int):
    return struct.Struct(f"{n}q").pack


def _addresses(ts: Sequence[torch.Tensor]) -> bytes:
    """The tensors' addresses as int64 host bytes (what the launch
    patches in)."""
    return _packer(len(ts))(*map(torch.Tensor.data_ptr, ts))


def grad_health(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """K21: ``[3, n]`` float32 ``(sum of squares, max |g|, non-finite
    count)`` of each of ``tensors`` (float32 or bfloat16, one device; see
    the module docstring). The result stays on the device: nothing is
    read on the host."""
    if not tensors:
        raise ValueError("grad_health needs at least one tensor")
    dev = tensors[0].device
    if dev.type == "cpu":
        return grad_health_plain(tensors)
    rec = _kernels.find_or_build(_CACHE, record_key(tensors), build_record,
                                 False, False, tensors)
    copy, launches = rec.payload
    if copy:
        tensors = list(tensors)
        for i in copy:
            tensors[i] = tensors[i].contiguous()
    out = torch.empty(3, len(tensors), dtype=torch.float32, device=dev)
    if len(launches) == 1:
        grad_health.launches += rec.replay(_addresses(tensors),
                                           out.data_ptr())
        return out
    # more than MAX_TENSORS: one launch a slice, each into its columns
    stream = _kernels.stream_handle(rec.device)
    for (fn, head), (lo, descs, _, _) in zip(rec.calls, launches):
        _kernels.check(rec.lib, fn(*head, _addresses(
            tensors[lo:lo + descs.shape[0]]), out.data_ptr() + 4 * lo,
            stream), "grad_health")
        grad_health.launches += 1
    return out


grad_health.launches = 0
