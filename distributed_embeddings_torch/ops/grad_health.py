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
kernel (two launches a call, a pass over chunks and a pass over tensors)
or raise. The wrapper counts its calls.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _limits():
    lib = _kernels.library("grad_health")
    return lib.detpu_grad_health_max_tensors(), lib.detpu_grad_health_chunk()


def _as_2d(t: torch.Tensor):
    """``(t', cols, row stride)``: ``t`` itself when contiguous or a 2-D
    view with unit column stride (a column slice of a wider tensor, as an
    autograd cotangent often is), else a contiguous copy."""
    if t.is_contiguous():
        return t, max(t.numel(), 1), max(t.numel(), 1)
    if t.dim() >= 2 and t.stride(-1) == 1:
        # the leading dims must collapse into one row dim
        ok = all(t.stride(i) == t.stride(i + 1) * t.shape[i + 1]
                 for i in range(t.dim() - 2))
        if ok and t.stride(-2) >= t.shape[-1]:
            return t, t.shape[-1], t.stride(-2)
    t = t.contiguous()
    return t, max(t.numel(), 1), max(t.numel(), 1)


def grad_health(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """K21: ``[3, n]`` float32 ``(sum of squares, max |g|, non-finite
    count)`` of each of ``tensors`` (float32 or bfloat16, one device; see
    the module docstring). The result stays on the device: nothing is
    read on the host."""
    tensors = list(tensors)
    if not tensors:
        raise ValueError("grad_health needs at least one tensor")
    dev = tensors[0].device
    if dev.type == "cpu":
        return grad_health_plain(tensors)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for i, t in enumerate(tensors):
        if t.dtype not in _DTYPE_CODE or t.device != dev:
            raise ValueError(f"tensor {i}: expected float32/bfloat16 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    cap, chunk = _limits()
    outs = [_launch(tensors[i:i + cap], chunk)
            for i in range(0, len(tensors), cap)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _launch(tensors: List[torch.Tensor], chunk: int) -> torch.Tensor:
    dev = tensors[0].device
    n = len(tensors)
    descs = np.zeros((n, 6), np.int64)
    keep = []
    chunks = 0
    for i, t in enumerate(tensors):
        t, cols, stride = _as_2d(t)
        keep.append(t)
        g = 16 // t.element_size()
        vec = (t.data_ptr() % 16 == 0
               and (cols == t.numel() or (cols % g == 0 and stride % g == 0)))
        descs[i] = (t.data_ptr(), t.numel(), cols, stride, chunks,
                    _DTYPE_CODE[t.dtype] | (int(vec) << 32))
        chunks += -(-t.numel() // chunk)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    partials = torch.empty((max(chunks, 1), 3), dtype=torch.float32,
                           device=dev)
    lib = _kernels.library("grad_health")
    err = lib.detpu_grad_health(
        descs.ctypes.data, n, chunks, partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, "grad_health")
    grad_health.launches += 1
    del keep
    return out


grad_health.launches = 0
