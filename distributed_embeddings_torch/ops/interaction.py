"""DLRM dot interaction on the hand-written kernels K2 (forward) and K4
(backward) in ``csrc/dot_interact.cu``, with their plain PyTorch
versions and the ``torch.autograd.Function`` that joins them.

Counterpart of ``distributed_embeddings_tpu/models/dlrm.py:dot_interact``
and of what JAX's autodiff makes of it: for stacked features
``[B, F, D]`` the forward is the strict lower triangle of each sample's
Gram matrix, in ``np.tril_indices(F, -1)`` order, followed by feature 0
(the bottom-MLP output): ``[B, F(F-1)/2 + D]``. The backward spreads
each pair's cotangent over the symmetric ``[F, F]`` matrix ``dG`` and
returns ``dG @ feats`` per sample, plus the cotangent of the appended
row on feature 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 inputs (the plain versions'
    gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def dot_interact_fwd_plain(feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dot_interact_fwd`: fp32 Gram,
    triangle by index, one rounding to the input dtype."""
    f = feats.to(_acc_dtype(feats.dtype))
    gram = torch.bmm(f, f.transpose(1, 2))
    li, lj = np.tril_indices(feats.shape[1], k=-1)
    lower = gram[:, torch.as_tensor(li, device=feats.device),
                 torch.as_tensor(lj, device=feats.device)]
    return torch.cat([lower.to(feats.dtype), feats[:, 0]], dim=1)


def dot_interact_fwd(feats: torch.Tensor) -> torch.Tensor:
    """K2: ``[B, F, D]`` (float32 or bfloat16, contiguous) ->
    ``[B, F(F-1)/2 + D]`` in the input dtype, products accumulated in
    fp32. A CPU tensor runs :func:`dot_interact_fwd_plain`; a CUDA
    tensor launches the kernel or raises."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, F, D], got {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        return dot_interact_fwd_plain(feats)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPE_CODE or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous float32/bfloat16 "
                         f"tensor, got {feats.dtype}")
    b, f, d = feats.shape
    if not 2 <= f <= 255:
        raise ValueError(f"dot_interact_fwd takes 2..255 features, got {f}")
    out = torch.empty((b, f * (f - 1) // 2 + d), dtype=feats.dtype,
                      device=feats.device)
    if b == 0:
        return out
    lib = _kernels.library("dot_interact")
    err = lib.detpu_dot_interact_fwd(
        feats.data_ptr(), out.data_ptr(), b, f, d, _DTYPE_CODE[feats.dtype],
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, err, "dot_interact_fwd")
    dot_interact_fwd.launches += 1
    return out


dot_interact_fwd.launches = 0


def dot_interact_bwd_plain(feats: torch.Tensor,
                           dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dot_interact_bwd`: the symmetric
    ``dG`` built by index, ``bmm`` in fp32, one rounding to the input
    dtype."""
    b, f, d = feats.shape
    acc = _acc_dtype(feats.dtype)
    li, lj = np.tril_indices(f, k=-1)
    li = torch.as_tensor(li, device=feats.device)
    lj = torch.as_tensor(lj, device=feats.device)
    lower = dy[:, :len(li)].to(acc)
    dg = torch.zeros((b, f, f), dtype=acc, device=feats.device)
    dg[:, li, lj] = lower
    dg[:, lj, li] = lower
    out = torch.bmm(dg, feats.to(acc))
    out[:, 0] += dy[:, len(li):].to(acc)
    return out.to(feats.dtype)


def dot_interact_bwd(feats: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K4: the cotangent of :func:`dot_interact_fwd`'s input. ``feats
    [B, F, D]`` and ``dy [B, F(F-1)/2 + D]`` (both float32 or both
    bfloat16, contiguous) -> ``dfeats [B, F, D]`` in the input dtype,
    accumulated in fp32. A CPU tensor runs :func:`dot_interact_bwd_plain`;
    a CUDA tensor launches the kernel or raises."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, F, D], got {tuple(feats.shape)}")
    b, f, d = feats.shape
    if tuple(dy.shape) != (b, f * (f - 1) // 2 + d):
        raise ValueError(f"dy must be {(b, f * (f - 1) // 2 + d)}, got "
                         f"{tuple(dy.shape)}")
    if feats.device.type == "cpu":
        return dot_interact_bwd_plain(feats, dy)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if feats.dtype not in _DTYPE_CODE or dy.dtype != feats.dtype \
            or dy.device != feats.device or not feats.is_contiguous() \
            or not dy.is_contiguous():
        raise ValueError("feats and dy must be contiguous float32/bfloat16 "
                         f"tensors of one dtype on one device, got "
                         f"{feats.dtype} and {dy.dtype} on {dy.device}")
    if not 2 <= f <= 255:
        raise ValueError(f"dot_interact_bwd takes 2..255 features, got {f}")
    out = torch.empty_like(feats)
    if b == 0:
        return out
    lib = _kernels.library("dot_interact")
    err = lib.detpu_dot_interact_bwd(
        feats.data_ptr(), dy.data_ptr(), out.data_ptr(), b, f, d,
        _DTYPE_CODE[feats.dtype],
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, err, "dot_interact_bwd")
    dot_interact_bwd.launches += 1
    return out


dot_interact_bwd.launches = 0


class DotInteract(torch.autograd.Function):
    """``dot_interact_fwd`` (K2) with ``dot_interact_bwd`` (K4) as its
    gradient: ``DotInteract.apply(feats [B, F, D])``."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return dot_interact_fwd(feats)

    @staticmethod
    def backward(ctx, dy):
        feats, = ctx.saved_tensors
        return dot_interact_bwd(feats, dy.contiguous())
