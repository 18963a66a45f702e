"""DLRM dot-interaction forward on the hand-written kernel K2
(``csrc/dot_interact.cu``), with its plain PyTorch version.

Counterpart of the forward of
``distributed_embeddings_tpu/models/dlrm.py:dot_interact``: for stacked
features ``[B, F, D]`` the strict lower triangle of each sample's Gram
matrix, in ``np.tril_indices(F, -1)`` order, followed by feature 0 (the
bottom-MLP output): ``[B, F(F-1)/2 + D]``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dot_interact_fwd_plain(feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dot_interact_fwd`: fp32 Gram,
    triangle by index, one rounding to the input dtype."""
    f = feats.float()
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
