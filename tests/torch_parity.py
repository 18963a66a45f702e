"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: numpy
in, both packages, numpy out."""

import numpy as np
import pytest
import torch


def bf16_ulp(x) -> np.ndarray:
    """One bfloat16 ulp at magnitude ``|x|`` (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_ulps(got, want, scale, ulps: float, what: str = ""):
    """``|got - want| <= ulps`` bfloat16 ulps of ``scale`` (elementwise
    magnitude the error is measured against)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = ulps * bf16_ulp(scale)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} beyond {ulps} bf16 ulp; "
        f"max err {np.abs(got - want).max()}")


def to_np(x) -> np.ndarray:
    """Host float/int numpy of a torch tensor or a JAX/numpy array
    (bfloat16 as float32, which holds it exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture
def cuda_device():
    """The card for ``@pytest.mark.cuda`` tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (run with `-m cuda` on the GPU)")
    return torch.device("cuda")
