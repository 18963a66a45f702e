"""The port's DLRM initializers draw from the same distributions as the
JAX package's: ``dlrm_initializer`` (``U(-1/sqrt(rows), 1/sqrt(rows))``),
the dense layers' truncated-normal Glorot kernels (flax's
``glorot_normal``) and their ``N(0, 1/fan_out)`` biases. The two packages
use different generators (torch's and ``jax.random``), so their draws
differ; their moments must not.

Each initializer is drawn once per package at a large size (``N``
values) and the two draws' means and variances are compared. Tolerance:
5 standard errors of the difference of two independent estimates,
``5 sqrt(2 var / N)`` for the mean and ``5 sqrt(2 (m4 - var^2) / N)``
for the variance (``m4`` the fourth central moment, measured on the JAX
draw); each draw also stays inside the distribution's support.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from distributed_embeddings_tpu.models.dlrm import (
    dlrm_initializer as jax_dlrm_initializer)

from distributed_embeddings_torch.models.dlrm import (
    _linear, dlrm_initializer)

N = 1 << 20


def _assert_same_moments(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    var = want.var()
    m4 = np.mean((want - want.mean()) ** 4)
    mean_tol = 5 * math.sqrt(2 * var / want.size)
    var_tol = 5 * math.sqrt(2 * (m4 - var * var) / want.size)
    assert abs(got.mean() - want.mean()) <= mean_tol, (
        f"{what}: mean {got.mean()} vs {want.mean()} (tol {mean_tol})")
    assert abs(got.var() - var) <= var_tol, (
        f"{what}: variance {got.var()} vs {var} (tol {var_tol})")


@pytest.mark.parametrize("rows", [200, 39884407])
def test_dlrm_initializer_moments(rows):
    gen = torch.Generator().manual_seed(0)
    got = dlrm_initializer(rows)(torch.empty(N), gen).numpy()
    want = np.asarray(jax_dlrm_initializer(rows)(jax.random.key(0), (N,)))
    bound = 1.0 / math.sqrt(rows)
    for x in (got, want):
        assert np.abs(x).max() <= bound
    _assert_same_moments(got, want, f"dlrm_initializer({rows})")


@pytest.mark.parametrize("fan_in,fan_out", [(13, 512), (1024, 1024),
                                            (256, 1)])
def test_dense_layer_init_moments(fan_in, fan_out):
    """Kernel and bias of one dense layer, each drawn as many times over
    as it takes to reach about ``N`` values (biases: at most 4096
    layers)."""
    reps = max(1, N // (fan_in * fan_out))
    gen = torch.Generator().manual_seed(1)
    lins = [_linear(fan_in, fan_out, "cpu", gen) for _ in range(reps)]
    kernel = np.concatenate([lin.weight.detach().numpy().ravel()
                             for lin in lins])
    keys = jax.random.split(jax.random.key(1), reps + 1)
    jkernel = np.asarray(jax.vmap(lambda k: nn.initializers.glorot_normal()(
        k, (fan_in, fan_out)))(keys[1:])).ravel()
    # the truncation keeps |w| within 2 sigma of the pre-truncation normal
    std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    for x in (kernel, jkernel):
        assert np.abs(x).max() <= 2 * std * (1 + 1e-6)
    _assert_same_moments(kernel, jkernel,
                         f"Glorot kernel {fan_in}x{fan_out}")

    bias = torch.cat([_linear(1, fan_out, "cpu", gen).bias.detach()
                      for _ in range(min(max(N // fan_out, 1), 4096))]
                     ).numpy()
    jbias = np.asarray(nn.initializers.normal(math.sqrt(1.0 / fan_out))(
        keys[0], (bias.size,), jnp.float32))
    _assert_same_moments(bias, jbias, f"bias N(0, 1/{fan_out})")
