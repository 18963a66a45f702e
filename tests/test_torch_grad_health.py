"""K21's plain version (``ops/grad_health.py``) against the JAX package's
reductions over the step's gradients: ``_sq_sum`` (the non-finite
guard's energies and the norms) and ``_table_sentinels`` (per-table sum
of squares, max |g|, non-finite count), on the same numpy gradients.

Tolerances, with their reasons:
  - the sums of squares: float32 sums in another order than XLA's, all
    terms positive, so each side is within ~n float32 roundings of the
    exact sum; held within rtol 1e-5 (n <= 600 terms a tensor here, the
    bound a few 1e-5 at worst, ~1e-7 in practice). A control that drops
    one term must fail it;
  - max |g| and the non-finite counts: exact (NaN equals NaN);
  - the guard's verdict (``isfinite`` of the float32 sums): exact, with
    a NaN, an Inf or a finite value whose square overflows in any one
    tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import DistributedEmbedding as JaxDE
from distributed_embeddings_tpu.parallel.trainer import (
    _sq_sum as jax_sq_sum, _table_sentinels as jax_sentinels)

from distributed_embeddings_torch.ops import grad_health, grad_health_plain
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.parallel import trainer as t_trainer

from torch_parity import to_np

torch.set_num_threads(1)

RTOL = 1e-5
#: four tables, table 1 read by no input, tables 0 and 2 by two each
CONFIGS = [{"input_dim": 30, "output_dim": 8},
           {"input_dim": 20, "output_dim": 8},
           {"input_dim": 40, "output_dim": 16},
           {"input_dim": 10, "output_dim": 4}]
TMAP = [0, 2, 2, 3, 0]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _grads(rng, dtype, b=37):
    """One cotangent per input ``[b, w]`` (numpy float32, rounded to
    ``dtype`` on both sides) with mixed magnitudes."""
    out = []
    for t in TMAP:
        w = CONFIGS[t]["output_dim"]
        g = rng.normal(size=(b, w)) * 10.0 ** rng.integers(-4, 2, (b, 1))
        out.append(g.astype(np.float32))
    return out


def _both(arrays, dtype):
    _, jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.copy()).to(tdt) for a in arrays])


def _layers():
    return (JaxDE(CONFIGS, world_size=1, input_table_map=TMAP),
            DistributedEmbedding(CONFIGS, world_size=1,
                                 input_table_map=TMAP))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sums_match_jax_sq_sum(dtype):
    rng = np.random.default_rng(0)
    grads = _grads(rng, dtype)
    jg, tg = _both(grads, dtype)
    h = to_np(grad_health_plain(tg))
    assert h.shape == (3, len(grads)) and h.dtype == np.float32
    for i, g in enumerate(jg):
        want = np.asarray(jax_sq_sum([g]))
        np.testing.assert_allclose(h[0, i], want, rtol=RTOL, atol=0)
        np.testing.assert_array_equal(h[1, i], np.asarray(
            jnp.max(jnp.abs(g.astype(jnp.float32)))))
        assert h[2, i] == 0
    np.testing.assert_allclose(h[0].sum(), np.asarray(jax_sq_sum(jg)),
                               rtol=RTOL, atol=0)
    # the CPU wrapper is the plain version, and it counts no launch
    before = grad_health.launches
    np.testing.assert_array_equal(to_np(grad_health(tg)), h)
    assert grad_health.launches == before


def test_sum_tolerance_has_a_failing_control():
    """Dropping one square (the largest) from a tensor's sum fails
    the stated bound."""
    rng = np.random.default_rng(1)
    g = _grads(rng, "float32")[1]
    want = float(np.asarray(jax_sq_sum([jnp.asarray(g)])))
    dropped = g.copy()
    dropped.flat[np.argmax(np.abs(g))] = 0.0
    h = to_np(grad_health_plain([torch.from_numpy(dropped)]))
    assert abs(h[0, 0] - want) > RTOL * want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_table_sentinels_match_jax(dtype, poison):
    rng = np.random.default_rng(2)
    grads = _grads(rng, dtype)
    if poison is not None:
        grads[2][5, 3] = np.nan if poison == "nan" else -np.inf
    jg, tg = _both(grads, dtype)
    jde, tde = _layers()
    lr = 0.37
    want = {k: np.asarray(v) for k, v in
            jax_sentinels(jde, jg, jnp.float32(lr)).items()}
    got = {k: to_np(v) for k, v in t_trainer._table_sentinels(
        tde, grad_health_plain(tg), lr).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == want[k].shape == (1, len(CONFIGS)), k
        assert got[k].dtype == want[k].dtype, k
    # table 1 has no input: a real 0 in every sentinel
    for k in got:
        assert got[k][0, 1] == 0, k
    np.testing.assert_array_equal(got["table_nonfinite"],
                                  want["table_nonfinite"])
    np.testing.assert_array_equal(got["table_update_maxabs"],
                                  want["table_update_maxabs"])
    np.testing.assert_allclose(got["table_grad_norm"],
                               want["table_grad_norm"], rtol=RTOL, atol=0)
    if poison is not None:
        # the poisoned input feeds table 2: its max is NaN or Inf
        bad = np.isnan if poison == "nan" else np.isinf
        assert bad(got["table_update_maxabs"][0, 2])
        assert got["table_nonfinite"][0, 2] == 1
        assert not np.isnan(got["table_update_maxabs"][0, [0, 3]]).any()


@pytest.mark.parametrize("where", ["dense", "out"])
@pytest.mark.parametrize("poison", ["nan", "inf", "overflow", None])
def test_guard_verdict_matches_jax(where, poison):
    """``isfinite(loss) & isfinite(sum dense) & isfinite(0 * sum out)``
    from the plain version's sums equals JAX's from ``_sq_sum``, with the
    poison in any one tensor (an overflow: finite values whose squares
    pass float32's range)."""
    rng = np.random.default_rng(3)
    for k in range(3):
        dense = [rng.normal(size=s).astype(np.float32)
                 for s in ((16, 13), (16,), (1, 16))]
        outs = _grads(rng, "float32")
        target = dense if where == "dense" else outs
        t = target[k]
        if poison == "nan":
            t.flat[rng.integers(t.size)] = np.nan
        elif poison == "inf":
            t.flat[rng.integers(t.size)] = np.inf
        elif poison == "overflow":
            t.flat[:2] = 3e38
        loss = np.float32(0.5)
        jd, td = _both(dense, "float32")
        jo, to = _both(outs, "float32")
        want = bool(np.isfinite(loss) & jnp.isfinite(jax_sq_sum(jd))
                    & jnp.isfinite(jnp.float32(0.0) * jax_sq_sum(jo)))
        h = grad_health_plain(to + td)
        n = len(to)
        got = bool(torch.isfinite(torch.tensor(loss))
                   & torch.isfinite(h[0, n:].sum())
                   & torch.isfinite(0.0 * h[0, :n].sum()))
        assert got == want == (poison is None), (where, poison, k)


def test_nan_gives_nan_max_and_counts():
    g = torch.tensor([1.0, -5.0, float("nan"), 2.0, float("inf")])
    h = grad_health_plain([g, torch.tensor([-3.0, 2.0]),
                           torch.empty(0)])
    assert torch.isnan(h[1, 0]) and h[2, 0] == 2 and torch.isnan(h[0, 0])
    assert h[1, 1] == 3.0 and h[0, 1] == 13.0 and h[2, 1] == 0
    assert h[:, 2].eq(0).all()  # an empty tensor: zeros
    jmax = jnp.max(jnp.abs(jnp.asarray(g.numpy())))
    assert np.isnan(np.asarray(jmax))  # as JAX's max


def test_wrapper_refuses_other_devices_and_empty_lists():
    with pytest.raises(ValueError):
        grad_health([])
    with pytest.raises(ValueError, match="unsupported device"):
        grad_health([torch.zeros(3, device="meta")])
