"""The promoted SGD scatter (K18's plain version on the CPU) against the
JAX package's ``SparseSGD.apply_rows`` into a bfloat16 slab with a
float32 lr (what a callable schedule gives), on the same numpy inputs.

JAX computes ``slab.at[ids].add(-lr * vals.astype(bf16))`` with a
float32 update, so XLA converts the whole slab to float32, scatter-adds
in float32 and rounds each element back once. XLA's CPU scatter adds in
stream order, and inside ``_SORT_STREAM_MIN..MAX`` its stable
``sort_key_val`` keeps each row's ids in stream order too, so the port's
stream-order plain version must give JAX's bits: every case here is
held BITWISE (NaN positions compared as NaN). A control case shows the
per-add bfloat16 chain (K3's) would not.

The one order the port does not follow: inside JAX's sort window a
negative id sorts before the non-negative id of the row it wraps onto,
so JAX adds its product first where the port adds in stream order. No
caller sends negative ids there (the trainer's ids are non-negative or
the sentinel); the window case here uses non-negative ids.

The ``DETPU_SGD_DEDUP=1`` branch (sort + segment-sum, then
``(-lr * uvals).astype(slab.dtype)`` into the unique rows) is held
bitwise to JAX's too. ``tests/test_torch_cuda.py`` holds K18 to the
plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import optimizers as jax_opt
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)

from distributed_embeddings_torch.ops import (sgd_scatter,
                                              sgd_scatter_plain,
                                              sgd_scatter_promoted,
                                              sgd_scatter_promoted_plain)
from distributed_embeddings_torch.parallel import SparseSGD

torch.set_num_threads(1)

VALS = {"float32": (jnp.float32, torch.float32),
        "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_slab(slab: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(slab.copy()).to(torch.bfloat16)


def _bits(x) -> np.ndarray:
    """uint16 bits of a bfloat16 torch tensor or JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def assert_bits_equal(got, want):
    """Bitwise bfloat16 equality, a NaN matching any NaN (the payload a
    rounding gives a NaN differs between libraries)."""
    g, w = _bits(got), _bits(want)
    gnan = (g & 0x7FFF) > 0x7F80
    wnan = (w & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(gnan, wnan)
    bad = (g != w) & ~gnan
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} elements differ"


def _jax(slab, ids, vals, lr, vals_dtype):
    out, _ = JaxSparseSGD().apply_rows(
        jnp.asarray(slab, jnp.bfloat16), (), jnp.asarray(ids),
        jnp.asarray(vals, VALS[vals_dtype][0]), jnp.float32(lr))
    return np.asarray(out)


def _port(slab, ids, vals, lr, vals_dtype):
    got = _bf16_slab(slab)
    out, st = SparseSGD().apply_rows(
        got, (), torch.from_numpy(ids),
        torch.from_numpy(vals).to(VALS[vals_dtype][1]),
        torch.tensor(lr, dtype=torch.float32))
    assert out is got and st == ()  # in place
    return got


def _case(seed, R, w, n, hot=0, neg=False, vals_dtype="float32"):
    rng = np.random.default_rng(seed)
    slab = rng.normal(size=(R, w)).astype(np.float32)
    ids = (rng.zipf(1.2, size=n) - 1) % R
    if hot:
        ids[rng.permutation(n)[:hot]] = 3  # one row hit `hot` times more
    if neg:
        ids = np.concatenate([ids, [-1, -R, R, R + 7, -R - 1, 10 ** 6,
                                    R - 1, 0]])
    vals = rng.normal(scale=2.0, size=(len(ids), w)).astype(np.float32)
    return slab, ids.astype(np.int32), vals


@pytest.mark.parametrize("w", [128, 16, 3])
@pytest.mark.parametrize("vals_dtype", ["float32", "bfloat16"])
def test_duplicates_and_a_hot_row_bitwise(w, vals_dtype):
    """Zipfian duplicates, one row hit 5,000 times, at widths 128, 16
    and 3 (bounded to keep the CPU run short at w128)."""
    n = 1_500 if w == 128 else 6_000
    slab, ids, vals = _case(1, 64, w, n, hot=min(5_000, n - 500),
                            vals_dtype=vals_dtype)
    lr = np.float32(0.0123)
    assert np.bincount(ids)[3] >= min(5_000, n - 500)
    want = _jax(slab, ids, vals, lr, vals_dtype)
    got = _port(slab, ids, vals, lr, vals_dtype)
    assert_bits_equal(got, want)
    untouched = np.setdiff1d(np.arange(64), ids)
    assert_bits_equal(got[untouched], _bf16_slab(slab)[untouched])


def test_negative_ids_past_the_slab_and_the_sentinel_bitwise():
    """``-1`` and ``-R`` wrap once (onto rows the stream also hits
    directly), ``R`` (the sentinel), ids past it and ids below ``-R``
    are dropped."""
    slab, ids, vals = _case(2, 40, 16, 300, neg=True)
    lr = np.float32(0.5)
    want = _jax(slab, ids, vals, lr, "float32")
    got = _port(slab, ids, vals, lr, "float32")
    assert_bits_equal(got, want)


def test_empty_stream_leaves_the_slab():
    slab = np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32)
    ids = np.zeros((0,), np.int32)
    vals = np.zeros((0, 16), np.float32)
    want = _jax(slab, ids, vals, np.float32(0.1), "float32")
    got = _port(slab, ids, vals, np.float32(0.1), "float32")
    assert_bits_equal(got, want)
    assert_bits_equal(got, _bf16_slab(slab))


def test_stream_inside_the_sort_window_bitwise():
    """A stream inside ``[_SORT_STREAM_MIN, _SORT_STREAM_MAX]``, where
    JAX sorts the ids first (stable) and scatters sorted: per row the
    order is still the stream's."""
    n = jax_opt._SORT_STREAM_MIN + 4_000
    assert n <= jax_opt._SORT_STREAM_MAX
    slab, ids, vals = _case(4, 5_000, 3, n)
    lr = np.float32(0.037)
    want = _jax(slab, ids, vals, lr, "float32")
    got = _port(slab, ids, vals, lr, "float32")
    assert_bits_equal(got, want)


def test_nan_and_inf_in_a_hit_row():
    """A NaN and an Inf in the slab and in the update rows propagate as
    in JAX's float32 sum; the rest of each row stays exact."""
    slab, ids, vals = _case(5, 16, 16, 200)
    slab[ids[0], 2] = np.nan
    slab[ids[1], 5] = np.inf
    vals[7, 4] = np.inf
    vals[9, 1] = np.nan
    lr = np.float32(0.25)
    want = _jax(slab, ids, vals, lr, "float32")
    got = _port(slab, ids, vals, lr, "float32")
    assert np.isnan(got.float().numpy()).any()
    assert np.isinf(got.float().numpy()).any()
    assert_bits_equal(got, want)


def test_per_add_bfloat16_chain_differs():
    """Control: rounding every add to bfloat16 (K3's chain, what the
    slab dtype alone would give) is NOT what JAX computes here. 1000
    adds of -1e-3 into a row of ones: the promoted sum reaches ~0, the
    bfloat16 chain stalls at 1.0."""
    R, w, n = 4, 8, 1000
    slab = np.ones((R, w), np.float32)
    ids = np.full((n,), 2, np.int32)
    vals = np.ones((n, w), np.float32)
    lr = np.float32(1e-3)
    want = _jax(slab, ids, vals, lr, "float32")
    got = _port(slab, ids, vals, lr, "float32")
    assert_bits_equal(got, want)
    assert abs(float(got[2, 0])) < 1e-3
    chain = _bf16_slab(slab)
    u = (torch.from_numpy(vals[0]) * -1e-3).to(torch.bfloat16)
    for _ in range(n):  # one bfloat16 rounding per add
        chain[2] = chain[2] + u
    assert float(chain[2, 0]) == 1.0
    assert (_bits(chain) != _bits(want)).any()


def test_wrappers_route_and_count():
    """``sgd_scatter`` with a bf16 slab and a tensor lr is the promoted
    chain; a constant lr stays on K3's chain; the CPU runs the plain
    versions and counts no launch; other devices raise."""
    slab, ids, vals = _case(6, 32, 8, 400)
    t_ids, t_vals = torch.from_numpy(ids), torch.from_numpy(vals)
    lr = torch.tensor(0.2)
    before = (sgd_scatter.launches, sgd_scatter_promoted.launches)
    a = sgd_scatter(_bf16_slab(slab), t_ids, t_vals, lr)
    b = sgd_scatter_promoted_plain(_bf16_slab(slab), t_ids, t_vals, lr)
    c = sgd_scatter_plain(_bf16_slab(slab), t_ids, t_vals, lr)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert (sgd_scatter.launches, sgd_scatter_promoted.launches) == before
    const = sgd_scatter(_bf16_slab(slab), t_ids, t_vals, 0.2)
    assert not torch.equal(const, a)
    with pytest.raises(TypeError, match="tensor lr"):
        sgd_scatter_promoted(_bf16_slab(slab), t_ids, t_vals, 0.2)
    with pytest.raises(ValueError, match="unsupported device"):
        sgd_scatter_promoted(
            torch.empty(4, 8, dtype=torch.bfloat16, device="meta"),
            torch.tensor([1], device="meta"),
            torch.empty(1, 8, device="meta"), lr)


@pytest.mark.parametrize("slab_dtype,lr", [
    ("bfloat16", np.float32(0.0123)), ("bfloat16", 0.37),
    ("float32", np.float32(0.0123)), ("float32", 0.37)])
def test_sgd_dedup_branch_bitwise(monkeypatch, slab_dtype, lr):
    """``DETPU_SGD_DEDUP=1``: K5's sums of duplicate rows, then
    ``(-lr * uvals).astype(slab.dtype)`` (one rounding of the float32
    product, the lr a tensor or a constant) added once into each unique
    row. Not the promoted chain: the control below differs. (float32
    rows: K5 sums bfloat16 rows in float32 and rounds once, where JAX's
    segment-sum adds in bfloat16, so bfloat16 rows would test K5's
    order, not this chain.)"""
    vals_dtype = "float32"
    monkeypatch.setenv("DETPU_SGD_DEDUP", "1")
    rng = np.random.default_rng(8)
    R, w, n = 24, 16, 500
    slab = rng.normal(size=(R, w)).astype(np.float32)
    ids = ((rng.zipf(1.3, size=n) - 1) % (R + 1)).astype(np.int32)
    vals = rng.normal(scale=2.0, size=(n, w)).astype(np.float32)
    tensor_lr = isinstance(lr, np.floating)
    js = jnp.bfloat16 if slab_dtype == "bfloat16" else jnp.float32
    ts = torch.bfloat16 if slab_dtype == "bfloat16" else torch.float32
    want, _ = JaxSparseSGD().apply_rows(
        jnp.asarray(slab, js), (), jnp.asarray(ids),
        jnp.asarray(vals, VALS[vals_dtype][0]),
        jnp.float32(lr) if tensor_lr else lr)
    got = torch.from_numpy(slab.copy()).to(ts)
    SparseSGD().apply_rows(got, (), torch.from_numpy(ids),
                           torch.from_numpy(vals).to(VALS[vals_dtype][1]),
                           torch.tensor(float(lr)) if tensor_lr else lr)
    if slab_dtype == "bfloat16":
        assert_bits_equal(got, want)
        if tensor_lr:
            promoted = sgd_scatter_promoted_plain(
                _bf16_slab(slab), torch.from_numpy(ids),
                torch.from_numpy(vals), torch.tensor(float(lr)))
            assert (_bits(promoted) != _bits(got)).any()
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
