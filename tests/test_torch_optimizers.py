"""The port's ``SparseSGD`` (K3's plain version on the CPU) against the
JAX package's ``SparseSGD.apply_rows``, on the same numpy slabs, ids and
update rows.

Tolerances, with their reasons:
  - rows that one id updates: bit-exact (one product rounded as JAX
    rounds it, one add);
  - duplicate ids in float32 with dyadic values (every product and
    partial sum exact): bit-exact, whatever the order of the adds;
  - duplicate ids in bfloat16: each add rounds to bf16 in both packages,
    in another order (and the CPU ``index_add_`` may sum first): a row
    that k ids update is within k bf16 ulps of ``|old| + sum |update|``.
``tests/test_torch_cuda.py`` holds the kernel K3 to the same plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)

from distributed_embeddings_torch.ops import sgd_scatter
from distributed_embeddings_torch.parallel import SparseSGD

from torch_parity import assert_within_ulps, to_np

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(slab, ids, vals, lr, slab_dtype, vals_dtype):
    """Apply one update with each package; returns (jax, port) numpy."""
    js, ts = DTYPES[slab_dtype]
    jv, tv = DTYPES[vals_dtype]
    jlr = jnp.float32(lr) if isinstance(lr, np.ndarray) else lr
    tlr = torch.tensor(lr, dtype=torch.float32) \
        if isinstance(lr, np.ndarray) else lr
    want, _ = JaxSparseSGD().apply_rows(
        jnp.asarray(slab, js), (), jnp.asarray(ids, jnp.int32),
        jnp.asarray(vals, jv), jlr)
    got = torch.from_numpy(slab.copy()).to(ts)
    out, st = SparseSGD().apply_rows(got, (), torch.from_numpy(ids),
                                     torch.from_numpy(vals).to(tv), tlr)
    assert out is got and st == ()  # in place
    return to_np(want), to_np(got)


@pytest.mark.parametrize("slab_dtype,vals_dtype,lr", [
    ("float32", "float32", 0.005), ("bfloat16", "bfloat16", 0.005),
    ("float32", "bfloat16", 0.005), ("bfloat16", "float32", 0.005),
    ("float32", "float32", 0.37), ("bfloat16", "bfloat16", 0.37),
    ("float32", "float32", np.float32(0.013)),
    ("float32", "bfloat16", np.float32(0.013))])
def test_unique_rows_bit_exact(slab_dtype, vals_dtype, lr):
    """One id per row, with the sentinel, ids past the slab and negative
    ids mixed in: bit-exact for every rounding chain (a constant lr
    rounds to the slab dtype first; a float32 tensor lr, what a callable
    schedule gives, does not)."""
    rng = np.random.default_rng(7)
    R, w = 40, 16
    slab = rng.normal(size=(R, w)).astype(np.float32)
    rows = rng.permutation(R)[:24]
    # rows 0..R-1 addressed directly, or from the end (-R..-1)
    ids = np.where(rng.random(24) < 0.3, rows - R, rows)
    ids = np.concatenate([ids, [R, R + 3, 10 ** 6, -R - 1, -10 ** 6]])
    ids = ids.astype(np.int32)
    vals = rng.normal(scale=3.0, size=(len(ids), w)).astype(np.float32)
    want, got = _both(slab, ids, vals, lr, slab_dtype, vals_dtype)
    np.testing.assert_array_equal(got, want)
    untouched = np.setdiff1d(np.arange(R), rows)
    np.testing.assert_array_equal(
        got[untouched], to_np(torch.from_numpy(slab).to(
            DTYPES[slab_dtype][1]))[untouched])


def test_negative_one_wraps_and_out_of_range_drops():
    """JAX indexing: ``-1`` updates the last row, ``-R`` the first; ``R``
    (the dropped-row sentinel), ids past it and ids below ``-R`` train
    nothing."""
    R, w = 4, 8
    ids = np.array([-1, -4, -5, 4, 7], np.int32)
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0], np.float32)[:, None] \
        * np.ones((1, w), np.float32)
    want, got = _both(np.zeros((R, w), np.float32), ids, vals, 1.0,
                      "float32", "float32")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [-2.0, 0.0, 0.0, -1.0])


def test_duplicates_float32_dyadic_exact():
    """Many ids per row; dyadic slab, values and lr keep every product
    and partial sum exact, so any order of the adds gives JAX's bits."""
    rng = np.random.default_rng(3)
    R, w, n = 12, 8, 400
    slab = rng.integers(-64, 64, size=(R, w)).astype(np.float32) / 16
    ids = rng.integers(-R, R + 2, size=n).astype(np.int32)
    vals = rng.integers(-32, 32, size=(n, w)).astype(np.float32) / 8
    want, got = _both(slab, ids, vals, 0.25, "float32", "float32")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vals_dtype", ["bfloat16", "float32"])
def test_duplicates_bfloat16_within_k_ulps(vals_dtype):
    rng = np.random.default_rng(5)
    R, w, n = 16, 16, 600
    slab = rng.normal(size=(R, w)).astype(np.float32)
    ids = (rng.zipf(1.3, size=n) - 1).astype(np.int32) % (R + 2)
    vals = rng.normal(scale=4.0, size=(n, w)).astype(np.float32)
    lr = 0.05
    want, got = _both(slab, ids, vals, lr, "bfloat16", vals_dtype)
    keep = ids < R
    k = np.bincount(ids[keep], minlength=R)[:, None]
    mag = np.zeros((R, w))
    np.add.at(mag, ids[keep], np.abs(lr * vals[keep]))
    old = to_np(torch.from_numpy(slab).to(torch.bfloat16))
    assert k.max() > 50  # hot rows really are hit many times
    assert_within_ulps(got, want, np.abs(old) + mag, k + 0.0,
                       "bf16 duplicate rows")
    np.testing.assert_array_equal(got[k[:, 0] == 0], old[k[:, 0] == 0])


def test_init_matches_jax():
    params = {"w8": torch.zeros(1, 4, 8), "w16": torch.zeros(1, 2, 16)}
    want = JaxSparseSGD().init({k: jnp.zeros(v.shape)
                                for k, v in params.items()})
    assert SparseSGD().init(params) == want
    assert (SparseSGD.needs_dedup, SparseSGD.fresh_row_fill) == (
        JaxSparseSGD.needs_dedup, JaxSparseSGD.fresh_row_fill)


def test_tensor_lr_into_bfloat16_slab_raises():
    """JAX promotes a bf16 slab to f32 for an f32-lr scatter. That call
    raised until the promoted chain (K18) was ported; it now gives JAX's
    bits, duplicates included (``tests/test_torch_promoted_scatter.py``
    holds it in full), and still raises for a device it cannot run on."""
    rng = np.random.default_rng(11)
    R, w = 6, 8
    slab = rng.normal(size=(R, w)).astype(np.float32)
    ids = np.array([1, 1, 4, -1, 1, R], np.int32)
    vals = rng.normal(size=(len(ids), w)).astype(np.float32)
    want, got = _both(slab, ids, vals, np.float32(0.1), "bfloat16",
                      "float32")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported device"):
        SparseSGD().apply_rows(
            torch.empty(4, 8, dtype=torch.bfloat16, device="meta"), (),
            torch.tensor([1], dtype=torch.int32, device="meta"),
            torch.empty(1, 8, device="meta"), torch.tensor(0.1))


def test_sgd_dedup_env_raises(monkeypatch):
    """``DETPU_SGD_DEDUP=1`` (which raised until the dedup kernel K5 was
    ported) now forces the sort + segment-sum pass into ``SparseSGD``: on
    dyadic values, with duplicates and the dropped-row sentinel, the
    forced step equals the default one and JAX's forced step, bit for
    bit (mirrors ``tests/test_sparse_optax.py``'s env-hatch test). The
    dedup keeps at most ``rows + 1`` distinct ids, in both packages, so
    the stream stays within ``[0, rows]``."""
    rng = np.random.default_rng(9)
    R, w, n = 12, 8, 300
    slab = rng.integers(-64, 64, size=(R, w)).astype(np.float32) / 16
    ids = rng.integers(0, R + 1, size=n).astype(np.int32)
    vals = rng.integers(-32, 32, size=(n, w)).astype(np.float32) / 8
    default, _ = _both(slab, ids, vals, 0.25, "float32", "float32")
    monkeypatch.setenv("DETPU_SGD_DEDUP", "1")
    want, got = _both(slab, ids, vals, 0.25, "float32", "float32")
    np.testing.assert_array_equal(got, default)
    np.testing.assert_array_equal(got, want)


def test_cpu_scatter_counts_no_launch_and_other_devices_raise():
    before = sgd_scatter.launches
    sgd_scatter(torch.zeros(4, 8), torch.tensor([1]), torch.ones(1, 8), 0.1)
    assert sgd_scatter.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        sgd_scatter(torch.empty(4, 8, device="meta"),
                    torch.tensor([1], device="meta"),
                    torch.empty(1, 8, device="meta"), 0.1)
