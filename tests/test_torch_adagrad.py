"""The port's dedup (K5's plain version), ``SparseAdagrad`` (K3 + K7 in
the dense-apply regime, K5 + K6 in the sparse one, plain versions on
the CPU) and dense ``Adagrad`` against the JAX package's
``dedup_sparse_grad``, ``SparseAdagrad.apply_rows`` and
``optax.adagrad``, on the same numpy inputs.

Both packages get LOGICAL ``[R, w]`` slabs here, so both compare the
stream with the same row count and pick the same regime; the regime is
forced with ``dense_apply_ratio=None`` (sparse) or a huge ratio (dense).

Tolerances, with their reasons:
  - unique ids: bit-exact, tail included (an integer sort);
  - float32 sums of duplicate rows: within 1e-6 of the sum of |rows|
    (both sum in stable sorted order; the port in fp32 pieces);
  - bfloat16 sums: JAX rounds to bf16 after every add, the port sums in
    fp32 and rounds once: within k bf16 ulps of the sum of |rows| for a
    row that k ids update;
  - Adagrad, float32: accumulators within 1e-6 relative (one sum of
    squares, summed in another order); slab rows within 1e-6 relative of
    ``|slab| + |update|`` (``rsqrt`` rounds differently in XLA and
    PyTorch, by an ulp);
  - Adagrad, bfloat16 (tables, accumulators or both): the duplicate sums
    above carry into ``g*g``; rows within k + 2 bf16 ulps of the largest
    magnitude in the transition (the k-ulp sum, one ulp for ``rsqrt``,
    one for the final rounding);
  - rows no id touches: bitwise unchanged in both packages;
  - dense ``Adagrad``: within 1e-6 relative (``rsqrt`` as above).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.ops.sparse_grad import (
    dedup_sparse_grad as jax_dedup)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad)

from distributed_embeddings_torch.ops import (adagrad_dense, adagrad_rows,
                                              dedup_sparse_grad)
from distributed_embeddings_torch.parallel import Adagrad, SparseAdagrad

from torch_parity import assert_within_ulps, to_np

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _stream(seed, rows, n, w, bad=True):
    """Zipfian ids into ``rows`` (hot rows repeat), with the sentinel,
    ids past it and (``bad``) negative ids mixed in; N(0, 1) rows."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.2, size=n) - 1) % rows
    if bad:
        flip = rng.random(n) < 0.05
        ids = np.where(flip, rng.choice([rows, rows + 7, -3, -rows - 2],
                                        size=n), ids)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    return ids.astype(np.int32), vals


def _dedup_both(ids, vals, dtype, pad_id, valid=None, max_unique=None,
                ids_dtype=torch.int32):
    jdt, tdt = DTYPES[dtype]
    ju, jg = jax_dedup(jnp.asarray(ids), jnp.asarray(vals, jdt),
                       pad_id=pad_id,
                       valid=None if valid is None else jnp.asarray(valid),
                       max_unique=max_unique)
    tu, tg = dedup_sparse_grad(
        torch.from_numpy(ids).to(ids_dtype), torch.from_numpy(vals).to(tdt),
        pad_id=pad_id,
        valid=None if valid is None else torch.from_numpy(valid),
        max_unique=max_unique)
    assert tu.dtype == ids_dtype and tg.dtype == tdt
    return (np.asarray(ju), to_np(jg)), (to_np(tu), to_np(tg))


def _sum_scale(ids_sorted_unique, ids, vals, u):
    """Per output row: (sum of |rows|, number of rows) of its id."""
    mag = np.zeros((u, vals.shape[1]))
    cnt = np.zeros((u, 1))
    for k, i in enumerate(ids_sorted_unique[:u]):
        hit = ids == i
        mag[k] = np.abs(vals[hit]).sum(0)
        cnt[k] = hit.sum()
    return mag, cnt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_dedup_matches_jax(dtype, ids_dtype):
    rows, w = 40, 16
    ids, vals = _stream(1, rows, 700, w)
    (ju, jg), (tu, tg) = _dedup_both(ids, vals, dtype, pad_id=rows,
                                     ids_dtype=ids_dtype)
    np.testing.assert_array_equal(tu, ju)
    distinct = np.unique(ids)
    np.testing.assert_array_equal(tu[:len(distinct)], distinct)
    assert (tu[len(distinct):] == rows).all()
    mag, cnt = _sum_scale(tu, ids, vals, len(tu))
    assert cnt.max() > 100  # hot rows really repeat
    if dtype == "float32":
        np.testing.assert_array_less(np.abs(tg - jg), 1e-6 * mag + 1e-30)
    else:
        assert_within_ulps(tg, jg, mag, cnt, "bf16 duplicate sums")


def test_dedup_valid_and_max_unique_tail():
    """``valid=False`` entries become ``pad_id`` before the sort; with
    ``max_unique`` below the distinct count, the largest ids drop and the
    outputs shrink to ``U = max_unique``."""
    rows, w = 30, 8
    ids, vals = _stream(2, rows, 300, w, bad=False)
    valid = np.random.default_rng(3).random(300) < 0.8
    (ju, jg), (tu, tg) = _dedup_both(ids, vals, "float32", pad_id=rows,
                                     valid=valid)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    kept = np.unique(np.where(valid, ids, rows))
    assert tu[len(kept) - 1] == rows  # the masked entries' segment
    n_distinct = len(np.unique(ids))
    cap = n_distinct - 4
    (ju, jg), (tu, tg) = _dedup_both(ids, vals, "float32", pad_id=rows,
                                     max_unique=cap)
    assert tu.shape == (cap,) and tg.shape == (cap, w)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tu, np.unique(ids)[:cap])
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    # a bound above the stream length: U = n, pad tail of zero rows
    (ju, jg), (tu, tg) = _dedup_both(ids[:20], vals[:20], "float32",
                                     pad_id=rows, max_unique=rows + 1)
    assert tu.shape == (20,)
    np.testing.assert_array_equal(tu, ju)
    tail = tu == rows
    assert tail.any() and (tg[tail] == 0).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)


def test_dedup_cpu_counts_no_launch_and_other_devices_raise():
    before = dedup_sparse_grad.launches
    dedup_sparse_grad(torch.tensor([3, 1, 3]), torch.ones(3, 4), pad_id=5)
    assert dedup_sparse_grad.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        dedup_sparse_grad(torch.empty(3, dtype=torch.int32, device="meta"),
                          torch.empty(3, 4, device="meta"), pad_id=5)


# ------------------------------------------------------------ SparseAdagrad

PAIRS = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
         "bf16_f32acc": ("bfloat16", "float32")}
REGIMES = {"sparse": None, "dense": 1e9}


def _adagrad_both(slab, acc, ids, vals, lr, pair, regime):
    """One ``apply_rows`` in each package; returns numpy
    ``(jax_slab, jax_acc), (port_slab, port_acc), port tensors``."""
    sd, ad = PAIRS[pair]
    jsd, tsd = DTYPES[sd]
    jad, tad = DTYPES[ad]
    ratio = REGIMES[regime]
    device_lr = isinstance(lr, np.floating)  # a float32 lr on the device
    jlr = jnp.float32(lr) if device_lr else lr
    tlr = torch.tensor(lr, dtype=torch.float32) if device_lr else lr
    js, ja = JaxSparseAdagrad(dense_apply_ratio=ratio).apply_rows(
        jnp.asarray(slab, jsd), jnp.asarray(acc, jad), jnp.asarray(ids),
        jnp.asarray(vals, jsd), jlr)
    ts = torch.from_numpy(slab.copy()).to(tsd)
    ta = torch.from_numpy(acc.copy()).to(tad)
    opt = SparseAdagrad(dense_apply_ratio=ratio)
    assert opt.dense_apply(slab.shape[0], len(ids)) == (regime == "dense")
    out_s, out_a = opt.apply_rows(ts, ta, torch.from_numpy(ids),
                                  torch.from_numpy(vals).to(tsd), tlr)
    assert out_s is ts and out_a is ta  # in place
    return (to_np(js), to_np(ja)), (to_np(ts), to_np(ta))


def _written_rows(ids, rows):
    """The rows a stream writes (a negative id counts from the end
    once; ids outside [-rows, rows) write nothing)."""
    w = np.where(ids < 0, ids + rows, ids)
    return np.unique(w[(w >= 0) & (w < rows)])


@pytest.mark.parametrize("regime", ["sparse", "dense"])
@pytest.mark.parametrize("pair", ["f32", "bf16", "bf16_f32acc"])
def test_sparse_adagrad_matches_jax(pair, regime):
    rng = np.random.default_rng(11)
    rows, w, n = 48, 16, 600
    ids, vals = _stream(12, rows, n, w, bad=False)
    ids = np.concatenate([ids, [rows, rows + 9]]).astype(np.int32)
    vals = np.concatenate([vals, rng.normal(size=(2, w))]).astype(
        np.float32) * 0.5
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    acc = (0.1 + rng.random((rows, w))).astype(np.float32)
    (js, ja), (ts, ta) = _adagrad_both(slab, acc, ids, vals, 0.05, pair,
                                       regime)
    hit = _written_rows(ids, rows)
    untouched = np.setdiff1d(np.arange(rows), hit)
    sd, ad = PAIRS[pair]
    old_s = to_np(torch.from_numpy(slab).to(DTYPES[sd][1]))
    old_a = to_np(torch.from_numpy(acc).to(DTYPES[ad][1]))
    for got, want, old in ((ts, js, old_s), (ta, ja, old_a)):
        np.testing.assert_array_equal(got[untouched], old[untouched])
        np.testing.assert_array_equal(want[untouched], old[untouched])
    assert (ts[hit] != old_s[hit]).any()
    k = np.bincount(ids[(ids >= 0) & (ids < rows)], minlength=rows)[:, None]
    if pair == "f32":
        np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=0)
        np.testing.assert_array_less(np.abs(ts - js),
                                     1e-6 * (np.abs(js) + 0.05) + 1e-30)
        return
    mag = np.zeros((rows, w))
    np.add.at(mag, ids[ids < rows], np.abs(vals[ids < rows]))
    if ad == "bfloat16":
        assert_within_ulps(ta, ja, old_a + mag * mag, k + 2.0,
                           "bf16 accumulators")
    else:
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=0)
    assert_within_ulps(ts, js, np.abs(old_s) + 0.05, k + 2.0, "bf16 slab")


@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_sparse_adagrad_tensor_lr_matches_jax(regime):
    """A float32 device lr (a callable schedule's) promotes the update
    products to float32 in both packages."""
    rng = np.random.default_rng(13)
    rows, w = 32, 8
    ids, vals = _stream(14, rows, 200, w, bad=False)
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    acc = np.full((rows, w), 0.1, np.float32)
    for pair in ("f32", "bf16_f32acc", "bf16"):
        (js, ja), (ts, ta) = _adagrad_both(slab, acc, ids, vals,
                                           np.float32(0.013), pair, regime)
        k = np.bincount(ids, minlength=rows)[:, None]
        if pair == "f32":
            np.testing.assert_allclose(ta, ja, rtol=1e-6)
            np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-7)
        else:
            assert_within_ulps(ts, js, np.abs(slab) + 0.013, k + 2.0,
                               f"{pair} slab, tensor lr")


@pytest.mark.parametrize("regime", ["sparse", "dense"])
def test_sparse_adagrad_negative_ids_match_jax(regime):
    """Ids given straight to ``apply_rows``: in the sparse regime JAX
    reads a negative id's accumulator at row 0 (``take(mode="clip")``)
    and writes row ``id + rows`` (``mode="drop"`` wraps once); in the
    dense-apply regime its scatter-sum wraps the id once. Ids below
    ``-rows`` and at or past ``rows`` train nothing. The port matches
    both (negative ids whose wrapped row the stream does not also hit)."""
    rows, w = 10, 8
    ids = np.array([-1, -1, -3, 2, 2, 4, -11, 10, 13], np.int32)
    vals = np.arange(len(ids) * w, dtype=np.float32).reshape(-1, w) / 16
    slab = np.linspace(-1, 1, rows * w, dtype=np.float32).reshape(rows, w)
    acc = np.linspace(0.1, 2.0, rows * w, dtype=np.float32).reshape(rows, w)
    (js, ja), (ts, ta) = _adagrad_both(slab, acc, ids, vals, 0.5, "f32",
                                       regime)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-7)
    for r in (0, 1, 3, 5, 6, 8):
        assert (ts[r] == slab[r]).all() and (ta[r] == acc[r]).all()
    # row 9 (-1) and row 7 (-3) trained; in the sparse regime from row 0's
    # accumulator
    g = vals[0] + vals[1]
    base = acc[0] if regime == "sparse" else acc[9]
    np.testing.assert_allclose(ta[9], base + g * g, rtol=1e-6)


def test_sparse_adagrad_init_and_cpu_kernels_count_no_launch():
    params = {"w8": torch.zeros(1, 4, 8), "w16": torch.zeros(
        1, 2, 16, dtype=torch.bfloat16)}
    st = SparseAdagrad().init(params)
    want = JaxSparseAdagrad().init({
        "w8": jnp.zeros((1, 4, 8)),
        "w16": jnp.zeros((1, 2, 16), jnp.bfloat16)})
    for k in params:
        assert st[k].dtype == params[k].dtype
        assert st[k].shape == params[k].shape
        np.testing.assert_array_equal(to_np(st[k]), to_np(want[k]))
    assert float(st["w8"][0, 0, 0]) == pytest.approx(0.1)
    assert (SparseAdagrad.needs_dedup, SparseAdagrad().fresh_row_fill) == (
        JaxSparseAdagrad.needs_dedup, JaxSparseAdagrad().fresh_row_fill)
    before = (adagrad_rows.launches, adagrad_dense.launches)
    SparseAdagrad(dense_apply_ratio=None).apply_rows(
        torch.zeros(4, 8), torch.full((4, 8), 0.1),
        torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 8), 0.1)
    SparseAdagrad().apply_rows(
        torch.zeros(4, 8), torch.full((4, 8), 0.1),
        torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 8), 0.1)
    assert (adagrad_rows.launches, adagrad_dense.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        adagrad_rows(torch.empty(4, 8, device="meta"),
                     torch.empty(4, 8, device="meta"),
                     torch.zeros(1, dtype=torch.int32, device="meta"),
                     torch.empty(1, 8, device="meta"), 0.1, 1e-7)


# ------------------------------------------------------------ dense Adagrad


def test_dense_adagrad_matches_optax():
    """Three updates of two parameters (a zero gradient entry included)
    against ``optax.adagrad``; the state comes back new, never mutated."""
    rng = np.random.default_rng(21)
    shapes = [(5, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.adagrad(0.07)
    jst = tx.init([jnp.asarray(p) for p in params])
    opt = Adagrad(0.07)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tst = opt.init(tparams)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads[0][1, 2] = 0.0
        jupd, jst = tx.update([jnp.asarray(g) for g in grads], jst)
        prev, snap = tst, [t.clone() for t in tst]
        tupd, tst = opt.update([torch.from_numpy(g) for g in grads], tst)
        for a, b in zip(prev, snap):
            assert torch.equal(a, b)  # the old state is not mutated
        for got, want in zip(tupd, jupd):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
        for got, want in zip(tst, jst[0].sum_of_squares):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
