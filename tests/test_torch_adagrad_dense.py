"""``SparseAdagrad``'s dense-apply branch in the port (its CPU path: the
slab-wide chain, the plain version of the card's one engine call) against
the JAX package's ``SparseAdagrad.apply_rows`` with a huge
``dense_apply_ratio``, on the same numpy inputs; which path the constants
select; the launch records of the engine's Adagrad mode and of K7.

The streams hold one row hit 300 times (more than the engine's chunk L =
256, so the card sums it in chunks), negative ids, ids past the slab and
the dropped-row sentinel, and leave a third of the rows untouched.

Tolerances, with their reasons:
  - accumulators: bit for bit. Both packages sum each row in stream
    order, rounding every add to the accumulator dtype, and square and
    add with the same roundings;
  - slab rows: XLA's CPU ``rsqrt`` is an approximation (an ulp off the
    correctly rounded value for some inputs), so the touched rows are
    held within 1e-6 of ``|slab| + lr`` (float32 slabs) or 2 bf16 ulps of
    it (bfloat16 slabs), as ``tests/test_torch_wrapped_rows.py`` holds
    the sparse regime;
  - untouched rows: bit for bit in both packages (unchanged), except
    where ``eps = 0`` over a zero accumulator: JAX writes NaN into every
    untouched element and the port must write NaN into the same ones;
  - restricting the transition to the hit rows (what the card does) is
    bit for bit the slab-wide chain wherever
    ``ops.adagrad.untouched_rows_keep_bits`` holds, and differs from it
    on the constants it refuses.

Each bound has a control that must fail it: the stream without one hit
of the chunked row (accumulators), a slab row 32 float32 (4 bf16) ulps
off (slab rows), the fused path forced where the constants refuse it (NaNs and
signed zeros). Record keys, constants and raises are exact.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad)

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import adagrad as ada
from distributed_embeddings_torch.ops import (adagrad_dense,
                                              adagrad_dense_plain,
                                              adagrad_dense_scatter,
                                              adagrad_dense_scatter_plain,
                                              sgd_scatter_plain)
from distributed_embeddings_torch.parallel import SparseAdagrad

from torch_parity import assert_within_ulps, to_np

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PAIRS = {"f32": ("float32", "float32"),
         "bf16_f32acc": ("bfloat16", "float32"),
         "bf16": ("bfloat16", "bfloat16")}
ROWS, W, HOT, HOT_HITS = 60, 8, 5, 300
LR = 0.05


def _stream(seed, rows=ROWS, w=W):
    """A shuffled stream into the first two thirds of the rows: 400
    random ids, row HOT hit 300 more times, -3 and -rows (rows R - 3 and
    0), the sentinel ``rows``, an id past it and one below -rows."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, 2 * rows // 3, 400),
                          np.full(HOT_HITS, HOT),
                          [-3, -rows, rows, rows + 7, -rows - 2]])
    ids = rng.permutation(ids).astype(np.int32)
    vals = (rng.normal(size=(len(ids), w)) * 0.5).astype(np.float32)
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    return rng, ids, vals, slab


def _hit_rows(ids, rows=ROWS):
    r = np.where(ids < 0, ids + rows, ids)
    return np.unique(r[(r >= 0) & (r < rows)])


def _both(slab, acc, ids, vals, lr, pair, init=0.1, eps=1e-7):
    """One dense-apply ``apply_rows`` in each package (numpy in and out:
    ``(jax_slab, jax_acc), (port_slab, port_acc)``)."""
    sd, ad = PAIRS[pair]
    (jsd, tsd), (jad, tad) = DTYPES[sd], DTYPES[ad]
    device_lr = isinstance(lr, np.floating)  # a float32 lr on the device
    js, ja = JaxSparseAdagrad(initial_accumulator_value=init, eps=eps,
                              dense_apply_ratio=1e9).apply_rows(
        jnp.asarray(slab, jsd), jnp.asarray(acc, jad), jnp.asarray(ids),
        jnp.asarray(vals, jsd), jnp.float32(lr) if device_lr else lr)
    ts = torch.from_numpy(slab.copy()).to(tsd)
    ta = torch.from_numpy(acc.copy()).to(tad)
    opt = SparseAdagrad(initial_accumulator_value=init, eps=eps,
                        dense_apply_ratio=1e9)
    assert opt.dense_apply(slab.shape[0], len(ids))
    opt.apply_rows(ts, ta, torch.from_numpy(ids),
                   torch.from_numpy(vals).to(tsd),
                   torch.tensor(lr, dtype=torch.float32) if device_lr
                   else lr)
    return (to_np(js), to_np(ja)), (to_np(ts), to_np(ta))


def _slab_close(got, want, old, lr, slab_dtype, what):
    scale = np.abs(old) + lr
    if slab_dtype == "float32":
        bad = np.abs(got - want) > 1e-6 * scale
        assert not bad.any(), (f"{what}: {int(bad.sum())} slab values "
                               f"beyond 1e-6 of |slab| + lr")
    else:
        assert_within_ulps(got, want, scale, 2.0, what)


LRS = {"constant": LR, "device": np.float32(0.013)}


@pytest.mark.parametrize("lr", sorted(LRS))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_dense_apply_matches_jax(pair, lr):
    """The default constants (the fused path on the card): accumulators
    bit for bit, slab rows within the rsqrt bound, untouched rows
    unchanged in both packages, the chunked row trained."""
    lr = LRS[lr]
    rng, ids, vals, slab = _stream(1)
    acc = (0.1 + rng.random((ROWS, W))).astype(np.float32)
    sd, ad = PAIRS[pair]
    assert ada.untouched_rows_keep_bits(
        0.1, 1e-7, DTYPES[ad][1],
        torch.tensor(lr) if isinstance(lr, np.floating) else lr)
    (js, ja), (ts, ta) = _both(slab, acc, ids, vals, lr, pair)
    np.testing.assert_array_equal(ta, ja)
    old = to_np(torch.from_numpy(slab).to(DTYPES[sd][1]))
    _slab_close(ts, js, old, float(lr), sd, pair)
    hit = _hit_rows(ids)
    untouched = np.setdiff1d(np.arange(ROWS), hit)
    assert len(untouched) >= ROWS // 4 and HOT in hit
    for got in (ts, js):
        np.testing.assert_array_equal(got[untouched], old[untouched])
    assert (ts[HOT] != old[HOT]).all()


def test_dense_apply_accumulator_control_fails():
    """The accumulator check is not blind: the stream without one of the
    chunked row's 300 hits moves that row's accumulator."""
    rng, ids, vals, slab = _stream(1)
    acc = (0.1 + rng.random((ROWS, W))).astype(np.float32)
    (_, ja), _ = _both(slab, acc, ids, vals, LR, "f32")
    drop = np.flatnonzero(ids == HOT)[-1]
    keep = np.arange(len(ids)) != drop
    _, (_, ta) = _both(slab, acc, ids[keep], vals[keep], LR, "f32")
    assert (ta[HOT] != ja[HOT]).any()
    others = np.arange(ROWS) != HOT
    np.testing.assert_array_equal(ta[others], ja[others])


@pytest.mark.parametrize("slab_dtype", ["float32", "bfloat16"])
def test_dense_apply_slab_control_fails(slab_dtype):
    """The slab bound is not blind: a row 32 float32 ulps (4 bf16 ulps)
    of ``|slab| + lr`` off fails it (1e-6 of it is 8.4 to 16.8 float32
    ulps)."""
    rng, ids, vals, slab = _stream(2)
    acc = (0.1 + rng.random((ROWS, W))).astype(np.float32)
    pair = "f32" if slab_dtype == "float32" else "bf16_f32acc"
    (js, _), (ts, _) = _both(slab, acc, ids, vals, LR, pair)
    old = to_np(torch.from_numpy(slab).to(DTYPES[slab_dtype][1]))
    _slab_close(ts, js, old, LR, slab_dtype, "unperturbed")
    mant = 23 if slab_dtype == "float32" else 7
    off = 32 if slab_dtype == "float32" else 4
    scale = np.abs(old[HOT]) + LR
    bad = ts.copy()
    bad[HOT] += off * 2.0 ** (np.floor(np.log2(scale)) - mant)
    with pytest.raises(AssertionError):
        _slab_close(bad, js, old, LR, slab_dtype, "perturbed")


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_eps0_zero_accumulator_matches_jax_nans(pair):
    """``eps = 0`` over a zero accumulator: JAX's slab-wide transition
    gives ``lr * 0 * rsqrt(0) = NaN`` on every untouched element; the
    constants select the port's slab-wide chain, which writes NaN into
    the same elements; accumulators bit for bit; the touched rows within
    the rsqrt bound."""
    _, ids, vals, slab = _stream(3)
    acc = np.zeros((ROWS, W), np.float32)
    sd, ad = PAIRS[pair]
    assert not ada.untouched_rows_keep_bits(0.0, 0.0, DTYPES[ad][1], LR)
    (js, ja), (ts, ta) = _both(slab, acc, ids, vals, LR, pair, init=0.0,
                               eps=0.0)
    np.testing.assert_array_equal(np.isnan(ts), np.isnan(js))
    untouched = np.setdiff1d(np.arange(ROWS), _hit_rows(ids))
    assert np.isnan(js[untouched]).all()
    np.testing.assert_array_equal(ta, ja)
    ok = ~np.isnan(js)
    old = to_np(torch.from_numpy(slab).to(DTYPES[sd][1]))
    _slab_close(ts[ok], js[ok], old[ok], LR, sd, pair)


def _hit_rows_only(slab, acc, ids, vals, lr, eps):
    """What the card's engine call does, in PyTorch: the zero gradient
    slab and the scatter-sum, then the transition of the hit rows only."""
    g = sgd_scatter_plain(torch.zeros(slab.shape, dtype=acc.dtype), ids,
                          vals, -1.0)
    r = ids.long()
    r = torch.where(r < 0, r + slab.shape[0], r)
    hit = torch.unique(r[(r >= 0) & (r < slab.shape[0])])
    s, a = slab[hit].clone(), acc[hit].clone()
    adagrad_dense_plain(s, a, g[hit].clone(), lr, eps)
    slab[hit], acc[hit] = s, a
    return slab, acc


#: (initial accumulator, eps, lr): whether the slab-wide transition keeps
#: every untouched element's bits
SELECTION = [
    (0.1, 1e-7, 0.05, True), (0.0, 1e-7, 0.05, True),
    (0.0, 1e-7, 0.0, True), (1e-30, 0.0, 0.05, True),
    (0.0, 0.0, 0.05, False), (-0.0, 1e-7, 0.05, False),
    (-0.5, 1e-7, 0.05, False), (0.1, -0.1, 0.05, False),
    (0.1, -0.2, 0.05, False), (math.nan, 1e-7, 0.05, False),
    (0.1, 1e-7, -0.05, False), (0.1, 1e-7, -0.0, False),
    (0.0, 1e-45, 0.05, None),  # rounds to 0 in bfloat16, not in float32
]


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init,eps,lr,want", SELECTION)
def test_path_selection_from_constants(init, eps, lr, want, acc_dtype):
    """Which path each set of constants selects (a pure function, no
    launch), and that the choice is right: on a slab with -0.0 elements
    and accumulators at their initial value, the transition of the hit
    rows only gives the slab-wide chain's bits exactly where it is
    selected, and differs (a NaN or a signed zero) where it is not."""
    if want is None:
        want = acc_dtype == torch.float32
    before = (adagrad_dense_scatter.launches, adagrad_dense.launches)
    got = ada.untouched_rows_keep_bits(init, eps, acc_dtype, lr)
    assert got is want
    assert (adagrad_dense_scatter.launches, adagrad_dense.launches) == before
    # a tensor lr is never read on the host
    assert ada.untouched_rows_keep_bits(init, eps, acc_dtype,
                                        torch.tensor(-1.0)) is (
        ada.untouched_rows_keep_bits(init, eps, acc_dtype, 1.0))
    _, ids, vals, slab = _stream(4)
    slab[ROWS - 10:] = -0.0
    s0 = torch.from_numpy(slab).to(torch.float32)
    a0 = torch.full((ROWS, W), init, dtype=acc_dtype)
    v = torch.from_numpy(vals).to(acc_dtype)
    t = torch.from_numpy(ids)
    full = adagrad_dense_scatter_plain(s0.clone(), a0.clone(), t, v, lr, eps)
    part = _hit_rows_only(s0.clone(), a0.clone(), t, v, lr, eps)
    same = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x.view(torch.int16),
                           y.view(torch.int32) if y.dtype == torch.float32
                           else y.view(torch.int16))
               for x, y in zip(full, part))
    assert same is want


def test_cpu_wrapper_runs_the_slab_wide_chain():
    """The fused wrapper on CPU tensors is the slab-wide chain (a zero
    gradient slab, the stream-order scatter-sum, K7's plain version) bit
    for bit, counts no launch and builds no record; ``SparseAdagrad``
    calls it (and not K3 + K7) where the constants select it."""
    rng, ids, vals, slab = _stream(5)
    acc = (0.1 + rng.random((ROWS, W))).astype(np.float32)
    s, a = torch.from_numpy(slab.copy()), torch.from_numpy(acc.copy())
    t, v = torch.from_numpy(ids), torch.from_numpy(vals)
    before = (adagrad_dense_scatter.launches, ada._SCATTER.builds)
    adagrad_dense_scatter(s, a, t, v, LR, 1e-7)
    assert (adagrad_dense_scatter.launches, ada._SCATTER.builds) == before
    g = torch.zeros(ROWS, W)
    sgd_scatter_plain(g, t, v, -1.0)
    ws, wa = adagrad_dense_plain(torch.from_numpy(slab.copy()),
                                 torch.from_numpy(acc.copy()), g, LR, 1e-7)
    assert torch.equal(s, ws) and torch.equal(a, wa)
    from distributed_embeddings_torch.parallel import optimizers

    calls = []
    real = optimizers.adagrad_dense_scatter
    optimizers.adagrad_dense_scatter = lambda *x: calls.append(x) or real(*x)
    try:
        SparseAdagrad(dense_apply_ratio=1e9).apply_rows(
            torch.from_numpy(slab.copy()), torch.from_numpy(acc.copy()), t,
            v, LR)
        SparseAdagrad(initial_accumulator_value=0.0, eps=0.0,
                      dense_apply_ratio=1e9).apply_rows(
            torch.from_numpy(slab.copy()), torch.zeros(ROWS, W), t, v, LR)
    finally:
        optimizers.adagrad_dense_scatter = real
    assert len(calls) == 1


# ------------------------------------------------------ the launch records


def _fused_args(seed=0, R=50, w=8, n=40, dt=torch.float32,
                sdt=torch.float32, ids=torch.int32, lr=0.01, eps=1e-7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((R, w), generator=g).to(sdt),
            torch.full((R, w), 0.1, dtype=dt),
            torch.randint(-R, R + 2, (n,), generator=g).to(ids),
            torch.randn((n, w), generator=g).to(dt), lr, eps)


def _dense_args(seed=0, R=50, w=8, dt=torch.float32, sdt=torch.float32,
                lr=0.01, eps=1e-7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((R, w), generator=g).to(sdt),
            torch.full((R, w), 0.1, dtype=dt),
            torch.randn((R, w), generator=g).to(dt), lr, eps)


RECORDS = {"fused": (_fused_args, ada.scatter_record_key,
                     ada.build_scatter_record, 4),
           "k7": (_dense_args, ada.dense_record_key,
                  ada.build_dense_record, 3)}


def _find(cache, which, *args):
    _, key, build, _ = RECORDS[which]
    return _kernels.find_or_build(cache, key(*args), build, True, True,
                                  *args)


@pytest.mark.parametrize("which", sorted(RECORDS))
def test_record_key_holds_no_addresses_and_fresh_tensors_hit(which):
    make, key, _, nt = RECORDS[which]
    cache = _kernels.LaunchCache()
    a, b = make(0), make(1)
    assert key(*a) == key(*b)
    ptrs = {t.data_ptr() for t in a[:nt] + b[:nt]}
    assert not ptrs & {k for k in key(*a) if isinstance(k, int)}
    rec = _find(cache, which, *a)
    assert _find(cache, which, *b) is rec and cache.builds == 1
    assert rec.calls == ()
    lr1, lr2 = torch.tensor(0.01), torch.tensor(0.5)
    k1 = key(*make(lr=lr1))
    assert k1 == key(*make(lr=lr2)) and lr1.data_ptr() not in k1


CHANGES = {
    "fused": [dict(w=16), dict(R=51), dict(n=41), dict(dt=torch.bfloat16),
              dict(sdt=torch.bfloat16), dict(ids=torch.int64),
              dict(lr=0.02), dict(eps=1e-6), dict(lr=torch.tensor(0.01)),
              dict(lr=torch.tensor(0.01, dtype=torch.float64))],
    "k7": [dict(w=16), dict(R=51), dict(dt=torch.bfloat16),
           dict(sdt=torch.bfloat16), dict(lr=0.02), dict(eps=1e-6),
           dict(lr=torch.tensor(0.01)),
           dict(lr=torch.tensor(0.01, dtype=torch.float64))]}


@pytest.mark.parametrize("which,change", [
    (w, c) for w in sorted(CHANGES) for c in CHANGES[w]])
def test_record_changed_layout_or_constant_builds_a_new_record(which,
                                                               change):
    make = RECORDS[which][0]
    cache = _kernels.LaunchCache()
    _find(cache, which, *make())
    _find(cache, which, *make(**change))
    assert cache.builds == 2
    _find(cache, which, *make(seed=3))
    assert cache.builds == 2


@pytest.mark.parametrize("which", sorted(RECORDS))
@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
def test_record_constants_are_the_roundings_of_lr_args(which, acc):
    make = RECORDS[which][0]
    for lr, eps in ((0.01, 1e-7), (0.3, 1e-10), (1.0 / 3.0, 0.1)):
        rec = _find(_kernels.LaunchCache(), which,
                    *make(dt=acc, lr=lr, eps=eps))
        lr_as_is, c = rec.payload[:2]
        assert lr_as_is and rec.payload[-1] is None
        assert c == {"lr": ada._lr_args(lr, acc, "cpu")[0],
                     "eps": float(torch.tensor(eps, dtype=acc))}
        if acc == torch.bfloat16:
            assert c["lr"] != lr
    for lr, as_is in ((torch.tensor(0.01), True),
                      (torch.tensor(0.01, dtype=torch.float64), False),
                      (torch.full((1, 1), 0.01), True)):
        rec = _find(_kernels.LaunchCache(), which, *make(dt=acc, lr=lr))
        assert rec.payload[0] is as_is and rec.payload[1]["lr"] == 0.0


def test_fused_record_validates_and_raises():
    def raises(match, changes):
        args = list(_fused_args())
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            ada.find_scatter_record(*args, build_on_cpu=True)

    raises("slab: expected a contiguous 2-D", {0: torch.zeros(8, 50).t()})
    raises("acc: expected a contiguous 2-D",
           {1: torch.zeros(50, 8, dtype=torch.float64)})
    raises("must share the slab's shape", {1: torch.zeros(50, 4)})
    raises("uids: expected a contiguous", {2: torch.zeros(40)})
    raises("vals: expected a contiguous", {3: torch.zeros(40, 4)})
    raises("vals: expected a contiguous",
           {3: torch.zeros(40, 8, dtype=torch.bfloat16)})
    raises("a tensor lr must hold one value", {4: torch.ones(2)})
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        adagrad_dense_scatter(m, m, torch.zeros(2, dtype=torch.int32,
                                                device="meta"),
                              torch.zeros(2, 8, device="meta"), 0.1, 1e-7)


def test_k7_record_validates_and_raises():
    def raises(match, changes):
        args = list(_dense_args())
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            ada.find_dense_record(*args, build_on_cpu=True)

    raises("slab: expected a contiguous 2-D", {0: torch.zeros(8, 50).t()})
    raises("acc: expected a contiguous 2-D",
           {1: torch.zeros(50, 8, dtype=torch.float64)})
    raises(r"acc \(50, 4\) != slab", {1: torch.zeros(50, 4)})
    raises("grad: expected a contiguous", {2: torch.zeros(50, 8).to(
        torch.bfloat16)})
    raises("a tensor lr must hold one value", {3: torch.ones(2)})
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        adagrad_dense(m, m, m, 0.1, 1e-7)
