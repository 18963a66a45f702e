"""The port's lazy ``SparseAdam`` and ``SparseMomentum`` (K5 then K11 /
K12; their plain versions on the CPU), its dense ``Adam`` and momentum
``SGD``, and their state in the converter and the guard, against the
JAX package's ``SparseAdam``/``SparseMomentum.apply_rows``, ``optax.adam``
and ``optax.sgd(momentum=...)``, on the same numpy inputs.

Tolerances, with their reasons:
  - the row updates on the same dedup'd rows (JAX's dedup output fed to
    ``adam_rows_plain`` / ``momentum_rows_plain``): bit-exact, moments,
    traces and slabs, float32 and bfloat16, a constant and a device lr.
    Every op repeats eager JAX's op and rounding in order; the one op
    that could differ, ``b**t`` (``torch.pow`` against XLA's ``pow``), is
    equal at the counts tested (1 and 1000);
  - whole ``apply_rows`` on a stream with duplicates: the dedup sums
    differ (the port sums in float32 once, JAX in the moment dtype, in
    its order; ``test_torch_adagrad.py``). Moments within 1e-6 (float32)
    or k + 2 bf16 ulps (bfloat16, k the ids a row sums) of ``mag +
    mag^2 + |state|``, mag the sum of |rows| (``nu`` carries g^2).
    Adam's step is sign-like (at the first step ``mu_hat /
    sqrt(nu_hat) = g / |g|``), so an element whose ``mu`` lies within
    four times its bound of zero may step the other way: at most
    2 lr there (counted and printed: 2 of 2 x 768 in the bfloat16 Adam
    stream, none elsewhere; at most 1% allowed), else within
    1e-6 of ``|slab| + lr`` (float32) or lr/8 + 2 bf16 ulps of ``|slab|``
    (bfloat16: mu and nu each carry their own bf16 roundings);
  - JAX's lane-packed width 16 with its lane mask against the port's
    logical rows: the unpacked state and slab within 1e-6 relative
    (dedup sums of the same rows in another order);
  - lazy semantics: rows no id touches keep their params and state
    bitwise, in both packages;
  - every row touched: the port's sparse and dense optimizers against
    ``optax`` within 1e-6 relative (2e-4 for the sparse ones against the
    dense autodiff oracle, as the JAX package's own test);
  - the capped tiny zoo with ``SparseAdam`` + ``Adam``, 5 steps, float32
    tables: losses within 1e-6 relative; moments and dense Adam state
    within 1e-5 (jitted XLA and eager PyTorch round MLP sums
    differently); tables and dense params within 1e-4, a hundredth of
    lr: Adam's normalized step turns a gradient difference near zero
    into a step difference up to lr (measured max 1.2e-5 and 3.1e-5);
    the NaN batch bitwise;
  - the converters: exact copies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models import synthetic as jsyn
from distributed_embeddings_tpu.models import synthetic_configs as jcfgs
from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)
from distributed_embeddings_tpu.ops import packed_slab as jps
from distributed_embeddings_tpu.ops.sparse_grad import (
    dedup_sparse_grad as jax_dedup)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, init_hybrid_state as jax_init)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdam as JaxSparseAdam, SparseMomentum as JaxSparseMomentum)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.models import (
    InputGenerator, build_synthetic, synthetic_models_v3,
    warmup_poly_decay_schedule)
from distributed_embeddings_torch.ops import (
    adam_rows, adam_rows_plain, momentum_rows, momentum_rows_plain)
from distributed_embeddings_torch.ops.packed_slab import unpack_rows_np
from distributed_embeddings_torch.parallel import (
    SGD, Adam, AdamState, DistributedEmbedding, ScheduleState, SparseAdam,
    SparseMomentum, TraceState, make_hybrid_train_step)
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

from torch_parity import assert_within_ulps, bf16_ulp, to_np

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LR = 0.01


def _lrs(lr, device_lr):
    """``(jax lr, port lr)``: a float, or a float32 device scalar."""
    if device_lr:
        return jnp.float32(lr), torch.tensor(lr, dtype=torch.float32)
    return lr, lr


def _jax_opt(name):
    return {"adam": JaxSparseAdam(), "momentum": JaxSparseMomentum(0.9),
            "nesterov": JaxSparseMomentum(0.9, nesterov=True)}[name]


def _port_opt(name):
    return {"adam": SparseAdam(), "momentum": SparseMomentum(0.9),
            "nesterov": SparseMomentum(0.9, nesterov=True)}[name]


def _states(rng, name, rows, w, count):
    """Random numpy optimizer state: ``(mu, nu, count)`` or a trace."""
    if name == "adam":
        return (rng.normal(size=(rows, w)).astype(np.float32) * 0.1,
                rng.random((rows, w)).astype(np.float32) * 0.1,
                np.full((1, 1), count, np.float32))
    return rng.normal(size=(rows, w)).astype(np.float32) * 0.1


def _jax_state(st, jdt):
    if isinstance(st, tuple):
        return (jnp.asarray(st[0], jdt), jnp.asarray(st[1], jdt),
                jnp.asarray(st[2]))
    return jnp.asarray(st, jdt)


def _port_state(st, tdt):
    """Tensors of a numpy state (copies: the port updates in place)."""
    if isinstance(st, tuple):
        return tuple(torch.from_numpy(a.copy()).to(d)
                     for a, d in zip(st, (tdt, tdt, torch.float32)))
    return torch.from_numpy(st.copy()).to(tdt)


def _np_state(st):
    """Host copies of a port or JAX state's arrays."""
    return tuple(to_np(t).copy() for t in st) if isinstance(st, tuple) \
        else (to_np(st).copy(),)


# ------------------------------------------------- the row kernels (plain)


@pytest.mark.parametrize("device_lr", [False, True], ids=["py_lr", "dev_lr"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,count", [("adam", 0), ("adam", 999),
                                        ("momentum", None),
                                        ("nesterov", None)])
def test_row_update_plain_matches_jax_bitwise(name, count, dtype, device_lr):
    """K11's and K12's plain versions on JAX's dedup output against
    JAX's ``apply_rows`` (count advanced to 1 and 1000): negative ids
    (read at row 0, written wrapped; none wraps onto another given id),
    the sentinel, ids past the slab and the pad tail."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    rows, w = 64, 16
    ids = np.array([-62, -9, -1, 0, 3, 4, 17, 18, 40, 50, rows, rows + 5],
                   np.int32)
    vals = rng.normal(size=(len(ids), w)).astype(np.float32)
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    st = _states(rng, name, rows, w, count)
    jlr, tlr = _lrs(LR, device_lr)
    js, jst = _jax_opt(name).apply_rows(
        jnp.asarray(slab, jdt), _jax_state(st, jdt), jnp.asarray(ids),
        jnp.asarray(vals, jdt), jlr)
    uids, uvals = jax_dedup(jnp.asarray(ids), jnp.asarray(vals, jdt),
                            pad_id=rows, max_unique=rows + 1)
    assert (np.asarray(uids)[len(ids):] == rows).all()  # the pad tail
    ts = torch.from_numpy(slab.copy()).to(tdt)
    tst = _port_state(st, tdt)
    tu = torch.from_numpy(np.array(uids))
    tv = torch.from_numpy(to_np(uvals)).to(tdt)
    if name == "adam":
        tst[2].add_(1.0)
        out = adam_rows_plain(ts, tst[0], tst[1], tst[2], tu, tv, tlr, 0.9,
                              0.999, 1e-8, 0.0)
        assert out[0] is ts and out[1] is tst[0] and out[2] is tst[1]
    else:
        out = momentum_rows_plain(ts, tst, tu, tv, tlr, 0.9,
                                  name == "nesterov")
        assert out[0] is ts and out[1] is tst
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    for got, want in zip(_np_state(tst), _np_state(jst)):
        np.testing.assert_array_equal(got, want)
    written = {r % rows for r in ids if -rows <= r < rows}
    untouched = [r for r in range(rows) if r not in written]
    old = to_np(torch.from_numpy(slab).to(tdt))
    np.testing.assert_array_equal(to_np(ts)[untouched], old[untouched])
    assert (to_np(ts)[sorted(written)] != old[sorted(written)]).any()


def test_row_update_cpu_counts_no_launch_and_other_devices_raise():
    before = (adam_rows.launches, momentum_rows.launches)
    z = torch.zeros(4, 8)
    adam_rows(z.clone(), z.clone(), z.clone(), torch.ones(1, 1),
              torch.tensor([1, 4]), torch.ones(2, 8), 0.1, 0.9, 0.999,
              1e-8, 0.0)
    momentum_rows(z.clone(), z.clone(), torch.tensor([1, 4]),
                  torch.ones(2, 8), 0.1, 0.9)
    assert (adam_rows.launches, momentum_rows.launches) == before
    m = torch.empty(4, 8, device="meta")
    u = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam_rows(m, m, m, torch.empty(1, 1, device="meta"), u,
                  torch.empty(1, 8, device="meta"), 0.1, 0.9, 0.999, 1e-8,
                  0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        momentum_rows(m, m, u, torch.empty(1, 8, device="meta"), 0.1, 0.9)


# ------------------------------------------- apply_rows on a whole stream


def _stream(seed, rows, n, w):
    """Zipfian ids (hot rows repeat) with the sentinel and ids past it."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.2, size=n) - 1) % rows
    flip = rng.random(n) < 0.05
    ids = np.where(flip, rng.choice([rows, rows + 7], size=n), ids)
    return ids.astype(np.int32), rng.normal(size=(n, w)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "momentum", "nesterov"])
def test_apply_rows_stream_matches_jax(name, dtype):
    """Whole ``apply_rows`` (dedup + row update) on a stream with
    duplicates, from zero state (Adam's sign-like first step) and then a
    second step on top."""
    jdt, tdt = DTYPES[dtype]
    rows, w, n = 48, 16, 600
    rng = np.random.default_rng(8)
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    jslab, tslab = jnp.asarray(slab, jdt), torch.from_numpy(slab).to(tdt)
    jopt, topt = _jax_opt(name), _port_opt(name)
    jst = jopt.init(jslab)
    tst = topt.init({"w": tslab})["w"]
    for s, t in zip(_np_state(tst), jax.tree.leaves(jst)):
        assert s.shape == t.shape
    flips = 0
    for step in range(2):
        ids, vals = _stream(20 + step, rows, n, w)
        old = to_np(tslab).copy()
        jslab, jst = jopt.apply_rows(jslab, jst, jnp.asarray(ids),
                                     jnp.asarray(vals, jdt), LR)
        out, tst = topt.apply_rows(tslab, tst, torch.from_numpy(ids),
                                   torch.from_numpy(vals).to(tdt), LR)
        assert out is tslab
        hit = ids < rows
        k = np.bincount(ids[hit], minlength=rows)[:, None]
        mag = np.zeros((rows, w))
        np.add.at(mag, ids[hit], np.abs(vals[hit]))
        bounds = []
        for got, want in zip(_np_state(tst), _np_state(jst)):
            if got.shape[-1] != w:
                np.testing.assert_array_equal(got, want)  # Adam's count
                continue
            scale = mag + mag * mag + np.abs(want)
            bound = (1e-6 * scale if dtype == "float32"
                     else (k + 2.0) * bf16_ulp(scale))
            bad = np.abs(got - want) > bound + 1e-30
            assert not bad.any(), (
                f"{name} {dtype} step {step}: {int(bad.sum())} state values"
                f" beyond their bound (max err {np.abs(got - want).max()})")
            bounds.append((want, bound))
        err = np.abs(to_np(tslab) - to_np(jslab))
        # the summed gradient's own error moves a momentum step by lr
        # times it (twice with Nesterov)
        tight = (1e-6 * (np.abs(old) + LR + 2 * LR * mag)
                 if dtype == "float32" else LR / 8 + 2 * bf16_ulp(old)
                 + 2 * LR * (k + 2) * bf16_ulp(mag))
        # Adam's step is sign-like where mu lies within its own bound of
        # zero (at the first step mu = (1 - b1) g)
        near_zero = np.zeros_like(err, bool)
        if name == "adam":
            mu_want, mu_bound = bounds[0]
            near_zero = np.abs(mu_want) <= 4 * mu_bound
        loose = err > tight
        assert not (loose & ~near_zero).any(), (
            f"{name} {dtype} step {step}: {int((loose & ~near_zero).sum())}"
            f" slab values beyond {tight if np.isscalar(tight) else 'tol'}"
            f" away from a near-zero gradient (max err {err.max()})")
        assert (err[loose] <= 2 * LR + 2 * bf16_ulp(old)[loose]).all()
        flips += int(loose.sum())
        untouched = k[:, 0] == 0
        np.testing.assert_array_equal(to_np(tslab)[untouched],
                                      old[untouched])
    print(f"{name} {dtype}: {flips} sign-like elements beyond the tight "
          "bound (within 2 lr)")
    assert flips <= rows * w // 100


# ------------------------------------- packed widths against logical rows


@pytest.mark.parametrize("name", ["adam", "momentum", "nesterov"])
def test_packed_lane_mask_matches_logical_rows(name):
    """JAX at width 16 on lane-packed physical rows (8 logical rows a
    128-lane row, with its lane touch-mask) against the port's logical
    rows: the packed neighbours of a touched row keep their state in
    JAX, and the port never touches them."""
    rows, w = 64, 16
    p = jps.pack_factor(w)
    assert p == 8
    rng = np.random.default_rng(31)
    slab = rng.normal(size=(rows, w)).astype(np.float32)
    st = _states(rng, name, rows, w, 3)
    # every other logical row: each touched row has untouched neighbours
    ids = rng.choice(np.arange(0, rows, 2), size=200).astype(np.int32)
    ids = np.concatenate([ids, [rows, rows]]).astype(np.int32)
    vals = rng.normal(size=(len(ids), w)).astype(np.float32)

    def pack(x):
        return jnp.asarray(jps.pack_rows_np(x, w))

    jst = ((pack(st[0]), pack(st[1]), jnp.asarray(st[2]))
           if name == "adam" else pack(st))
    pids, pvals = jps.expand_update_rows(jnp.asarray(vals), jnp.asarray(ids),
                                         w)
    mask = jps.lane_one_hot(jnp.asarray(ids), w, dtype=pvals.dtype)
    js, jst = _jax_opt(name).apply_rows(pack(slab), jst, pids, pvals, LR,
                                        mask=mask, lane_width=w)
    ts = torch.from_numpy(slab.copy())
    tst = _port_state(st, torch.float32)
    _port_opt(name).apply_rows(ts, tst, torch.from_numpy(ids),
                               torch.from_numpy(vals), LR)
    want = [unpack_rows_np(np.asarray(js), w)]
    got = [ts.numpy()]
    if name == "adam":
        want += [unpack_rows_np(np.asarray(jst[0]), w),
                 unpack_rows_np(np.asarray(jst[1]), w)]
        got += [tst[0].numpy(), tst[1].numpy()]
        np.testing.assert_array_equal(tst[2].numpy(), np.asarray(jst[2]))
    else:
        want.append(unpack_rows_np(np.asarray(jst), w))
        got.append(tst.numpy())
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, rtol=1e-6, atol=1e-7)
    odd = np.arange(1, rows, 2)
    np.testing.assert_array_equal(ts.numpy()[odd], slab[odd])
    np.testing.assert_array_equal(want[0][odd], slab[odd])


# ---------------------------------------------------------- lazy semantics


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_lazy_moments_skip_untouched_rows(name):
    """Mirror of ``tests/test_sparse_trainer.py``'s lazy test, through
    the port's ``DistributedEmbedding`` (``local_view`` /
    ``stacked_view`` over the tuple state) beside the JAX one: after a
    step that touches every row, a step that touches only row 0 leaves
    every other row's params and state bitwise; a step that touches row
    0 with a ZERO cotangent still decays its state (and, with the
    momentum it carries, moves it); a disabled step (every id the
    sentinel) changes no row (Adam's count still advances)."""
    configs = [{"input_dim": 8, "output_dim": 4, "combiner": "sum"}]
    rng = np.random.default_rng(7)
    t0 = rng.normal(size=(8, 4)).astype(np.float32)
    jde = JaxDE(configs, world_size=1)
    tde = DistributedEmbedding(configs, world_size=1)
    jopt, topt = _jax_opt(name), _port_opt(name)
    jflat = jde.set_weights([t0])
    jstate = jopt.init(jflat)
    tflat = tde.set_weights([t0], device="cpu")
    tstate = topt.init(tflat)
    tloc, tsloc = tde.local_view(tflat), tde.local_view(tstate)
    assert all(v.dim() == 2 for v in jax.tree.leaves(
        tsloc, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    again = tde.stacked_view(tsloc)
    for a, b in zip(jax.tree.leaves(again, is_leaf=torch.is_tensor),
                    jax.tree.leaves(tstate, is_leaf=torch.is_tensor)):
        assert a.shape == b.shape and a.data_ptr() == b.data_ptr()

    def both(ids, cot, enable=None):
        nonlocal jflat, jstate
        jids = jnp.asarray(ids, jnp.int32)[:, None]
        outs, res = jde.forward_with_residuals(jde.local_view(jflat), [jids])
        jflat, jstate = jde.sparse_apply_gradients(
            jde.local_view(jflat), jde.local_view(jstate), res,
            [jnp.full_like(outs[0], cot)], jopt, 0.1, scale=1.0,
            enable=None if enable is None else jnp.asarray(enable))
        jflat, jstate = jde.stacked_view(jflat), jde.stacked_view(jstate)
        tids = torch.tensor(ids, dtype=torch.int32)[:, None]
        outs, res = tde.forward_with_residuals(tflat, [tids])
        tde.sparse_apply_gradients(
            tflat, tstate, res, [torch.full_like(outs[0], cot)], topt, 0.1,
            scale=1.0, enable=None if enable is None else torch.tensor(enable))
        got, want = tde.get_weights(tflat)[0], np.asarray(
            jde.get_weights(jflat)[0])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        return got, _np_state(tde.local_view(tstate)["w4"])

    after1, s1 = both(list(range(8)), 1.0)
    after2, s2 = both([0] * 8, 1.0)
    assert not np.allclose(after2[0], after1[0])  # row 0 moved
    np.testing.assert_array_equal(after2[1:], after1[1:])  # rest frozen
    for a, b in zip(s1, s2):
        if a.shape[0] == 8:
            np.testing.assert_array_equal(a[1:], b[1:])
    after3, s3 = both([0] * 8, 0.0)
    assert not np.array_equal(s3[0][0], s2[0][0])  # state decays
    assert not np.array_equal(after3[0], after2[0])  # momentum moves it
    np.testing.assert_array_equal(after3[1:], after2[1:])
    after4, s4 = both(list(range(8)), 1.0, enable=False)
    np.testing.assert_array_equal(after4, after3)
    for a, b in zip(s3, s4):
        if a.shape[0] == 8:
            np.testing.assert_array_equal(a, b)
    if name == "adam":
        assert float(s4[2].reshape(())) == float(s3[2].reshape(())) + 1 == 4
        assert float(np.asarray(jstate["w4"][2]).reshape(())) == 4


# ------------------------------------------- every row touched: dense optax


def _emb_tx(name, lr):
    return {"adam": optax.adam(lr), "momentum": optax.sgd(lr, momentum=0.9),
            "nesterov": optax.sgd(lr, momentum=0.9, nesterov=True)}[name]


@pytest.mark.parametrize("name", ["momentum", "nesterov", "adam"])
def test_every_row_touched_matches_dense_optax(name):
    """Mirror of ``tests/test_sparse_trainer.py:161-203`` at the
    optimizer level: with every row in every step's stream, the lazy
    sparse optimizer equals ``optax`` on the dense gradient."""
    rows, w, lr = 24, 8, 0.1
    rng = np.random.default_rng(44)
    table = rng.normal(size=(rows, w)).astype(np.float32)
    tx = _emb_tx(name, lr)
    jp = jnp.asarray(table)
    jst = tx.init(jp)
    ts = torch.from_numpy(table.copy())
    opt = _port_opt(name)
    tst = opt.init({"w": ts})["w"]
    for step in range(3):
        ids = np.concatenate([np.arange(rows), rng.integers(0, rows, 40)])
        vals = rng.normal(size=(len(ids), w)).astype(np.float32)
        g = np.zeros((rows, w), np.float32)
        np.add.at(g, ids, vals)
        upd, jst = tx.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        _, tst = opt.apply_rows(ts, tst, torch.from_numpy(ids.astype(
            np.int32)), torch.from_numpy(vals), lr)
        np.testing.assert_allclose(ts.numpy(), np.asarray(jp), rtol=2e-4,
                                   atol=1e-5, err_msg=f"step {step}")


@pytest.mark.parametrize("sched", [False, True], ids=["const", "schedule"])
@pytest.mark.parametrize("name", ["momentum", "nesterov", "adam"])
def test_dense_optimizers_match_optax(name, sched):
    """The port's dense ``SGD(momentum=...)`` and ``Adam`` against
    ``optax.sgd(momentum=...)`` and ``optax.adam``, with a constant lr
    and with ``warmup_poly_decay_schedule`` (optax evaluates it at its own
    int32 count from 0): three updates of two parameters, states and
    updates, and the state's layout (optax's chain without its empty
    parts)."""
    rng = np.random.default_rng(21)
    shapes = [(5, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jlr = jax_schedule(0.05, 2, 4, 3) if sched else 0.05
    tlr = warmup_poly_decay_schedule(0.05, 2, 4, 3) if sched else 0.05
    if name == "adam":
        tx, opt = optax.adam(jlr), Adam(tlr)
    else:
        nest = name == "nesterov"
        tx = optax.sgd(jlr, momentum=0.9, nesterov=nest)
        opt = SGD(tlr, momentum=0.9, nesterov=nest)
    jst = tx.init([jnp.asarray(p) for p in params])
    tst = opt.init([torch.from_numpy(p) for p in params])
    kinds = [type(s) for s in tst]
    assert kinds == ([AdamState] if name == "adam" else [TraceState]) + (
        [ScheduleState] if sched else [])
    for _ in range(4):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jupd, jst = tx.update([jnp.asarray(g) for g in grads], jst)
        prev = [t.clone() for t in jax.tree.leaves(
            tst, is_leaf=torch.is_tensor)]
        tupd, new = opt.update([torch.from_numpy(g) for g in grads], tst)
        for a, b in zip(prev, jax.tree.leaves(tst, is_leaf=torch.is_tensor)):
            assert torch.equal(a, b)  # the old state is not mutated
        tst = new
        for got, want in zip(tupd, jupd):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jst)]
    tleaves = [t.numpy() for t in jax.tree.leaves(tst,
                                                  is_leaf=torch.is_tensor)]
    assert len(jleaves) == len(tleaves)
    for got, want in zip(tleaves, jleaves):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


# ------------------------------------ the capped tiny zoo with SparseAdam

CAP = 500
B = 64
STEPS = 5


def _mse_jax(dense):
    def loss(p, outs, batch):
        n, y = batch
        return jnp.mean((dense.apply(p, n, outs) - y) ** 2)
    return loss


def _mse(dense_mod, outs, batch):
    n, y = batch
    return torch.mean((dense_mod(n, outs) - y) ** 2)


def _snapshot(tde, state):
    leaves = jax.tree.leaves(state.emb_opt_state, is_leaf=torch.is_tensor)
    return dict(
        tables=[t.copy() for t in tde.get_weights(state.emb_params)],
        emb_state={k: tuple(t.clone() for t in v)
                   for k, v in state.emb_opt_state.items()},
        n_emb_leaves=len(leaves),
        dense=[p.detach().clone() for p in state.dense_params.parameters()],
        dense_state=[t.clone() for t in jax.tree.leaves(
            state.dense_opt_state, is_leaf=torch.is_tensor)],
        step=int(state.step))


def _carry(jde, jstate, tde, tdense, dtype, topt, ttx):
    host = jax.tree.map(np.array, jstate)
    return hybrid_state_from_jax(
        tde, tdense, jde.get_weights(jstate.emb_params), host.dense_params,
        host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, dtype=dtype, device="cpu",
        emb_optimizer=topt, dense_tx=ttx)


@functools.lru_cache(maxsize=None)
def _zoo_run():
    """One JAX and one port run of the capped tiny zoo with
    ``SparseAdam`` + ``Adam`` from one state: STEPS steps, then a NaN
    batch; and the JAX state after the steps carried over again."""
    jde, jdense, _ = jsyn.build_synthetic(jcfgs.model_tiny, 1, row_cap=CAP)
    jgen = jsyn.InputGenerator(jcfgs.model_tiny, B, alpha=1.05,
                               num_batches=STEPS, seed=0, row_cap=CAP)
    widths = [int(jde.strategy.global_configs[t]["output_dim"])
              for t in jde.strategy.input_table_map]
    dp = jdense.init(jax.random.key(0), jgen[0][0][:2],
                     [jnp.zeros((2, w)) for w in widths])
    tx = optax.adam(LR)
    jopt = JaxSparseAdam()
    jstate = jax_init(jde, jopt, dp, tx, jax.random.key(1))
    jstep = jax_train_step(jde, _mse_jax(jdense), tx, jopt, lr_schedule=LR,
                           with_metrics=False, nan_guard=True,
                           telemetry=False)
    tde, tdense, _ = build_synthetic(synthetic_models_v3["tiny"], 1,
                                     row_cap=CAP, device="cpu")
    topt, ttx = SparseAdam(), Adam(LR)
    tstate = _carry(jde, jstate, tde, tdense, torch.float32, topt, ttx)
    tstep = make_hybrid_train_step(tde, _mse, ttx, topt, lr_schedule=LR,
                                   nan_guard=True)
    tgen = InputGenerator(synthetic_models_v3["tiny"], B, alpha=1.05,
                          num_batches=STEPS, seed=0, row_cap=CAP,
                          device="cpu")
    jl, tl = [], []
    for k in range(STEPS):
        n, c, y = jgen[k]
        loss, jstate = jstep(jstate, c, (n, y))
        jl.append(float(loss))
        n, c, y = tgen[k]
        loss, tstate = tstep(tstate, c, (n, y))
        tl.append(float(loss))
    out = dict(jde=jde, tde=tde, jl=np.array(jl), tl=np.array(tl),
               jstate=jax.tree.map(np.array, jstate),
               tsnap=_snapshot(tde, tstate))
    n, c, y = tgen[0]
    n = n.clone()
    n[3, 4] = float("nan")
    loss, tstate = tstep(tstate, c, (n, y))
    out["nan_loss"] = float(loss)
    out["nan_tsnap"] = _snapshot(tde, tstate)
    # the converter on a JAX state with nonzero moments and counts
    tde2, tdense2, _ = build_synthetic(synthetic_models_v3["tiny"], 1,
                                       row_cap=CAP, device="cpu")
    out["carried"] = _carry(jde, jstate, tde2, tdense2, torch.float32,
                            SparseAdam(), Adam(LR))
    return out


def _want_dense(tree):
    tree = tree["params"]
    out = []
    for name in sorted(tree, key=lambda k: int(k.split("_")[-1])):
        out += [tree[name]["kernel"].T, tree[name]["bias"]]
    return out


def test_zoo_adam_trajectory_matches_jax():
    """5 steps of the capped tiny zoo (fp32 tables; the default regime
    is irrelevant to Adam: both slabs dedup) with ``SparseAdam`` on the
    tables and ``Adam`` on the dense half, from one carried state."""
    run = _zoo_run()
    js, ts = run["jstate"], run["tsnap"]
    assert np.isfinite(run["tl"]).all()
    np.testing.assert_allclose(run["tl"], run["jl"], rtol=1e-6)
    for i, (g, w) in enumerate(zip(ts["tables"],
                                   run["jde"].get_weights(js.emb_params))):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0,
                                   err_msg=f"table {i}")
    for k, (mu, nu, cnt) in ts["emb_state"].items():
        jmu, jnu, jcnt = js.emb_opt_state[k]
        w = mu.shape[-1]
        np.testing.assert_allclose(mu[0].numpy(), unpack_rows_np(jmu[0], w),
                                   atol=1e-5, rtol=0, err_msg=f"{k} mu")
        np.testing.assert_allclose(nu[0].numpy(), unpack_rows_np(jnu[0], w),
                                   atol=1e-5, rtol=1e-4, err_msg=f"{k} nu")
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        assert float(cnt.reshape(())) == STEPS
    adam_state = js.dense_opt_state[0]
    assert int(adam_state.count) == STEPS
    want = ([np.asarray(adam_state.count)] + _want_dense(adam_state.mu)
            + _want_dense(adam_state.nu))
    for got, w in zip(ts["dense_state"], want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=1e-4)
    for got, w in zip(ts["dense"], _want_dense(js.dense_params)):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-4, rtol=0)
    assert ts["step"] == int(js.step) == STEPS


def test_zoo_adam_nan_batch_keeps_count_and_dense_state():
    """A NaN batch: the tables, the moments AND Adam's step counts, the
    dense params and the dense Adam state (its count too) stay bitwise
    unchanged; the step advances."""
    run = _zoo_run()
    assert not np.isfinite(run["nan_loss"])
    before, after = run["tsnap"], run["nan_tsnap"]
    for a, b in zip(before["tables"], after["tables"]):
        np.testing.assert_array_equal(a, b)
    for k in before["emb_state"]:
        for a, b in zip(before["emb_state"][k], after["emb_state"][k]):
            assert torch.equal(a, b)
        assert float(after["emb_state"][k][2].reshape(())) == STEPS
    for a, b in zip(before["dense"] + before["dense_state"],
                    after["dense"] + after["dense_state"]):
        assert torch.equal(a, b)
    assert after["step"] == before["step"] + 1


def test_convert_adam_state_from_jax():
    """``hybrid_state_from_jax`` carries ``SparseAdam``'s packed moments
    (unpacked to logical rows) and counts, and ``optax.adam``'s
    ``ScaleByAdamState``, exactly."""
    run = _zoo_run()
    st, js = run["carried"], run["jstate"]
    for k, (mu, nu, cnt) in st.emb_opt_state.items():
        jmu, jnu, jcnt = js.emb_opt_state[k]
        w = mu.shape[-1]
        assert mu.shape == st.emb_params[k].shape and cnt.shape == (1, 1, 1)
        np.testing.assert_array_equal(mu[0].numpy(),
                                      unpack_rows_np(jmu[0], w))
        np.testing.assert_array_equal(nu[0].numpy(),
                                      unpack_rows_np(jnu[0], w))
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
    (ad,) = st.dense_opt_state
    jad = js.dense_opt_state[0]
    assert isinstance(ad, AdamState) and ad.count.dtype == torch.int32
    assert int(ad.count) == int(jad.count) == STEPS
    for got, want in zip(ad.mu + ad.nu, _want_dense(jad.mu)
                         + _want_dense(jad.nu)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sched", [False, True], ids=["const", "schedule"])
def test_convert_momentum_state_from_jax(sched):
    """``SparseMomentum``'s packed traces and ``optax.sgd(momentum=...)``'s
    ``TraceState`` (and a schedule's count) carried over exactly; a state
    without a counterpart in the port's optimizer raises."""
    from distributed_embeddings_tpu.models.dlrm import (
        DLRMConfig as JaxCfg, DLRMDense as JaxDense)
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense

    sizes = [30, 50]
    jcfg = JaxCfg(table_sizes=sizes, embedding_dim=8,
                  num_numerical_features=3, bottom_mlp_dims=[16, 8],
                  top_mlp_dims=[8, 1])
    jde = JaxDE(jcfg.embedding_configs(), world_size=1)
    jdense = JaxDense(jcfg)
    dp = jdense.init(jax.random.key(0), jnp.zeros((2, 3)),
                     [jnp.zeros((2, 8))] * 2)
    jlr = jax_schedule(0.1, 2, 4, 3) if sched else 0.1
    tx = optax.sgd(jlr, momentum=0.9)
    jstate = jax_init(jde, JaxSparseMomentum(), dp, tx, jax.random.key(1))
    rng = np.random.default_rng(3)
    host = jax.tree.map(
        lambda a: (rng.normal(size=a.shape).astype(a.dtype)
                   if np.issubdtype(a.dtype, np.floating)
                   else np.full(a.shape, 7, a.dtype)),
        jax.tree.map(np.array, jstate))
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=8,
                     num_numerical_features=3, bottom_mlp_dims=[16, 8],
                     top_mlp_dims=[8, 1])
    tde = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    tlr = warmup_poly_decay_schedule(0.1, 2, 4, 3) if sched else 0.1
    ttx = SGD(tlr, momentum=0.9)
    st = hybrid_state_from_jax(
        tde, DLRMDense(cfg, device="cpu"), jde.get_weights(jstate.emb_params),
        host.dense_params, host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, device="cpu",
        emb_optimizer=SparseMomentum(0.9), dense_tx=ttx)
    (k,) = st.emb_opt_state
    np.testing.assert_array_equal(
        st.emb_opt_state[k][0].numpy(),
        unpack_rows_np(host.emb_opt_state[k][0], 8))
    parts = st.dense_opt_state
    assert isinstance(parts[0], TraceState)
    for got, want in zip(parts[0].trace,
                         _want_dense(host.dense_opt_state[0].trace)):
        np.testing.assert_array_equal(got.numpy(), want)
    if sched:
        assert isinstance(parts[1], ScheduleState) and int(parts[1].count) == 7
    else:
        assert len(parts) == 1
    with pytest.raises(ValueError, match="no counterpart"):
        hybrid_state_from_jax(
            tde, DLRMDense(cfg, device="cpu"),
            jde.get_weights(jstate.emb_params), host.dense_params, host.step,
            dense_opt_state=host.dense_opt_state, device="cpu",
            emb_optimizer=SparseMomentum(0.9), dense_tx=SGD(0.1))
