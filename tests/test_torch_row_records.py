"""The launch records of K21 (``ops/grad_health.py``), K11
(``ops/adam.py``), K6 (``ops/adagrad.py``) and K12 (``ops/momentum.py``)
on CPU tensors: the records
are built without a launch (``build_on_cpu``), so their keys, their chunk
plans and constants, their reuse and every rebuild or raise run here.

What is held, all exactly (integers, addresses and float32 constants):
  - K21's key holds the count, shapes, strides, dtypes and devices of the
    gradients and no address: fresh tensors of the same layouts find the
    record, a changed layout builds another;
  - K21's chunk plan, walked as the kernel walks it (chunk -> rectangle
    of the view -> 16-byte groups a thread takes by its (row, group)
    counter), covers every element of every view once and nothing else;
  - K11's key holds the layouts, dtypes, hyperparameters and a constant
    lr (a tensor lr's layout), no address; its constants are the float32
    and moment-dtype roundings ``ops/adam.py:_rnd`` gives;
  - K6's key holds the layouts, dtypes, ``eps`` and a constant lr (a
    tensor lr's layout), no address; its constants are the roundings of
    ``ops/adagrad.py:_lr_args`` (and of ``eps``) to the accumulator dtype;
  - K12's key holds the layouts, dtypes, ``momentum``, Nesterov and a
    constant lr (a tensor lr's layout), no address; its constants are
    ``ops/adam.py:_rnd``'s roundings of ``momentum`` and ``-lr`` to the
    trace dtype;
  - the live-range search of K6, K11 and K12 (``csrc/row_update.cuh:
    block_bounds``, transcribed) finds the ends of the negative prefix and
    of the live range of a sorted id stream, as ``np.searchsorted`` does;
  - all four validate as their wrappers always have, raising the same
    errors.
"""

import importlib

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import adagrad as ada_mod
from distributed_embeddings_torch.ops import adam as adam_mod
from distributed_embeddings_torch.ops import (adagrad_rows, adam_rows,
                                              grad_health, momentum_rows)

gh = importlib.import_module("distributed_embeddings_torch.ops.grad_health")
mom_mod = importlib.import_module("distributed_embeddings_torch.ops.momentum")

torch.set_num_threads(1)

THREADS = 256  # kThreads of csrc/grad_health.cu, adam.cu, adagrad.cu and
#                momentum.cu


def _find(cache, module, *args):
    """A record of ``module`` for ``args`` through ``cache``, built on CPU
    tensors."""
    return _kernels.find_or_build(cache, module.record_key(*args),
                                  module.build_record, True, True, *args)


# ------------------------------------------------------------------ K21


def _health_list(seed=0):
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn((40, 3, 64), generator=g)
    return [torch.randn((65, 128), generator=g).to(torch.bfloat16),
            wide[:, :, 8:40],                   # collapsible column slice
            wide[:, 1, :16],                    # one column slice
            torch.randn(0, generator=g),
            torch.randn(40_001, generator=g)[1:],
            torch.randn(9, generator=g)[::3]]   # not a 2-D view: a copy


def test_k21_key_holds_no_addresses_and_fresh_tensors_hit():
    cache = _kernels.LaunchCache()
    a, b = _health_list(0), _health_list(1)
    assert gh.record_key(a) == gh.record_key(b)
    ptrs = {t.data_ptr() for t in a + b if t.numel()}
    assert not ptrs & {k for k in gh.record_key(a) if isinstance(k, int)}
    rec = _find(cache, gh, a)
    assert _find(cache, gh, b) is rec and cache.builds == 1
    copy, launches = rec.payload
    assert copy == (5,) and len(launches) == 1 and rec.calls == ()


@pytest.mark.parametrize("change", ["shape", "stride", "dtype", "count",
                                    "device_order"])
def test_k21_changed_layout_builds_a_new_record(change):
    cache = _kernels.LaunchCache()
    ts = _health_list()
    _find(cache, gh, ts)
    other = list(ts)
    if change == "shape":
        other[0] = other[0][:64]
    elif change == "stride":
        other[1] = other[1].contiguous()
    elif change == "dtype":
        other[4] = other[4].to(torch.bfloat16)
    elif change == "count":
        other = other[:-1]
    else:
        other = other[::-1]
    assert gh.record_key(other) != gh.record_key(ts)
    _find(cache, gh, other)
    assert cache.builds == 2
    _find(cache, gh, ts)
    assert cache.builds == 2


def test_k21_validates_and_raises_as_before():
    ok = torch.zeros(4)
    with pytest.raises(ValueError, match="at least one tensor"):
        grad_health([])
    with pytest.raises(ValueError, match=r"tensor 1: expected float32/"
                                         r"bfloat16 on cpu, got "
                                         r"torch.float64"):
        gh.find_record([ok, ok.double()], build_on_cpu=True)
    m = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        grad_health([m])
    with pytest.raises(ValueError, match="tensor 1: expected"):
        gh.find_record([ok, m], build_on_cpu=True)
    # the CPU wrapper is the plain version, as it always was: no check of
    # the dtype, no launch, no record
    before = (grad_health.launches, gh._CACHE.builds)
    out = grad_health([ok.double(), ok])
    assert out.shape == (3, 2) and out.dtype == torch.float32
    assert (grad_health.launches, gh._CACHE.builds) == before


def test_k21_splits_past_the_launch_cap():
    ts = [torch.zeros(1 + k % 7) for k in range(1100)]
    rec = gh.find_record(ts, build_on_cpu=True)
    launches = rec.payload[1]
    assert [lo for lo, *_ in launches] == [0, 512, 1024]
    assert [d.shape[0] for _, d, *_ in launches] == [512, 512, 76]
    for _, descs, *_ in launches:
        assert descs[0, 3] == 0  # each launch numbers its chunks from 0


def _walk(descs, views, esize):
    """Every element offset (in the tensor's storage) the kernel's walk
    of ``descs`` reads, with its multiplicity: chunks -> rectangles ->
    16-byte groups taken by each thread's (row, group) counter, stepped
    as ``csrc/grad_health.cu:fold_chunk`` steps it."""
    G = 16 // esize
    ce = gh.CHUNK_BYTES // esize
    seen = []
    for (rows, cols, stride, _, chunks, rpc, ppr, _), v in zip(descs, views):
        assert (rows, cols, stride) == v
        offs = []
        for lc in range(chunks):
            if ppr > 1:
                r0, c0, rn = lc // ppr, (lc % ppr) * ce, 1
                cn = min(ce, cols - c0)
            else:
                r0, c0 = lc * rpc, 0
                rn, cn = min(rpc, rows - r0), cols
            gpr = -(-cn // G)
            total = rn * gpr
            dr, dq = divmod(THREADS, gpr)
            for t in range(min(THREADS, total)):
                r, q = divmod(t, gpr)
                for g in range(t, total, THREADS):
                    assert g == r * gpr + q
                    e0 = q * G
                    offs.append((r0 + r) * stride + c0
                                + np.arange(e0, min(e0 + G, cn)))
                    q, r = q + dq, r + dr
                    if q >= gpr:
                        q, r = q - gpr, r + 1
        seen.append(np.concatenate(offs) if offs else np.zeros(0, int))
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k21_chunk_plan_covers_every_element_once(dtype):
    ce = gh.CHUNK_BYTES // (2 if dtype == torch.bfloat16 else 4)
    base = torch.zeros((3 * ce + 7,), dtype=dtype)
    block = torch.zeros((300, 5, 48), dtype=dtype)
    wide = torch.zeros((3, ce + 40), dtype=dtype)
    ts = [base, base[:ce], base[:ce - 1], base[:1], base[:0], base[3:],
          block[:, 2, 8:40], block[:, :, 4:44], wide[:, 1:], wide[:2, :3],
          torch.zeros((7, 1), dtype=dtype)[:, :1],
          torch.zeros((2 * ce, 2), dtype=dtype)[:, :1]]
    views = [gh.view_2d(t) for t in ts]
    assert None not in views
    descs = gh.chunk_plan(views, [dtype] * len(ts))
    assert (descs[1:, 3] == np.cumsum(descs[:-1, 4])).all()
    esize = base.element_size()
    for t, (rows, cols, stride), seen in zip(ts, views,
                                             _walk(descs, views, esize)):
        want = (np.arange(rows)[:, None] * stride
                + np.arange(cols)[None, :]).reshape(-1)
        got, counts = np.unique(seen, return_counts=True)
        assert (counts == 1).all() and np.array_equal(got, want)
        # and the view's own strides address those offsets
        if t.numel():
            idx = torch.arange(t.storage_offset(), t.storage_offset()
                               + t.untyped_storage().nbytes()
                               // t.element_size())
            flat = torch.as_strided(idx, t.shape, t.stride(),
                                    0).reshape(-1) - t.storage_offset()
            assert np.array_equal(np.sort(flat.numpy()), want)


def test_k21_plan_flags_and_chunk_counts():
    f32, bf16 = torch.float32, torch.bfloat16
    assert gh.CHUNK_BYTES == 131072  # 32768 float32, 65536 bfloat16
    descs = gh.chunk_plan([(1, 32768, 32768), (1, 32769, 32769),
                           (65536, 128, 3456), (301, 24, 50), (1, 0, 0)],
                          [f32, f32, bf16, bf16, f32])
    # rows, cols, stride, first, chunks, rows a chunk, chunks a row, flags
    assert descs.tolist() == [
        [1, 32768, 32768, 0, 1, 1, 1, 2],
        [1, 32769, 32769, 1, 2, 1, 2, 2],
        [65536, 128, 3456, 3, 128, 512, 1, 3],
        [301, 24, 50, 131, 1, 2730, 1, 1],
        [1, 0, 0, 132, 0, 32768, 1, 2]]


# ------------------------------------------------------------------ K11


def _adam_args(seed=0, R=50, w=8, u=12, dt=torch.float32, ids=torch.int32,
               lr=0.01):
    g = torch.Generator().manual_seed(seed)
    slab = torch.randn((R, w), generator=g)
    return (slab, torch.zeros((R, w), dtype=dt), torch.zeros((R, w),
                                                             dtype=dt),
            torch.ones(1, 1), torch.arange(u, dtype=ids),
            torch.randn((u, w), generator=g).to(dt), lr, 0.9, 0.999, 1e-8,
            0.0)


def test_k11_key_holds_no_addresses_and_fresh_tensors_hit():
    cache = _kernels.LaunchCache()
    a, b = _adam_args(0), _adam_args(1)
    assert adam_mod.record_key(*a) == adam_mod.record_key(*b)
    ptrs = {t.data_ptr() for t in a[:6] + b[:6]}
    assert not ptrs & {k for k in adam_mod.record_key(*a)
                       if isinstance(k, int)}
    rec = _find(cache, adam_mod, *a)
    assert _find(cache, adam_mod, *b) is rec and cache.builds == 1
    assert rec.calls == ()


@pytest.mark.parametrize("change", [
    dict(w=16), dict(R=51), dict(u=13), dict(dt=torch.bfloat16),
    dict(ids=torch.int64), dict(lr=0.02), dict(lr=torch.tensor(0.01))])
def test_k11_changed_layout_or_constant_builds_a_new_record(change):
    cache = _kernels.LaunchCache()
    _find(cache, adam_mod, *_adam_args())
    _find(cache, adam_mod, *_adam_args(**change))
    assert cache.builds == 2
    other = list(_adam_args())
    other[7] = 0.8  # b1
    _find(cache, adam_mod, *other)
    assert cache.builds == 3


@pytest.mark.parametrize("mom", [torch.float32, torch.bfloat16])
def test_k11_constants_rounded_once(mom):
    args = _adam_args(dt=mom)
    slab = args[0]
    if mom == torch.bfloat16:
        args = (slab.to(torch.bfloat16),) + args[1:]
    rec = adam_mod.find_record(*args, build_on_cpu=True)
    lr_as_is, c, _ = rec.payload
    rnd = adam_mod._rnd
    f32 = torch.float32
    assert lr_as_is
    assert c == {"b1": rnd(0.9, mom), "omb1": rnd(1 - 0.9, mom),
                 "b2": rnd(0.999, mom), "omb2": rnd(1 - 0.999, mom),
                 "pb1": rnd(0.9, f32), "pb2": rnd(0.999, f32),
                 "lr": rnd(0.01, f32), "eps": rnd(1e-8, f32),
                 "eps_root": 0.0}
    if mom == torch.bfloat16:
        assert c["b2"] == 1.0 and c["pb2"] != 1.0
    # a card lr is read per call: converted where it is not float32
    for lr, as_is in ((torch.tensor(0.01), True),
                      (torch.tensor(0.01, dtype=torch.float64), False)):
        rec = adam_mod.find_record(*_adam_args(lr=lr), build_on_cpu=True)
        assert rec.payload[0] is as_is and rec.payload[1]["lr"] == 0.0


def test_k11_validates_and_raises_as_before():
    def raises(match, changes):
        args = list(_adam_args())
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            adam_mod.find_record(*args, build_on_cpu=True)

    raises("slab: expected a contiguous 2-D", {0: torch.zeros(8, 50).t()})
    raises("must share the slab's shape", {2: torch.zeros(50, 4)})
    raises("uids: expected a contiguous", {4: torch.zeros(3, 4,
                                                            dtype=torch.int32)})
    raises("uvals: expected a contiguous", {5: torch.zeros(12, 4)})
    raises("count: expected one float32", {3: torch.ones(2)})
    raises("a tensor lr must hold one value", {6: torch.ones(2)})
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        adam_rows(m, m, m, torch.ones(1, 1, device="meta"),
                  torch.zeros(2, dtype=torch.int32, device="meta"),
                  torch.zeros(2, 8, device="meta"), 0.1, 0.9, 0.999, 1e-8,
                  0.0)
    # the CPU wrapper runs the plain version, builds nothing
    before = (adam_rows.launches, adam_mod._CACHE.builds)
    adam_rows(*_adam_args())
    assert (adam_rows.launches, adam_mod._CACHE.builds) == before


def block_bounds(ids, v0, v1):
    """``csrc/row_update.cuh:block_bounds`` (K6's, K11's and K12's)
    transcribed: the first indices of the
    sorted ``ids`` holding a value >= v0 and >= v1, each round every one
    of THREADS threads probing one evenly spaced position of each open
    range (the block's ``__syncthreads_count`` is the sum)."""
    u = len(ids)
    lo, hi, v = [0, 0], [u, u], (v0, v1)
    t = np.arange(THREADS)
    rounds = 0
    while lo[0] < hi[0] or lo[1] < hi[1]:
        rounds += 1
        for k in range(2):
            if lo[k] >= hi[k]:
                continue
            step = (hi[k] - lo[k] + THREADS - 1) // THREADS
            at = lo[k] + t * step
            valid = at < hi[k]
            below = np.zeros(THREADS, bool)
            below[valid] = ids[at[valid]] < v[k]
            c = int(below.sum())
            if c == 0:
                hi[k] = lo[k]
            else:
                last = lo[k] + (c - 1) * step
                lo[k] = last + 1
                hi[k] = min(hi[k], last + step)
    return lo[0], lo[1], rounds


@pytest.mark.parametrize("case", ["zoo_w16", "all_pad", "no_pad",
                                  "negatives_only", "one", "empty_live",
                                  "random"])
def test_k11_live_range_search(case):
    rng = np.random.default_rng(len(case))
    rows = 70_200_000 if case == "zoo_w16" else 5000
    if case == "zoo_w16":
        live = np.sort(rng.choice(rows, 859_157, replace=False))
        ids = np.concatenate([live, np.full(2_883_584 - 859_157, rows)])
    elif case == "all_pad":
        ids = np.full(700, rows)
    elif case == "no_pad":
        ids = np.arange(rows)
    elif case == "negatives_only":
        ids = np.array([-rows - 4, -rows, -9, -1])
    elif case == "one":
        ids = np.array([3])
    elif case == "empty_live":
        ids = np.concatenate([[-7, -2], np.full(33, rows), [rows + 5]])
    else:
        ids = np.sort(rng.integers(-rows, 2 * rows, 100_003))
    neg, live, rounds = block_bounds(ids, 0, rows)
    assert neg == np.searchsorted(ids, 0, "left")
    assert live == np.searchsorted(ids, rows, "left")
    if case == "zoo_w16":
        assert rounds == 3


# ------------------------------------------------------------------- K6


def _ada_args(seed=0, R=50, w=8, u=12, dt=torch.float32, sdt=torch.float32,
              ids=torch.int32, lr=0.01, eps=1e-7):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((R, w), generator=g).to(sdt),
            torch.full((R, w), 0.1, dtype=dt), torch.arange(u, dtype=ids),
            torch.randn((u, w), generator=g).to(dt), lr, eps)


def test_k6_key_holds_no_addresses_and_fresh_tensors_hit():
    cache = _kernels.LaunchCache()
    a, b = _ada_args(0), _ada_args(1)
    assert ada_mod.record_key(*a) == ada_mod.record_key(*b)
    ptrs = {t.data_ptr() for t in a[:4] + b[:4]}
    assert not ptrs & {k for k in ada_mod.record_key(*a)
                       if isinstance(k, int)}
    rec = _find(cache, ada_mod, *a)
    assert _find(cache, ada_mod, *b) is rec and cache.builds == 1
    assert rec.calls == ()
    # a tensor lr: its layout, not its address or value
    lr1, lr2 = torch.tensor(0.01), torch.tensor(0.5)
    k1 = ada_mod.record_key(*_ada_args(lr=lr1))
    assert k1 == ada_mod.record_key(*_ada_args(lr=lr2))
    assert lr1.data_ptr() not in k1


@pytest.mark.parametrize("change", [
    dict(w=16), dict(R=51), dict(u=13), dict(dt=torch.bfloat16),
    dict(sdt=torch.bfloat16), dict(ids=torch.int64), dict(lr=0.02),
    dict(eps=1e-6), dict(lr=torch.tensor(0.01)),
    dict(lr=torch.tensor(0.01, dtype=torch.float64))])
def test_k6_changed_layout_or_constant_builds_a_new_record(change):
    cache = _kernels.LaunchCache()
    _find(cache, ada_mod, *_ada_args())
    _find(cache, ada_mod, *_ada_args(**change))
    assert cache.builds == 2
    _find(cache, ada_mod, *_ada_args(seed=3))
    assert cache.builds == 2


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
def test_k6_constants_are_the_roundings_of_lr_args(acc):
    for lr, eps in ((0.01, 1e-7), (0.3, 1e-10), (1.0 / 3.0, 0.1)):
        rec = ada_mod.find_record(*_ada_args(dt=acc, lr=lr, eps=eps),
                                  build_on_cpu=True)
        lr_as_is, c, prepared = rec.payload
        assert lr_as_is and prepared is None
        assert c == {"lr": ada_mod._lr_args(lr, acc, "cpu")[0],
                     "eps": float(torch.tensor(eps, dtype=acc))}
        if acc == torch.bfloat16:
            assert c["lr"] != lr
    # a card lr is read per call: converted where it is not float32
    for lr, as_is in ((torch.tensor(0.01), True),
                      (torch.tensor(0.01, dtype=torch.float64), False),
                      (torch.full((1, 1), 0.01), True)):
        rec = ada_mod.find_record(*_ada_args(dt=acc, lr=lr),
                                  build_on_cpu=True)
        assert rec.payload[0] is as_is and rec.payload[1]["lr"] == 0.0


def test_k6_validates_and_raises_as_before():
    def raises(match, changes):
        args = list(_ada_args())
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            ada_mod.find_record(*args, build_on_cpu=True)

    raises("slab: expected a contiguous 2-D", {0: torch.zeros(8, 50).t()})
    raises("acc: expected a contiguous 2-D",
           {1: torch.zeros(50, 8, dtype=torch.float64)})
    raises("must share the slab's shape", {1: torch.zeros(50, 4)})
    raises("uids: expected a contiguous", {2: torch.zeros(3, 4,
                                                            dtype=torch.int32)})
    raises("uids: expected a contiguous", {2: torch.zeros(12)})
    raises("ugrads: expected a contiguous", {3: torch.zeros(12, 4)})
    raises("ugrads: expected a contiguous",
           {3: torch.zeros(12, 8, dtype=torch.bfloat16)})
    raises("a tensor lr must hold one value", {4: torch.ones(2)})
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        adagrad_rows(m, m, torch.zeros(2, dtype=torch.int32, device="meta"),
                     torch.zeros(2, 8, device="meta"), 0.1, 1e-7)
    # the CPU wrapper runs the plain version, builds nothing
    before = (adagrad_rows.launches, ada_mod._CACHE.builds)
    adagrad_rows(*_ada_args())
    assert (adagrad_rows.launches, ada_mod._CACHE.builds) == before


# ------------------------------------------------------------------ K12


def _mom_args(seed=0, R=50, w=8, u=12, dt=torch.float32, sdt=torch.float32,
              ids=torch.int32, lr=0.01, m=0.9, nesterov=False):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((R, w), generator=g).to(sdt),
            (0.1 * torch.randn((R, w), generator=g)).to(dt),
            torch.arange(u, dtype=ids), torch.randn((u, w), generator=g).to(dt),
            lr, m, nesterov)


def test_k12_key_holds_no_addresses_and_fresh_tensors_hit():
    cache = _kernels.LaunchCache()
    a, b = _mom_args(0), _mom_args(1)
    assert mom_mod.record_key(*a) == mom_mod.record_key(*b)
    ptrs = {t.data_ptr() for t in a[:4] + b[:4]}
    assert not ptrs & {k for k in mom_mod.record_key(*a)
                       if isinstance(k, int)}
    rec = _find(cache, mom_mod, *a)
    assert _find(cache, mom_mod, *b) is rec and cache.builds == 1
    assert rec.calls == () and rec.payload[2] is None
    # a tensor lr: its layout, not its address or value
    lr1, lr2 = torch.tensor(0.01), torch.tensor(0.5)
    k1 = mom_mod.record_key(*_mom_args(lr=lr1))
    assert k1 == mom_mod.record_key(*_mom_args(lr=lr2))
    assert lr1.data_ptr() not in k1


@pytest.mark.parametrize("change", [
    dict(w=16), dict(w=1), dict(R=51), dict(u=13), dict(dt=torch.bfloat16),
    dict(sdt=torch.bfloat16), dict(ids=torch.int64), dict(lr=0.02),
    dict(m=0.8), dict(nesterov=True), dict(lr=torch.tensor(0.01)),
    dict(lr=torch.tensor(0.01, dtype=torch.float64))])
def test_k12_changed_layout_or_constant_builds_a_new_record(change):
    cache = _kernels.LaunchCache()
    _find(cache, mom_mod, *_mom_args())
    _find(cache, mom_mod, *_mom_args(**change))
    assert cache.builds == 2
    _find(cache, mom_mod, *_mom_args(seed=3))
    assert cache.builds == 2


@pytest.mark.parametrize("tr", [torch.float32, torch.bfloat16])
def test_k12_constants_rounded_once(tr):
    rnd = adam_mod._rnd
    for lr, m in ((0.01, 0.9), (0.3, 0.99), (1.0 / 3.0, 0.123456789)):
        for nest in (False, True):
            rec = mom_mod.find_record(*_mom_args(dt=tr, lr=lr, m=m,
                                                 nesterov=nest),
                                      build_on_cpu=True)
            lr_as_is, c, prepared = rec.payload
            assert lr_as_is and prepared is None
            assert c == {"m": rnd(m, tr), "neg_lr": rnd(-lr, tr)}
            if tr == torch.bfloat16:
                assert c["m"] != m and c["neg_lr"] != -lr
    # a card lr is read per call: converted where it is not float32
    for lr, as_is in ((torch.tensor(0.01), True),
                      (torch.tensor(0.01, dtype=torch.float64), False),
                      (torch.full((1, 1), 0.01), True)):
        rec = mom_mod.find_record(*_mom_args(dt=tr, lr=lr),
                                  build_on_cpu=True)
        assert rec.payload[0] is as_is
        assert rec.payload[1] == {"m": rnd(0.9, tr), "neg_lr": 0.0}


def test_k12_validates_and_raises_as_before():
    def raises(match, changes):
        args = list(_mom_args())
        for k, v in changes.items():
            args[k] = v
        with pytest.raises(ValueError, match=match):
            mom_mod.find_record(*args, build_on_cpu=True)

    raises("slab: expected a contiguous 2-D", {0: torch.zeros(8, 50).t()})
    raises("trace: expected a contiguous 2-D",
           {1: torch.zeros(50, 8, dtype=torch.float64)})
    raises("must share the slab's shape", {1: torch.zeros(50, 4)})
    raises("uids: expected a contiguous", {2: torch.zeros(3, 4,
                                                            dtype=torch.int32)})
    raises("uids: expected a contiguous", {2: torch.zeros(12)})
    raises("uvals: expected a contiguous", {3: torch.zeros(12, 4)})
    raises("uvals: expected a contiguous",
           {3: torch.zeros(12, 8, dtype=torch.bfloat16)})
    raises("a tensor lr must hold one value", {4: torch.ones(2)})
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        momentum_rows(m, m, torch.zeros(2, dtype=torch.int32, device="meta"),
                      torch.zeros(2, 8, device="meta"), 0.1, 0.9)
    # the CPU wrapper runs the plain version, builds nothing
    before = (momentum_rows.launches, mom_mod._CACHE.builds)
    momentum_rows(*_mom_args())
    assert (momentum_rows.launches, mom_mod._CACHE.builds) == before
