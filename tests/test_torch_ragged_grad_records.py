"""K9's launch record (``ops/sparse_grad.py``: ``ragged_grad_key``,
``build_ragged_grad_record``) on CPU tensors: the record is built without
a launch (``build_on_cpu``), so its key, its reuse, every rebuild and
every raise run here. All exact (integers, dtypes, shapes).

  - the key holds the constant facts (``cap``, ``sentinel``, the id
    stream's dtype, ``reciprocal``, which of ``values``, ``rows``,
    ``roff``, ``mean`` and ``weights`` are given) and the layouts of the
    tensors given, no address: fresh tensors of the same layouts find the
    record, a changed fact or layout builds another;
  - the record's payload gives the outputs' shapes and dtypes as the
    plain version makes them;
  - it validates as the wrapper always has on the card, raising the same
    errors; the CPU wrapper runs the plain version and builds nothing.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.ops import _kernels, ragged_grad
from distributed_embeddings_torch.ops import sparse_grad as sg

torch.set_num_threads(1)


def _args(seed=0, n=3, b=5, w=8, cap=12, dt=torch.float32,
          vdt=torch.int32, ids=True, mean=True, weights=False,
          sentinel=99, ids_dtype=None, reciprocal=False, strided=False):
    """A K9 call's arguments (the ``ragged_grad_key`` order)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, (n, b))
    splits = torch.from_numpy(np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(lengths, 1)], 1))
    g = torch.from_numpy(rng.normal(size=(b, n, w)).astype(np.float32)
                         ).to(dt)
    g = g.transpose(0, 1) if strided else g.transpose(0, 1).contiguous()
    values = rows = roff = None
    if ids:
        values = torch.from_numpy(rng.integers(-2, 30, (n, cap))).to(vdt)
        rows = torch.full((n,), 25, dtype=torch.int64)
        roff = torch.arange(n, dtype=torch.int64) * 25
    m = torch.tensor([1, 0, 1][:n], dtype=torch.int32) if mean else None
    wt = (torch.from_numpy(rng.random((n, cap)).astype(np.float32))
          if weights else None)
    return (g, splits, cap, values, rows, roff, sentinel, ids_dtype, m, wt,
            reciprocal)


def _find(cache, *args):
    return _kernels.find_or_build(cache, sg.ragged_grad_key(*args),
                                  sg.build_ragged_grad_record, True, True,
                                  *args)


def test_key_holds_no_addresses_and_fresh_tensors_hit():
    cache = _kernels.LaunchCache()
    a, b = _args(0, weights=True), _args(1, weights=True)
    assert sg.ragged_grad_key(*a) == sg.ragged_grad_key(*b)
    ptrs = {t.data_ptr() for t in a + b if isinstance(t, torch.Tensor)}
    assert not ptrs & {k for k in sg.ragged_grad_key(*a)
                       if isinstance(k, int)}
    rec = _find(cache, *a)
    assert _find(cache, *b) is rec and cache.builds == 1
    assert rec.calls == ()


@pytest.mark.parametrize("change", [
    dict(cap=13), dict(sentinel=98), dict(ids_dtype=torch.int64),
    dict(reciprocal=True), dict(mean=False), dict(weights=True),
    dict(ids=False), dict(dt=torch.bfloat16), dict(vdt=torch.int64),
    dict(strided=True), dict(w=16), dict(b=6), dict(n=2)])
def test_changed_fact_or_layout_builds_a_new_record(change):
    cache = _kernels.LaunchCache()
    _find(cache, *_args())
    _find(cache, *_args(**change))
    assert cache.builds == 2
    _find(cache, *_args(seed=3))
    assert cache.builds == 2


@pytest.mark.parametrize("ids,ids_dtype,vdt,want", [
    (True, None, torch.int32, torch.int32),
    (True, None, torch.int64, torch.int64),
    (True, torch.int64, torch.int32, torch.int64),
    (False, None, torch.int32, None)])
def test_payload_gives_the_plain_versions_outputs(ids, ids_dtype, vdt,
                                                  want):
    args = _args(ids=ids, ids_dtype=ids_dtype, vdt=vdt, dt=torch.bfloat16)
    rec = _find(_kernels.LaunchCache(), *args)
    shape, dtype, idt, dev = rec.payload[:4]
    pi, pv = sg.ragged_grad_plain(
        args[0], args[1], cap=args[2], values=args[3], rows=args[4],
        roff=args[5], sentinel=args[6], ids_dtype=args[7], mean=args[8],
        weights=args[9], reciprocal=args[10])
    assert (shape, dtype, dev) == (tuple(pv.shape), pv.dtype,
                                   torch.device("cpu"))
    assert idt == want == (None if pi is None else pi.dtype)
    assert rec.payload[4] is None


def test_validates_and_raises_as_before():
    def raises(match, **changes):
        args = list(_args(weights=True))
        names = ("g", "splits", "cap", "values", "rows", "roff", "sentinel",
                 "ids_dtype", "mean", "weights", "reciprocal")
        for k, v in changes.items():
            args[names.index(k)] = v
        with pytest.raises(ValueError, match=match):
            sg.find_ragged_grad_record(*args, build_on_cpu=True)

    g = _args()[0]
    raises("g: expected float32/bfloat16", g=g.double())
    raises("g: expected float32/bfloat16", g=g[:, :, ::2])
    raises("splits: expected a contiguous", splits=torch.zeros(
        3, 6, dtype=torch.int32))
    raises("values: 12 per slot for a capacity of 13", cap=13,
           weights=torch.zeros(3, 13))
    raises("values: expected an", values=torch.zeros(3, 12))
    raises("rows: expected a contiguous", rows=torch.zeros(3))
    raises("roff: expected a contiguous", roff=torch.zeros(
        2, dtype=torch.int64))
    raises("ids_dtype torch.float32 is not int32/int64",
           ids_dtype=torch.float32)
    raises("mean: expected a contiguous", mean=torch.zeros(3))
    raises("weights: 4 per slot for a capacity of 12",
           weights=torch.zeros(3, 4))
    raises("weights: expected an", weights=torch.zeros(
        3, 12, dtype=torch.float64))
    m = torch.zeros(3, 5, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        ragged_grad(m, torch.zeros(3, 6, dtype=torch.int64, device="meta"),
                    cap=4)
    # the wrapper's own argument checks, before any record
    with pytest.raises(ValueError, match="ragged_grad needs cap="):
        ragged_grad(g, _args()[1])
    with pytest.raises(ValueError, match="an id stream needs rows="):
        ragged_grad(g, _args()[1], values=_args()[3])


def test_cpu_wrapper_runs_the_plain_version_and_builds_nothing():
    args = _args(weights=True)
    before = (ragged_grad.launches, sg._K9.builds)
    gi, gv = ragged_grad(args[0], args[1], cap=args[2], values=args[3],
                         rows=args[4], roff=args[5], sentinel=args[6],
                         mean=args[8], weights=args[9])
    assert (ragged_grad.launches, sg._K9.builds) == before
    pi, pv = sg.ragged_grad_plain(args[0], args[1], cap=args[2],
                                  values=args[3], rows=args[4],
                                  roff=args[5], sentinel=args[6],
                                  mean=args[8], weights=args[9])
    assert torch.equal(gi, pi) and torch.equal(gv, pv)
