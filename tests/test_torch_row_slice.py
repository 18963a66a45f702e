"""Row-sliced tables (``DistributedEmbedding(row_slice=N)``) in the port
against the JAX package.

* The planner: ``maybe_slice_table_row``'s geometry, the strategies and
  the exchange plans' ``rbase``/``rsliced`` slot by slot, equal to the JAX
  package's (powers of two, capped at ``min(world, input_dim)``, the
  remainder on the first slices, column slicing first, world 1 never
  row-slices).
* The kernels' plain versions with row bases (K1 ``gather_combine``, K8
  ``ragged_combine``, K9 ``ragged_grad``) against a numpy transcription
  of the JAX lookup and backward (``parallel/lookup.py:167-223``,
  ``parallel/apply.py:202-261``) at the slice edges: ids at ``rbase - 1``,
  ``rbase``, ``rbase + rows - 1``, ``rbase + rows``, negative and past
  the table; gathers bitwise, the K20 unpack's sum of slices bitwise to
  the JAX chain ``total = total + part`` in slice order (a bfloat16 sum
  in the reverse order is the control that must fail).
* The world-8 forward and sparse steps: eight gloo ranks
  (``torch_dist_worker.py``, one group for the file) against the JAX
  layer on the 8-device CPU mesh, from the same tables and ids, with
  dense hot-1, dense multi-hot mean, ragged sum, ragged mean and weighted
  ragged inputs over row-sliced tables and the edge ids above. One-hot
  outputs bitwise, sums within float32 summation order (rtol 1e-6, atol
  1e-7); each rank's received block and slab bitwise JAX's; the tables
  gathered back bitwise the tables given (the weight round trip). A
  ``SparseSGD`` step against JAX's and against the port's unsliced step,
  a ``SparseAdagrad`` step against JAX's (JAX's row-slicing bounds: loss
  1e-5, tables rtol 1e-5 atol 1e-6); ``masked_reads`` with row slicing.
  Control: rank 3's row bases dropped fails the forward and the step
  bounds.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JaxRagged)
from distributed_embeddings_tpu.ops.packed_slab import unpack_rows_np
from distributed_embeddings_tpu.parallel import DistributedEmbedding as JaxDE
from distributed_embeddings_tpu.parallel import strategy as jstrategy
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad, SparseSGD as JaxSparseSGD)

from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import exchange_pack as xp
from distributed_embeddings_torch.ops import sparse_grad as sg
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.parallel import strategy as tstrategy

from torch_dist_worker import RankGroup

# the module (the package's ``embedding_lookup`` name is the function)
el = importlib.import_module(
    "distributed_embeddings_torch.ops.embedding_lookup")
torch.set_num_threads(1)

WORLD = 8
LOCAL_B = 4
B = WORLD * LOCAL_B
LR = 0.05
FWD_RTOL, FWD_ATOL = 1e-6, 1e-7
LOSS_ATOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_row_slice"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("dim,thr,world", [(103, 103 * 8 // 4 + 1, 8),
                                           (100, 1, 8), (5, 1, 8),
                                           (100, 401, 2), (100, 1, 1),
                                           (64, None, 8), (64, 10 ** 6, 8)])
def test_row_slice_geometry_matches_jax(dim, thr, world):
    cfg = {"input_dim": dim, "output_dim": 8}
    got = tstrategy.maybe_slice_table_row(cfg, thr, world)
    assert got == jstrategy.maybe_slice_table_row(cfg, thr, world)
    n = len(got)
    # a power of two, unless the cap min(world, input_dim) cut it
    assert n <= min(world, dim) and (n & (n - 1) == 0
                                     or n == min(world, dim))
    assert sum(c["input_dim"] for c in got) == dim
    rows = [c["input_dim"] for c in got]
    assert rows == sorted(rows, reverse=True) and rows[0] - rows[-1] <= 1


def _model(rng, n=12):
    return [{"input_dim": int(rng.integers(20, 400)),
             "output_dim": int(rng.choice([4, 8, 16])),
             "combiner": [None, "sum", "mean"][i % 3]} for i in range(n)]


@pytest.mark.parametrize("world", [1, 8])
@pytest.mark.parametrize("strategy", ["basic", "comm_balanced",
                                      "memory_balanced"])
@pytest.mark.parametrize("cst", [None, 1500])
def test_strategy_and_plan_match_jax(world, strategy, cst):
    """Strategies, slab layouts and the plans' row bases slot by slot;
    a table column slicing split is never row-sliced; world 1 never
    row-slices."""
    rng = np.random.default_rng(world * 7 + (cst or 0))
    configs = _model(rng)
    kw = dict(strategy=strategy, column_slice_threshold=cst, row_slice=600)
    t = DistributedEmbedding(configs, world, **kw)
    j = JaxDE(configs, world, **kw)
    for f in ("table_ids_list", "local_configs_list", "input_ids_list",
              "local_map_list", "rev_global_input_ids", "sliced_out_ranges",
              "row_sliced_out_ranges", "row_sliced_tables"):
        assert getattr(t.strategy, f) == getattr(j.strategy, f), f
    if world == 1:
        assert not t.strategy.row_sliced_tables
    else:
        assert t.strategy.row_sliced_tables
    for tid in t.strategy.row_sliced_tables:  # column slicing first
        assert len(tstrategy.maybe_slice_table_column(
            configs[tid], cst, world)) == 1
    encs = [("d", 3 if c["combiner"] else 1, 1) if i % 4 else
            (("r", 9) if c["combiner"] else ("d", 2, 1))
            for i, c in enumerate(configs)]
    tp, jp = t._get_plan(encs, 4), j._get_plan(encs, 4)
    for a, b in ((tp.groups, jp.groups), (tp.instances, jp.instances)):
        assert [dataclasses.astuple(x) for x in a] == [
            dataclasses.astuple(x) for x in b]
    for name in ("rows", "roff", "valid", "mean", "rbase", "rsliced"):
        for a, b in zip(getattr(tp, name), getattr(jp, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_row_slice_must_be_an_int():
    configs = [{"input_dim": 10, "output_dim": 4}] * 8
    for bad in (True, 1.5, "100"):
        with pytest.raises(TypeError, match="row_slice"):
            DistributedEmbedding(configs, 8, row_slice=bad)


# ---------------------------------------- the kernels' plain versions


def _edges(rbase, rows, dim):
    """The slice edges of one slot, and ids outside the table."""
    return [rbase - 1, rbase, rbase + rows - 1, rbase + rows, -1, -7,
            dim, dim + 100]


def _slots(rng, n, w, dtype):
    """``n`` slots of 4 row slices each of one 40-row table (slot ``k``
    slice ``k % 4``), their slab ``[4 * 10, w]`` and per-slot meta."""
    dim, k = 40, 4
    slab = torch.from_numpy(rng.normal(size=(dim, w)).astype(np.float32)
                            ).to(dtype)
    rows = torch.full((n,), dim // k, dtype=torch.int64)
    rbase = torch.as_tensor([(s % k) * (dim // k) for s in range(n)],
                            dtype=torch.int64)
    roff = rbase.clone()  # each slice's rows at its own slab offset
    return dim, slab, rows, roff, rbase


def _np_gather(slab, ids, rows, roff, rbase, mask, div):
    """The JAX lookup's dense branch (``lookup.py:167-184``) in numpy:
    range-local ids, clip, gather, the 0/1 mask multiply, sum, divide."""
    s = slab.float().numpy()
    loc = ids - rbase[:, None, None]
    grow = np.clip(loc, 0, rows[:, None, None] - 1) + roff[:, None, None]
    g = s[grow]
    inr = ((loc >= 0) & (loc < rows[:, None, None])) | (mask[:, None, None]
                                                        == 0)
    return (g * inr[..., None]).sum(2) / div[:, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hot", [1, 3])
def test_k1_row_base_plain(dtype, hot):
    rng = np.random.default_rng(hot)
    n, b, w = 8, 10, 8
    dim, slab, rows, roff, rbase = _slots(rng, n, w, dtype)
    ids = rng.integers(0, dim, size=(n, b, hot)).astype(np.int64)
    for s in range(n):  # the edges in the first rows
        e = _edges(int(rbase[s]), int(rows[s]), dim)
        ids[s].reshape(-1)[:len(e)] = e
    mask = np.asarray([1, 1, 0, 1, 1, 1, 0, 1], np.int32)  # two unmasked
    div = np.full(n, float(hot), np.float32)
    want = _np_gather(slab, ids, rows.numpy(), roff.numpy(), rbase.numpy(),
                      mask, div)
    got = el.gather_combine(slab, torch.from_numpy(ids.astype(np.int32)),
                            rows, roff, torch.from_numpy(div),
                            torch.from_numpy(mask), rbase=rbase)
    want_t = torch.from_numpy(want.astype(np.float32)).to(dtype)
    if hot == 1:
        assert torch.equal(got, want_t)
    else:
        torch.testing.assert_close(got.float(), want_t.float(),
                                   rtol=1e-6 if dtype == torch.float32
                                   else 8e-3, atol=1e-7)
    # a masked id outside its slice reads exact zero (hot 1)
    if hot == 1:
        out = ids[:, :, 0] - rbase.numpy()[:, None]
        outside = ((out < 0) | (out >= rows.numpy()[:, None])) & (
            mask[:, None] == 1)
        assert outside.any() and not got[torch.from_numpy(outside)].any()
    # control: without the row bases the slices read the wrong rows
    bad = el.gather_combine(slab, torch.from_numpy(ids.astype(np.int32)),
                            rows, roff, torch.from_numpy(div),
                            torch.from_numpy(mask))
    assert not torch.equal(bad, got)


def _csr(rng, n, b, cap, dim, rbase, rows):
    """Per slot a CSR of 0-4 ids a row holding the slot's edge ids."""
    values = np.zeros((n, cap), np.int64)
    splits = np.zeros((n, b + 1), np.int64)
    for s in range(n):
        lens = rng.integers(0, 5, size=b)
        lens[0] = 4
        splits[s, 1:] = np.cumsum(lens)
        k = int(splits[s, -1])
        v = rng.integers(0, dim, size=k)
        e = _edges(int(rbase[s]), int(rows[s]), dim)[:min(k, 8)]
        v[:len(e)] = e
        values[s, :k] = v
    return values, splits


def _np_ragged(slab, values, splits, rows, roff, rbase, mask, mean,
               weights):
    """The JAX ragged lookup (``ragged_decode`` + the ``"r"``/``"rw"``
    branch) in numpy float64 (for a float32 slab: JAX sums the segment
    in float32; the tolerance covers the order)."""
    s = slab.float().numpy().astype(np.float64)
    n, b = splits.shape[0], splits.shape[1] - 1
    out = np.zeros((n, b, s.shape[1]))
    for k in range(n):
        for r in range(b):
            lo, hi = splits[k, r], splits[k, r + 1]
            for p in range(lo, hi):
                loc = values[k, p] - rbase[k]
                row = s[min(max(loc, 0), rows[k] - 1) + roff[k]]
                f = 1.0 if weights is None else float(weights[k, p])
                if mask[k] and not 0 <= loc < rows[k]:
                    f *= 0.0
                out[k, r] += row * f
            if mean[k]:
                out[k, r] /= max(hi - lo, 1)
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_k8_row_base_plain(weighted):
    rng = np.random.default_rng(5 + weighted)
    n, b, cap, w = 8, 5, 24, 8
    dim, slab, rows, roff, rbase = _slots(rng, n, w, torch.float32)
    values, splits = _csr(rng, n, b, cap, dim, rbase.numpy(), rows.numpy())
    mask = np.asarray([1, 1, 1, 0, 1, 1, 1, 1], np.int32)
    mean = np.asarray([0, 1] * 4, np.int32)
    wts = (rng.uniform(0.5, 2, size=(n, cap)).astype(np.float32)
           if weighted else None)
    want = _np_ragged(slab, values, splits, rows.numpy(), roff.numpy(),
                      rbase.numpy(), mask, mean, wts)
    args = (slab, torch.from_numpy(values), torch.from_numpy(splits), rows,
            roff)
    kw = dict(mean=torch.from_numpy(mean), mask=torch.from_numpy(mask),
              weights=None if wts is None else torch.from_numpy(wts))
    got = el.ragged_combine(*args, **kw, rbase=rbase)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a row's mean divides by its whole length: the sum over the table's
    # slices is the unsliced mean
    bad = el.ragged_combine(*args, **kw)
    assert not torch.equal(bad, got)


def test_k9_row_base_plain():
    rng = np.random.default_rng(9)
    n, b, cap, w = 8, 5, 24, 8
    dim, _, rows, roff, rbase = _slots(rng, n, w, torch.float32)
    values, splits = _csr(rng, n, b, cap, dim, rbase.numpy(), rows.numpy())
    g = torch.from_numpy(rng.normal(size=(n, b, w)).astype(np.float32))
    mean = torch.from_numpy(np.asarray([1, 0] * 4, np.int32))
    sent = 1000
    ids, vals = sg.ragged_grad(g, torch.from_numpy(splits),
                               values=torch.from_numpy(values), rows=rows,
                               roff=roff, sentinel=sent, mean=mean,
                               rbase=rbase)
    # the JAX backward (apply.py:222-261): range-local ids, the sentinel
    # outside the slice; the row's whole cotangent over its whole length
    for k in range(n):
        for r in range(b):
            lo, hi = splits[k, r], splits[k, r + 1]
            for p in range(lo, hi):
                loc = values[k, p] - int(rbase[k])
                want = loc + int(roff[k]) if 0 <= loc < int(rows[k]) \
                    else sent
                assert int(ids[k, p]) == want
                gw = g[k, r] / float(max(hi - lo, 1)) if mean[k] else g[k, r]
                assert torch.equal(vals[k, p], gw)
        assert (ids[k, splits[k, -1]:] == sent).all()
    # control: without the bases the out-of-slice ids train the slice
    bad, _ = sg.ragged_grad(g, torch.from_numpy(splits),
                            values=torch.from_numpy(values), rows=rows,
                            roff=roff, sentinel=sent, mean=mean)
    assert not torch.equal(bad, ids)
    with pytest.raises(ValueError, match="rbase"):
        sg.ragged_grad(g, torch.from_numpy(splits), cap=cap, rbase=rbase)


def test_row_base_records_are_keyed_on_the_bases():
    """The wrappers' records with row bases, built on CPU tensors as the
    card path builds them (the wrapper's own argument order): found again
    under the wrapper's key, apart from the record without bases; K9's
    record rests on an id stream."""
    rng = np.random.default_rng(12)
    n, b, cap, w = 8, 5, 24, 8
    dim, slab, rows, roff, rbase = _slots(rng, n, w, torch.float32)
    values, splits = _csr(rng, n, b, cap, dim, rbase.numpy(), rows.numpy())
    values, splits = torch.from_numpy(values), torch.from_numpy(splits)
    ids = torch.from_numpy(values.numpy()[:, :b, None].copy())
    div = torch.ones(n)
    g = torch.zeros((n, b, w))
    k1 = _kernels.LaunchCache()
    rec = el.find_gather_record(k1, slab, ids, rows, roff, div, None, None,
                                rbase, build_on_cpu=True)
    assert k1.get(el.gather_record_key(slab, ids, rows, roff, div, None,
                                       None, rbase)) is rec
    assert k1.get(el.gather_record_key(slab, ids, rows, roff, div)) is None
    k8 = _kernels.LaunchCache()
    rec = el.find_ragged_record(k8, slab, values, splits, rows, roff, None,
                                None, None, None, rbase, build_on_cpu=True)
    assert k8.get(el.ragged_record_key(slab, values, splits, rows, roff,
                                       rbase=rbase)) is rec
    args = (g, splits, cap, values, rows, roff, 0, None, None, None, False,
            rbase)
    sg._K9.clear()
    rec = sg.find_ragged_grad_record(*args, build_on_cpu=True)
    assert sg._K9.get(sg.ragged_grad_key(*args)) is rec
    assert sg._K9.get(sg.ragged_grad_key(*args[:-1])) is None
    with pytest.raises(ValueError, match="rbase"):
        sg.build_ragged_grad_record(g, splits, cap, rbase=rbase)


def _unpack_case(dtype, k, w, b=5, unaligned=False):
    """A CopyPlan summing ``k`` blocks of a ``[k, b, s]`` tensor (each
    block one source rank's row) into one ``[b, w]`` output, with a
    plain copy beside it."""
    s = k * w + 4 + (1 if unaligned else 0)
    parts = [(0, r * b * s + r * w + (1 if unaligned else 0), s)
             for r in range(k)]
    plan = xp.CopyPlan([(0, 2, s, 0, b * w, w, b, w)],
                       sums=[(0, 0, w, b, w, parts)])
    return plan, (k, b, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k20_sum_plain_is_the_jax_chain(dtype, k):
    rng = np.random.default_rng(k)
    plan, shape = _unpack_case(dtype, k, 6)
    src = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                           ).to(dtype)
    src.view(-1)[::7] *= 1e4  # magnitudes apart: the order matters
    out = torch.full((2 * 5 * 6,), -3.0, dtype=dtype)
    xp.pack_columns(plan, [src], [out])
    s = shape[2]
    blocks = [src.as_strided((5, 6), (s, 1), r * 5 * s + r * 6)
              for r in range(k)]
    total = blocks[0]
    for part in blocks[1:]:
        total = total + part  # the JAX unpack's chain, slice order
    assert torch.equal(out[:30].view(5, 6), total)
    if dtype == torch.bfloat16 and k >= 4:  # control: another order
        rev = blocks[-1]
        for part in blocks[-2::-1]:
            rev = rev + part
        assert not torch.equal(out[:30].view(5, 6), rev)


def test_k20_sum_descriptors():
    """Units of 4 elements where everything is aligned, 1 where a part
    is not; the mode holds the dtype, unit and part count; the parts'
    addresses follow the launch's descriptors."""
    for dtype, unaligned, per in ((torch.float32, False, 2),
                                  (torch.bfloat16, False, 2),
                                  (torch.float32, True, 1)):
        plan, shape = _unpack_case(dtype, 4, 6, unaligned=unaligned)
        src = torch.zeros(shape, dtype=dtype)
        out = torch.zeros(60, dtype=dtype)
        desc, addrs = xp.sum_descriptors(plan, [src], [out], dtype)
        assert len(desc) == 1 and len(addrs[0]) == 4
        mode = int(desc[0, 7])
        assert mode >> 8 == 4
        assert mode & 0xff == xp.SUM_MODE + 3 * (dtype == torch.bfloat16) \
            + int(np.log2(per))
        assert int(desc[0, 5]) == 6 // per
        chunks = xp.launch_chunks(plan, [src], [out], dtype, dtype, "t")
        (arr, tiles, n, n_rows), = chunks
        assert n == 2 and n_rows == 1 and tiles == 2
        assert arr[1, 0] == 0 and list(arr[2, :4]) == list(addrs[0])
    with pytest.raises(ValueError, match="two parts"):
        xp.CopyPlan([], sums=[(0, 0, 4, 1, 4, [(0, 0, 4)])])


# ------------------------------------------------------------- world 8

CONFIGS = [
    {"input_dim": 100, "output_dim": 8, "combiner": None},
    {"input_dim": 100, "output_dim": 8, "combiner": "mean"},
    {"input_dim": 100, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 100, "output_dim": 8, "combiner": "mean"},
    {"input_dim": 100, "output_dim": 4, "combiner": "sum"},
    {"input_dim": 30, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 22, "output_dim": 8, "combiner": None},
    {"input_dim": 26, "output_dim": 4, "combiner": None},
]
ROW_THR = 100 * 8 // 4 + 1  # the 100-row width-8 tables split 4 ways
#: per input: dense hotness, or "r"/"rw" for a ragged input
KINDS = [1, 3, "r", "r", "rw", 2, 1, 1]


def _table_edges():
    """Per table the edge ids of its row slices (port planner)."""
    de = DistributedEmbedding(CONFIGS, WORLD, strategy="memory_balanced",
                              row_slice=ROW_THR)
    out = []
    for tid, c in enumerate(CONFIGS):
        e = [-1, -5, c["input_dim"], c["input_dim"] + 9]
        for tids, cfgs in zip(de.strategy.table_ids_list,
                              de.strategy.local_configs_list):
            for t, cfg in zip(tids, cfgs):
                if t == tid and "_row_base" in cfg:
                    e += _edges(cfg["_row_base"], cfg["input_dim"],
                                c["input_dim"])[:4]
        out.append(sorted(set(e)))
    return de, out


def make_inputs(rng, edges=True, in_table=False):
    """Global inputs (dense ``[B, hot]`` int32; ragged as per-rank CSR
    entries ``("ragged", values, splits, weights)``) with each table's
    slice-edge ids in the first rows (``in_table``: only those inside
    the table)."""
    _, table_edges = _table_edges()
    cap = LOCAL_B * 4
    out = []
    for c, kind, e in zip(CONFIGS, KINDS, table_edges):
        if not edges:
            e = []
        elif in_table:
            e = [x for x in e if 0 <= x < c["input_dim"]]
        if isinstance(kind, int):
            ids = rng.integers(0, c["input_dim"], size=(B, kind))
            ids.reshape(-1)[:len(e)] = e
            out.append(ids.astype(np.int32))
            continue
        vals, splits, wts = [], [], []
        for r in range(WORLD):
            lens = rng.integers(0, 5, size=LOCAL_B)
            n = int(lens.sum())
            v = np.zeros(cap, np.int32)
            v[:n] = rng.integers(0, c["input_dim"], size=n)
            if r == 0:
                k = min(n, len(e))
                v[:k] = e[:k]
            vals.append(v)
            splits.append(np.concatenate([[0], np.cumsum(lens)])
                          .astype(np.int32))
            wts.append(np.where(np.arange(cap) < n,
                                rng.uniform(0.5, 2, cap), 0)
                       .astype(np.float32))
        out.append(("ragged", vals, splits, wts if kind == "rw" else None))
    return out


def tables_of(rng):
    return [rng.normal(size=(c["input_dim"], c["output_dim"]))
            .astype(np.float32) for c in CONFIGS]


def jax_inputs(inputs):
    out = []
    for x in inputs:
        if isinstance(x, tuple):
            _, vals, splits, wts = x
            out.append(JaxRagged(
                values=jnp.asarray(np.concatenate(vals)),
                row_splits=jnp.asarray(np.concatenate(splits)),
                weights=(None if wts is None
                         else jnp.asarray(np.concatenate(wts)))))
        else:
            out.append(jnp.asarray(x))
    return out


def _jde(spec):
    return JaxDE(spec["configs"], world_size=WORLD,
                 strategy=spec.get("strategy", "basic"),
                 row_slice=spec.get("row_slice"),
                 masked_reads=spec.get("masked_reads", False))


def jax_forward(spec):
    """JAX's world-8 forward: per-rank received blocks, global outputs
    and per-rank logical slabs."""
    jde = _jde(spec)
    params = jde.set_weights(spec["tables"], mesh=_mesh())
    inputs = jax_inputs(spec["inputs"])

    def fwd(p, *inps):
        outs, res = jde.forward_with_residuals(p, list(inps))
        return tuple(outs), res[1]

    outs, ids = jax.jit(jax.shard_map(
        fwd, mesh=_mesh(), in_specs=(P("data"),) * (1 + len(inputs)),
        out_specs=(P("data"), P("data"))))(params, *inputs)
    slabs = {k: [unpack_rows_np(np.asarray(v[r]), int(k[1:]))
                 for r in range(WORLD)] for k, v in params.items()}
    return (np.asarray(ids).reshape(WORLD, WORLD, -1),
            [np.asarray(o) for o in outs], slabs)


def forward_errors(ranks, outs):
    """Per rank and output the largest difference from JAX's beyond the
    bound (one-hot outputs: any difference)."""
    bad = []
    for r, got in enumerate(ranks):
        for i, (o, want) in enumerate(zip(got["outs"], outs)):
            want = want[r * LOCAL_B:(r + 1) * LOCAL_B]
            if KINDS[i] == 1:
                ok = np.array_equal(o, want)
            else:
                ok = np.allclose(o, want, rtol=FWD_RTOL, atol=FWD_ATOL)
            if not ok:
                bad.append((r, i))
    return bad


def spec_of(seed, **kw):
    rng = np.random.default_rng(seed)
    return dict(configs=CONFIGS, strategy="memory_balanced",
                row_slice=ROW_THR, tables=tables_of(rng),
                inputs=make_inputs(rng), **kw)


def test_world8_row_sliced_forward_matches_jax(group):
    spec = spec_of(3)
    group.submit("forward", spec)
    ids, outs, slabs = jax_forward(spec)
    ranks = group.collect()
    assert forward_errors(ranks, outs) == []
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ids"], ids[r])
        for k, s in got["slabs"].items():
            np.testing.assert_array_equal(s, slabs[k][r][:s.shape[0]])
    for a, b in zip(ranks[0]["tables"], spec["tables"]):
        np.testing.assert_array_equal(a, b)  # the weight round trip
    de, _ = _table_edges()
    assert de.strategy.row_sliced_tables >= {0, 1, 2, 3, 4}
    # an id outside a row-sliced table reads zero (one-hot table 0)
    t0 = np.concatenate([g["outs"][0] for g in ranks])
    ids0 = spec["inputs"][0][:, 0]
    outside = (ids0 < 0) | (ids0 >= CONFIGS[0]["input_dim"])
    assert outside.any() and not t0[outside].any()
    # control: rank 3 without its row bases
    group.submit("forward", dict(spec, drop_rbase=3))
    bad = forward_errors(group.collect(), outs)
    assert bad and {r for r, _ in bad} == set(range(WORLD))


def test_world8_masked_reads_with_row_slicing(group):
    spec = spec_of(4, masked_reads=True)
    group.submit("forward", spec)
    _, outs, _ = jax_forward(spec)
    ranks = group.collect()
    assert forward_errors(ranks, outs) == []
    t6 = np.concatenate([g["outs"][6] for g in ranks])  # unsliced
    ids6 = spec["inputs"][6][:, 0]
    bad = (ids6 < 0) | (ids6 >= CONFIGS[6]["input_dim"])
    assert bad.any() and not t6[bad].any()


def _train_spec(seed, optimizer, row_slice=ROW_THR, in_table=False, **kw):
    rng = np.random.default_rng(seed)
    tables = tables_of(rng)
    steps = [make_inputs(rng, edges=k == 0, in_table=in_table)
             for k in range(2)]
    return dict(configs=CONFIGS, strategy="memory_balanced",
                row_slice=row_slice, tables=tables, steps=steps,
                optimizer=optimizer, lr=LR, **kw)


@functools.lru_cache(maxsize=None)
def _jax_train(seed, optimizer):
    spec = _train_spec(seed, optimizer)
    jde = _jde(spec)
    params = jde.set_weights(spec["tables"], mesh=_mesh())
    opt = (JaxSparseAdagrad(initial_accumulator_value=0.1)
           if optimizer == "adagrad" else JaxSparseSGD())
    ost = opt.init(params)
    n = len(CONFIGS)

    def step(p, o, *inps):
        local, lo = jde.local_view(p), jde.local_view(o)
        outs, res = jde.forward_with_residuals(local, list(inps))
        loss, g = jax.value_and_grad(lambda os: sum(
            jnp.mean(x.astype(jnp.float32) ** 2) for x in os))(outs)
        new, no = jde.sparse_apply_gradients(local, lo, res, g, opt, LR)
        return jde.stacked_view(new), jde.stacked_view(no), loss[None]

    fn = jax.jit(jax.shard_map(
        step, mesh=_mesh(), in_specs=(P("data"),) * (2 + n),
        out_specs=(P("data"),) * 3))
    losses = []
    for inputs in spec["steps"]:
        params, ost, loss = fn(params, ost, *jax_inputs(inputs))
        losses.append(np.asarray(loss))
    host = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ost))
    return spec, np.stack(losses, axis=1), jde.get_weights(params), host


def _step_errors(ranks, jlosses, jtables):
    """``(losses beyond 1e-5, tables beyond rtol 1e-5 atol 1e-6)``."""
    loss_bad = [r for r, got in enumerate(ranks)
                if np.abs(np.subtract(got["losses"], jlosses[r])).max()
                > LOSS_ATOL]
    tab_bad = [t for t, (a, b) in enumerate(zip(ranks[0]["tables"], jtables))
               if not np.allclose(a, b, rtol=RTOL, atol=ATOL)]
    return loss_bad, tab_bad


def test_world8_row_sliced_sgd_step_matches_jax_and_unsliced(group):
    spec = _train_spec(21, "sgd")
    group.submit("train", spec)
    _, jlosses, jtables, _ = _jax_train(21, "sgd")
    ranks = group.collect()
    assert _step_errors(ranks, jlosses, jtables) == ([], [])
    moved = [t for t, (a, b) in enumerate(zip(jtables, spec["tables"]))
             if not np.array_equal(a, b)]
    assert moved == list(range(len(CONFIGS)))
    # the port's own unsliced step from the same state (ids inside the
    # tables: outside, an unsliced table clips and a sliced one reads 0)
    inside = _train_spec(23, "sgd", in_table=True)
    sliced = group.run("train", inside)
    unsliced = group.run("train", dict(inside, row_slice=None))
    assert _step_errors(sliced, [u["losses"] for u in unsliced],
                        unsliced[0]["tables"]) == ([], [])
    # control: rank 3 without its row bases
    bad = group.run("train", dict(spec, drop_rbase=3))
    assert _step_errors(bad, jlosses, jtables)[1]


def test_world8_row_sliced_adagrad_step_matches_jax(group):
    spec = _train_spec(22, "adagrad")
    group.submit("train", spec)
    _, jlosses, jtables, _ = _jax_train(22, "adagrad")
    ranks = group.collect()
    assert _step_errors(ranks, jlosses, jtables) == ([], [])


@pytest.mark.parametrize("dp_input", [True, False])
def test_hybrid_state_from_jax_carries_row_sliced_state(dp_input):
    """``hybrid_state_from_jax`` on a row-sliced layer (either input
    form): each rank's slab and ``SparseAdagrad`` accumulator are JAX's
    rows of that rank after its Adagrad steps, bit for bit (the slab
    layout is the same in both packages; only the lane packing
    differs)."""
    from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
    from distributed_embeddings_torch.parallel import SparseAdagrad
    from distributed_embeddings_torch.utils.convert import (
        flax_dense_tree, hybrid_state_from_jax)

    spec, _, jtables, (jparams, jost) = _jax_train(22, "adagrad")
    cfg = DLRMConfig(table_sizes=[10] * 8, embedding_dim=8,
                     num_numerical_features=2, bottom_mlp_dims=(8,),
                     top_mlp_dims=(4, 1))
    dense = DLRMDense(cfg, device="cpu")
    tree = flax_dense_tree(dense)
    de = DistributedEmbedding(CONFIGS, WORLD, strategy="memory_balanced",
                              row_slice=ROW_THR, dp_input=dp_input)
    for r in range(WORLD):
        de._rank = r  # a rank's copy without a group: no collective runs
        st = hybrid_state_from_jax(
            de, dense, jtables, tree, 2, emb_opt_state=jost,
            emb_optimizer=SparseAdagrad(initial_accumulator_value=0.1),
            device="cpu")
        for k, v in st.emb_params.items():
            w = int(k[1:])
            np.testing.assert_array_equal(
                v[0].numpy(), unpack_rows_np(jparams[k][r], w)[:v.shape[1]])
            np.testing.assert_array_equal(
                st.emb_opt_state[k][0].numpy(),
                unpack_rows_np(jost[k][r], w)[:v.shape[1]])
