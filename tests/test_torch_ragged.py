"""The ragged (CSR) path against the JAX package at toy size: the CSR
bookkeeping (K10), the ragged lookup (K8) and its backward (K9) through
their plain versions on the CPU, ``Ragged`` and ``SparseIds`` inputs in
``DistributedEmbedding`` at world 1, the ragged sparse backward, and a
toy DLRM trained on ragged inputs, both packages starting from one
state carried over with ``utils/convert.py:hybrid_state_from_jax``.

Tolerances, with their reasons:
  - ``row_to_split``, ``ragged_row_ids``, lengths -> splits (``csr_seg``)
    and every id stream: bit-exact (index arithmetic);
  - the lookups, float32 tables: rtol 1e-6 (both add in float32 in
    position order; the bound allows another order);
  - the lookups, bfloat16 tables: JAX adds a row's products in bfloat16,
    rounding every add, where the port adds in float32 and rounds once,
    so a row of k ids is within k + 1 bf16 ulps of the sum of |w x|
    (one per add, one for the final rounding and the mean division);
  - ``combiner_grad_values`` and the ragged cotangent rows: bit-exact in
    float32 and in bfloat16 (the same rounding after each op);
  - ``sparse_apply_gradients``: rtol 1e-6 (duplicate adds in another
    order);
  - 10-step ragged DLRM trajectory, float32: losses, tables and dense
    params within 1e-5; bf16 compute over float32 tables (the bench's
    ``multihot_ragged`` precision): bf16 rounds at other places in the
    two frameworks' matmuls and the interaction backward, so losses
    within 2e-2, dense params within 5e-3 and tables within 1e-3 (each
    update is lr times a bf16 cotangent of magnitude < 0.1);
  - ``make_hybrid_train_loop`` against single steps, and the non-finite
    guard: bitwise;
  - 3 ``SparseAdagrad`` steps (sparse regime forced) on float32 state:
    within 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JRagged, SparseIds as JSparseIds,
    embedding_lookup as jax_embedding_lookup,
    ragged_row_ids as jax_ragged_row_ids, row_to_split as jax_row_to_split)
from distributed_embeddings_tpu.ops.sparse_grad import (
    combiner_grad_values as jax_cgv)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import apply as jax_apply
from distributed_embeddings_tpu.parallel import lookup as jax_lookup
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad, SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.models import (
    DLRMConfig, DLRMDense, bce_with_logits)
from distributed_embeddings_torch.ops import (
    Ragged, SparseIds, combiner_grad_values, embedding_lookup,
    lengths_to_splits, ragged_row_ids, row_to_split)
from distributed_embeddings_torch.ops.embedding_lookup import weight_floats
from distributed_embeddings_torch.ops.packed_slab import unpack_rows_np
from distributed_embeddings_torch.parallel import (
    SGD, DistributedEmbedding, SparseAdagrad, SparseSGD,
    make_hybrid_train_loop, make_hybrid_train_step)
from distributed_embeddings_torch.parallel import apply as t_apply
from distributed_embeddings_torch.parallel import lookup as t_lookup
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

from torch_parity import to_np

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(rng, b, vocab, max_hot, cap=None, bad=True, weighted=False,
          pad_id=0, min_hot=0):
    """One CSR batch as numpy: ``(values [cap], splits [b + 1], weights
    [cap] or None, rows)``; ``bad``: ~15% negative or past-the-table
    ids; ``cap`` below the total truncates the last rows; padding
    positions hold ``pad_id`` (a valid id, which must still be
    ignored)."""
    hots = rng.integers(min_hot, max_hot + 1, size=b)
    splits = np.zeros(b + 1, np.int32)
    np.cumsum(hots, out=splits[1:])
    nnz = int(splits[-1])
    cap = nnz + 3 if cap is None else cap
    ids = rng.integers(0, vocab, size=nnz)
    if bad:
        flip = rng.random(nnz) < 0.15
        ids = np.where(flip, np.where(rng.random(nnz) < 0.5,
                                      -rng.integers(1, 5, nnz),
                                      vocab + rng.integers(0, 5, nnz)), ids)
    values = np.full(cap, pad_id, np.int32)
    values[:min(nnz, cap)] = ids[:cap]
    weights = None
    if weighted:
        weights = np.zeros(cap, np.float32)
        weights[:min(nnz, cap)] = rng.uniform(0.25, 2.0, nnz)[:cap]
    rows = [list(ids[splits[r]:splits[r + 1]]) for r in range(b)]
    return values, splits, weights, rows


def _jax_ragged(values, splits, weights=None):
    return JRagged(values=jnp.asarray(values),
                      row_splits=jnp.asarray(splits),
                      weights=None if weights is None
                      else jnp.asarray(weights))


def _torch_ragged(values, splits, weights=None):
    return Ragged(values=torch.from_numpy(values),
                  row_splits=torch.from_numpy(splits),
                  weights=None if weights is None
                  else torch.from_numpy(weights))


# ------------------------------------------------- K10: CSR bookkeeping


@pytest.mark.parametrize("form", ["coo2", "rows"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_row_to_split_bit_exact(form, dtype):
    """COO rows (with empty rows and padding rows past ``dim_0``) ->
    CSR splits, as JAX's searchsorted gives them."""
    rng = np.random.default_rng(1)
    dim0 = 12
    counts = rng.integers(0, 4, size=dim0)
    counts[[0, 5, 11]] = 0
    rows = np.concatenate([np.repeat(np.arange(dim0), counts),
                           [dim0, dim0 + 2, dim0 + 2]]).astype(dtype)
    idx = (np.stack([rows, np.zeros_like(rows)], 1) if form == "coo2"
           else rows)
    want = np.asarray(jax_row_to_split(jnp.asarray(idx), dim0))
    got = row_to_split(torch.from_numpy(idx), dim0)
    assert got.dtype == (torch.int64 if dtype == np.int64 else torch.int32)
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(
        to_np(row_to_split(torch.from_numpy(idx), dim0,
                           dtype=torch.int64)), want)


@pytest.mark.parametrize("cap", [1, 9, 20, 40])
def test_ragged_row_ids_bit_exact(cap):
    """Positions -> rows, including rows past the capacity (their ends
    clip to it) and positions past the last row (they get ``nrows``);
    one CSR and a stack of three."""
    rng = np.random.default_rng(cap)
    lengths = rng.integers(0, 5, size=(3, 8)).astype(np.int32)
    lengths[1, 2:4] = 0
    splits = np.concatenate([np.zeros((3, 1), np.int32),
                             np.cumsum(lengths, 1, dtype=np.int32)], 1)
    for sp in (splits[0], splits):
        want = np.asarray(jax.vmap(lambda s: jax_ragged_row_ids(s, cap))(
            jnp.asarray(sp.reshape(-1, 9))).reshape(*sp.shape[:-1], cap))
        got = ragged_row_ids(torch.from_numpy(sp), cap)
        np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("cap", [6, 30])
def test_csr_seg_bit_exact(cap):
    """Per-slot lengths -> (splits, seg) of JAX's ``csr_seg``, over
    leading dims, from the port's ``lengths_to_splits`` and
    ``ragged_row_ids``."""
    rng = np.random.default_rng(7)
    lengths = rng.integers(0, 6, size=(2, 3, 5)).astype(np.int32)
    js, jseg = jax_lookup.csr_seg(jnp.asarray(lengths), cap)
    ts = lengths_to_splits(torch.from_numpy(lengths).reshape(6, 5))
    tseg = ragged_row_ids(ts, cap)
    np.testing.assert_array_equal(to_np(ts).reshape(2, 3, 6), np.asarray(js))
    np.testing.assert_array_equal(to_np(tseg).reshape(2, 3, cap),
                                  np.asarray(jseg))


@pytest.mark.parametrize("case", ["negative", "all_past", "empty",
                                  "single", "single_negative"])
@pytest.mark.parametrize("form", ["coo2", "rows"])
def test_row_to_split_edges_bit_exact(case, form):
    """The edges the card's boundary fill makes live, as JAX's
    searchsorted gives them: negative rows before row 0, every row past
    ``dim_0``, no entry, one entry (in range and negative)."""
    dim0 = 12
    rows = {"negative": [-4, -4, -1, 0, 0, 3, 11, 12, 12],
            "all_past": [12, 12, 15], "empty": [], "single": [5],
            "single_negative": [-2]}[case]
    rows = np.asarray(rows, np.int32)
    idx = (np.stack([rows, np.zeros_like(rows)], 1) if form == "coo2"
           else rows)
    want = np.asarray(jax_row_to_split(jnp.asarray(idx), dim0))
    got = row_to_split(torch.from_numpy(idx), dim0)
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(
        to_np(row_to_split(torch.from_numpy(idx).long(), dim0,
                           dtype=torch.int32)), want)


@pytest.mark.parametrize("b", [4097, 8191])
def test_csr_seg_past_one_scan_tile(b):
    """``csr_seg`` of slots longer than one 4,096-length scan tile and not
    a multiple of it, a dead slot among them: the port's
    ``lengths_to_splits`` (then ``ragged_row_ids``) equal JAX's."""
    rng = np.random.default_rng(b)
    lengths = rng.integers(0, 4, size=(3, b)).astype(np.int32)
    cap = int(lengths.sum(1).max()) - 5
    js, jseg = jax_lookup.csr_seg(jnp.asarray(lengths), cap)
    valid = torch.tensor([1, 0, 1], dtype=torch.int32)
    ts = lengths_to_splits(torch.from_numpy(lengths))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(ragged_row_ids(ts, cap)),
                                  np.asarray(jseg))
    dead = lengths.copy()
    dead[1] = 0
    jd, _ = jax_lookup.csr_seg(jnp.asarray(dead), cap)
    np.testing.assert_array_equal(
        to_np(lengths_to_splits(torch.from_numpy(lengths), valid)),
        np.asarray(jd))


# ----------------------------------------------------- K8: op level


def _lookup_bound(params, rows, weights_rows, combiner, dtype):
    """(k + 1) bf16 ulps of sum |w x| per row, k its id count."""
    p = np.asarray(params, np.float64)
    out = np.zeros((len(rows), p.shape[1]))
    ks = np.zeros((len(rows), 1))
    for r, ids in enumerate(rows):
        ids = np.clip(np.asarray(ids, np.int64), 0, p.shape[0] - 1)
        w = (np.ones(len(ids)) if weights_rows is None
             else np.asarray(weights_rows[r], np.float64))
        out[r] = (np.abs(p[ids]) * np.abs(w)[:, None]).sum(0)
        if combiner == "mean":
            out[r] /= max(len(ids), 1)
        ks[r] = len(ids) + 1
    return out, ks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["ragged", "sparse"])
def test_ragged_lookup_matches_jax(kind, combiner, weighted, dtype):
    """``embedding_lookup`` over ``Ragged`` / ``SparseIds``: empty rows,
    padding holding a valid id, negative and past-the-table ids (they
    clip), and (ragged) rows past the capacity."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng([kind == "sparse"])  # one case per kind
    vocab, b = 37, 24
    table = rng.normal(size=(vocab, 12)).astype(np.float32)
    if kind == "ragged":
        values, splits, wts, rows = _case(rng, b, vocab, 6, cap=60,
                                          weighted=weighted, pad_id=3)
        jids = _jax_ragged(values, splits, wts)
        tids = _torch_ragged(values, splits, wts)
        cap = 60
    else:
        values, splits, wts, rows = _case(rng, b, vocab, 6,
                                          weighted=weighted, pad_id=3)
        cap = len(values)
        nnz = int(splits[-1])
        coo = np.concatenate([np.repeat(np.arange(b), np.diff(splits)),
                              np.full(cap - nnz, b + 1)]).astype(np.int32)
        idx = np.stack([coo, np.zeros_like(coo)], 1)
        jids = JSparseIds(indices=jnp.asarray(idx),
                             values=jnp.asarray(values), dense_shape=(b, 6),
                             weights=None if wts is None
                             else jnp.asarray(wts))
        tids = SparseIds(indices=torch.from_numpy(idx),
                         values=torch.from_numpy(values), dense_shape=(b, 6),
                         weights=None if wts is None
                         else torch.from_numpy(wts))
    want = to_np(jax_embedding_lookup(jnp.asarray(table, jdt), jids,
                                      combiner=combiner))
    got = to_np(embedding_lookup(torch.from_numpy(table).to(tdt), tids,
                                 combiner=combiner))
    assert got.shape == want.shape == (b, 12)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        # the rows as the capacity truncates them
        live = []
        for r in range(b):
            lo, hi = min(splits[r], cap), min(splits[r + 1], cap)
            live.append(list(values[lo:hi]))
        wrows = None if wts is None else [
            list(wts[min(splits[r], cap):min(splits[r + 1], cap)])
            for r in range(b)]
        tb = to_np(torch.from_numpy(table).to(tdt))
        scale, ks = _lookup_bound(tb, live, wrows, combiner, dtype)
        tol = ks * 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126)))
                           - 7)
        assert (np.abs(got - want) <= tol).all(), \
            f"max err {np.abs(got - want).max()}"
    empty = np.diff(splits) == 0
    assert (got[empty] == 0).all()


def test_ragged_lookup_empty_rows_and_no_combiner():
    params = torch.ones((10, 4))
    r = Ragged(values=torch.tensor([1, 2], dtype=torch.int32),
               row_splits=torch.tensor([0, 0, 2, 2], dtype=torch.int32))
    np.testing.assert_array_equal(
        to_np(embedding_lookup(params, r, combiner="sum")),
        [[0] * 4, [2] * 4, [0] * 4])
    np.testing.assert_array_equal(
        to_np(embedding_lookup(params, r, combiner="mean")),
        [[0] * 4, [1] * 4, [0] * 4])
    with pytest.raises(ValueError, match="dense ids"):
        embedding_lookup(params, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("cap", [14, 40])
def test_combiner_grad_values_matches_jax(cap, combiner, dtype):
    """Per-position cotangent rows: bit-exact, including rows past the
    capacity, empty rows and the zero padding rows."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(cap)
    _, splits, _, _ = _case(rng, 9, 20, 5, cap=cap)
    g = rng.normal(size=(9, 8)).astype(np.float32)
    want = to_np(jax_cgv(jnp.asarray(g, jdt), jnp.asarray(splits), cap,
                         combiner))
    got = to_np(combiner_grad_values(torch.from_numpy(g).to(tdt),
                                     torch.from_numpy(splits), cap,
                                     combiner))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- DistributedEmbedding, world 1

CONFIGS = [
    {"input_dim": 37, "output_dim": 16, "combiner": "sum"},
    {"input_dim": 50, "output_dim": 16, "combiner": "mean"},
    {"input_dim": 29, "output_dim": 8, "combiner": "mean"},
    {"input_dim": 64, "output_dim": 16, "combiner": "sum"},
    {"input_dim": 23, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 41, "output_dim": 16, "combiner": "mean"},
]
# per input: "d" dense [b, 3], "r" ragged, "rw" weighted ragged
KINDS = ["r", "rw", "d", "r", "rw", "r"]
B = 16
CAP = 40


def _mixed_inputs(seed, comm=np.int32):
    """Numpy inputs for CONFIGS/KINDS: dense ids and CSR batches (the
    last rows of some past the capacity), with bad ids."""
    rng = np.random.default_rng(seed)
    out = []
    for c, k in zip(CONFIGS, KINDS):
        v = c["input_dim"]
        if k == "d":
            out.append(("d", rng.integers(-2, v + 2, size=(B, 3))
                        .astype(comm)))
        else:
            values, splits, wts, _ = _case(rng, B, v, 5, cap=CAP,
                                           weighted=k == "rw")
            out.append((k, values.astype(comm), splits.astype(comm), wts))
    return out


def _to_jax(inputs):
    return [jnp.asarray(e[1]) if e[0] == "d" else
            _jax_ragged(e[1], e[2], e[3]) for e in inputs]


def _to_torch(inputs):
    return [torch.from_numpy(e[1]) if e[0] == "d" else
            _torch_ragged(e[1], e[2], e[3]) for e in inputs]


@functools.lru_cache(maxsize=None)
def _jax_layers(dtype, masked, policy):
    """The JAX layer over CONFIGS, its weights, and its forward, jitted
    once and shared by the tests (every batch of ``_mixed_inputs`` has
    one shape). The forward returns ``(outs, residuals)``: the id block
    from the compiled program, the residuals' static metadata as the
    trace left it."""
    jdt, _ = DTYPES[dtype]
    jde = JaxDE(CONFIGS, world_size=1, compute_dtype=jdt,
                masked_reads=masked, invalid_id_policy=policy)
    rng = np.random.default_rng(1)
    tables = [rng.normal(size=(c["input_dim"], c["output_dim"]))
              .astype(np.float32) for c in CONFIGS]
    jp = jde.set_weights(tables, dtype=jdt)
    traced = {}

    def fwd(p, x):
        outs, res = jde.forward_with_residuals(p, x)
        traced["res"] = res
        return outs, res[1]

    jfwd = jax.jit(fwd)

    def forward(inputs):
        outs, ids = jfwd(jde.local_view(jp), _to_jax(inputs))
        res = traced["res"]
        return outs, (res[0], ids) + tuple(res[2:])

    return jde, jp, tables, forward


def _layers(dtype="float32", masked=False, policy="clamp"):
    """``(jde, jp, tde, tp, jax_forward)``: the shared JAX layer and a
    fresh port layer with the same weights."""
    jde, jp, tables, forward = _jax_layers(dtype, masked, policy)
    tdt = DTYPES[dtype][1]
    tde = DistributedEmbedding(CONFIGS, world_size=1, compute_dtype=tdt,
                               masked_reads=masked, invalid_id_policy=policy)
    return (jde, jp, tde, tde.set_weights(tables, dtype=tdt, device="cpu"),
            forward)


@pytest.mark.parametrize("reads", ["clip", "masked", "drop"])
@pytest.mark.parametrize("comm", [np.int32, np.int64])
def test_dist_forward_mixed_matches_jax(comm, reads):
    """Dense, ``"r"`` and ``"rw"`` inputs over sum and mean tables of two
    widths; int32 and int64 id blocks (JAX runs int32: without x64 it
    has no int64); bad ids clipped, or read as zero rows under
    ``masked_reads`` and ``invalid_id_policy="drop"``."""
    _, _, tde, tp, jfwd = _layers(
        masked=reads == "masked",
        policy="drop" if reads == "drop" else "clamp")
    inputs = _mixed_inputs(3)
    want, _ = jfwd(inputs)
    outs, res = tde.forward_with_residuals(
        tp, _to_torch(_mixed_inputs(3, comm)))
    assert res[1].dtype == (torch.int64 if comm == np.int64
                            else torch.int32)
    assert [e for e in res[2] if e[0] != "d"] == [
        ("r", CAP), ("rw", CAP), ("r", CAP), ("rw", CAP), ("r", CAP)]
    assert len(outs) == len(want)
    for i, (o, w) in enumerate(zip(outs, want)):
        assert tuple(o.shape) == tuple(w.shape) == (B, CONFIGS[i]
                                                    ["output_dim"])
        np.testing.assert_allclose(to_np(o), to_np(w), rtol=1e-6,
                                   atol=1e-6, err_msg=f"input {i}")


def test_dist_sparse_ids_equal_their_ragged_twins():
    """``SparseIds`` inputs give the same forward as their ``Ragged``
    twins, bitwise, and the same as JAX."""
    _, _, tde, tp, jfwd = _layers()
    inputs = _mixed_inputs(5)
    as_sparse = []
    for e in _to_torch(inputs):
        if isinstance(e, Ragged):
            sp = e.row_splits.numpy()
            cap = e.values.shape[0]
            coo = np.concatenate([np.repeat(np.arange(B), np.diff(sp)),
                                  np.full(max(cap - sp[-1], 0), B)])[:cap]
            e = SparseIds(indices=torch.from_numpy(
                np.stack([coo, np.zeros_like(coo)], 1).astype(np.int32)),
                values=e.values, dense_shape=(B, 5), weights=e.weights)
        as_sparse.append(e)
    twin = tde(tp, _to_torch(inputs))
    got = tde(tp, as_sparse)
    # the COO form cannot carry rows past the capacity: compare the rows
    # whose ids all fit
    for i, (a, t) in enumerate(zip(got, twin)):
        fits = np.ones(B, bool)
        if KINDS[i] != "d":
            fits = inputs[i][2][1:] <= CAP
        np.testing.assert_array_equal(to_np(a)[fits], to_np(t)[fits])
    want, _ = jfwd(inputs)
    for a, w in zip(twin, want):
        np.testing.assert_allclose(to_np(a), to_np(w), rtol=1e-6, atol=1e-6)


def test_ragged_input_needs_a_combiner():
    tde = DistributedEmbedding([{"input_dim": 9, "output_dim": 8,
                                 "combiner": None}], world_size=1)
    with pytest.raises(ValueError, match="combiner"):
        tde(tde.init(device="cpu"), [Ragged.from_lists([[1], [2, 3]])])


def test_ragged_decode_helpers_match_jax():
    """The id blocks of a mixed batch, and the port's in-place decode of
    their ragged regions (``region_views``, ``lengths_to_splits`` with
    dead slots, ``ragged_row_ids``, ``weight_floats``; an int64 block
    carries the same weights in its low 32 bits) against JAX's decode
    helpers (``ragged_decode``, ``region_weights``): bit-exact."""
    jde, _, tde, tp, jfwd = _layers()
    inputs = _mixed_inputs(21)
    _, jres = jfwd(inputs)
    _, tres = tde.forward_with_residuals(tp, _to_torch(inputs))
    np.testing.assert_array_equal(to_np(tres[1]), np.asarray(jres[1]))
    plan = tde._get_plan(list(tres[2]), B)
    kinds = set()
    for gi, g in enumerate(plan.groups):
        if g.kind == "d":
            continue
        kinds.add(g.kind)
        jreg = jres[1][:, g.goff:g.goff + g.n * g.blen]
        treg = tres[1][:, g.goff:g.goff + g.n * g.blen]
        rows, roff = plan.rows[gi][0], plan.roff[gi][0]
        valid = (np.arange(g.n) % 2 == 0).astype(np.int32)
        decode = jax.jit(lambda *a, g=g: jax_lookup.ragged_decode(
            jde, g, B, *a))  # integer arithmetic: jitted is exact
        jv, jlen, jseg, _, jcounts = (
            np.asarray(a)[0] for a in decode(jreg, jnp.asarray(rows),
                                              jnp.asarray(roff),
                                              jnp.asarray(valid)))
        values, lengths, wbits = t_lookup.region_views(g, B, treg)
        splits = lengths_to_splits(lengths, torch.from_numpy(valid))
        np.testing.assert_array_equal(to_np(values), jv)
        np.testing.assert_array_equal(np.diff(to_np(splits), axis=1), jlen)
        np.testing.assert_array_equal(
            np.maximum(np.diff(to_np(splits), axis=1), 1), jcounts)
        np.testing.assert_array_equal(to_np(ragged_row_ids(splits, g.hot)),
                                      jseg)
        if g.kind == "rw":
            want = np.asarray(jax_lookup.region_weights(jde, g, B, jreg))[0]
            for reg in (treg, treg.long()):
                wb = t_lookup.region_views(g, B, reg)[2]
                np.testing.assert_array_equal(
                    to_np(weight_floats(wb.contiguous())), want)
    assert kinds == {"r", "rw"}


def _streams(dtype, seed, invalid_slot=None, masked=False):
    jdt, tdt = DTYPES[dtype]
    jde, _, tde, tp, jfwd = _layers(dtype=dtype, masked=masked)
    inputs = _mixed_inputs(seed)
    _, jres = jfwd(inputs)
    _, tres = tde.forward_with_residuals(tp, _to_torch(inputs))
    key = (tuple(jres[2]), B)
    shared = jde._get_plan(list(jres[2]), B)
    if invalid_slot is not None:
        for de, res in ((jde, jres), (tde, tres)):
            plan = de._get_plan(list(res[2]), B)
            valid = [v.copy() for v in plan.valid]
            valid[invalid_slot[0]][0, invalid_slot[1]] = 0.0
            de._plan_cache[(tuple(res[2]), B)] = dataclasses.replace(
                plan, valid=tuple(valid))
    rng = np.random.default_rng(seed + 100)
    grads = [rng.normal(size=(B, c["output_dim"])).astype(np.float32)
             for c in CONFIGS]
    # the rounding after each op is the contract: compiled without XLA's
    # algebraic simplifier (it turns the division by ``hot`` into a
    # product by its reciprocal) and without excess precision, the
    # program rounds as JAX does op by op, in a fraction of the time
    streams = jax.jit(lambda ids, gs: jax_apply.cotangent_width_streams(
        jde, (jres[0], ids) + tuple(jres[2:]), gs))
    gs = [jnp.asarray(g, jdt) for g in grads]
    try:
        jw = streams.lower(jres[1], gs).compile(compiler_options={
            "xla_disable_hlo_passes": "algsimp",
            "xla_allow_excess_precision": False})(jres[1], gs)
    finally:
        jde._plan_cache[key] = shared
    tw = t_apply.cotangent_width_streams(
        tde, tres, [torch.from_numpy(g).to(tdt) for g in grads])
    return jde, tde, jw, tw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_cotangent_streams_match_jax(dtype):
    """The ragged groups' ``(ids, rows)`` streams: ids bit-exact (bad
    ids, padding and positions past the capacity at the sentinel), rows
    bit-exact (weights, then the mean division, rounded as JAX)."""
    jde, tde, jw, tw = _streams(dtype, 11)
    assert sorted(jw) == sorted(tw) == ["w16", "w8"]
    for k in jw:
        assert len(jw[k]) == len(tw[k])
        for (ji, jv, jwd), (ti, tv, twd) in zip(jw[k], tw[k]):
            assert jwd == twd and ti.dtype == torch.int32
            np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
            np.testing.assert_array_equal(to_np(tv), to_np(jv))
            assert (to_np(ti) == tde.rows_cap[twd]).any()


def test_ragged_streams_drop_dead_slots():
    """A padding slot (``valid`` 0) of a ragged group trains nothing:
    every position goes to the sentinel with a zero row, in both."""
    plan = DistributedEmbedding(CONFIGS, world_size=1)._get_plan(
        [("d", 3, 1) if k == "d" else (k, CAP) for k in KINDS], B)
    gi = next(i for i, g in enumerate(plan.groups)
              if g.kind == "r" and g.n >= 2)
    g = plan.groups[gi]
    k = sum(x.width == g.width for x in plan.groups[:gi])
    _, tde, jw, tw = _streams("float32", 13, invalid_slot=(gi, 1))
    for key in jw:
        for (ji, jv, _), (ti, tv, _) in zip(jw[key], tw[key]):
            np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
            np.testing.assert_array_equal(to_np(tv), to_np(jv))
    ids, vals, _ = tw[f"w{g.width}"][k]  # [world, n, cap]
    assert (to_np(ids)[:, 1] == tde.rows_cap[g.width]).all()
    assert (to_np(vals)[:, 1] == 0).all()
    assert (to_np(ids)[:, 0] != tde.rows_cap[g.width]).any()


def test_ragged_sparse_apply_matches_jax():
    jde, jp, tde, tp, jfwd = _layers(masked=True)
    inputs = _mixed_inputs(17)
    rng = np.random.default_rng(18)
    grads = [rng.normal(size=(B, c["output_dim"])).astype(np.float32)
             for c in CONFIGS]
    jlocal = jde.local_view(jp)
    _, jres = jfwd(inputs)
    jnew, _ = jax.jit(lambda p, ids, g: jde.sparse_apply_gradients(
        p, JaxSparseSGD().init(p), (jres[0], ids) + tuple(jres[2:]), g,
        JaxSparseSGD(), 0.05))(jlocal, jres[1],
                               [jnp.asarray(g) for g in grads])
    _, tres = tde.forward_with_residuals(tp, _to_torch(inputs))
    before = [t.copy() for t in tde.get_weights(tp)]
    tde.sparse_apply_gradients(tp, SparseSGD().init(tp), tres,
                               [torch.from_numpy(g) for g in grads],
                               SparseSGD(), 0.05)
    want = jde.get_weights(jde.stacked_view(jnew))
    got = tde.get_weights(tp)
    for t, (g, w, b0) in enumerate(zip(got, want, before)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg=f"table {t}")
        assert (g != b0).any()


def test_ragged_stream_through_forced_dedup(monkeypatch):
    """``DETPU_SGD_DEDUP=1`` runs the ragged stream through the dedup
    (K5) before the scatter: the same tables as the direct scatter
    within rtol 1e-6 (duplicates summed in another order)."""
    inputs = _to_torch(_mixed_inputs(19))
    rng = np.random.default_rng(20)
    grads = [torch.from_numpy(rng.normal(size=(B, c["output_dim"]))
                              .astype(np.float32)) for c in CONFIGS]
    got = []
    for env in ("0", "1"):
        monkeypatch.setenv("DETPU_SGD_DEDUP", env)
        _, _, tde, tp, _ = _layers()
        _, res = tde.forward_with_residuals(tp, inputs)
        tde.sparse_apply_gradients(tp, SparseSGD().init(tp), res, grads,
                                   SparseSGD(), 0.05)
        got.append(tde.get_weights(tp))
    for a, b in zip(*got):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ the train step

SIZES = [60, 7, 33, 120, 45]
NUM = 5
DIM = 16
LR = 0.05
TB = 32
TCAP = 5 * TB  # every row fits: hotness 1..5


def _dlrm_kw():
    return dict(table_sizes=SIZES, embedding_dim=DIM,
                num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
                top_mlp_dims=(32, 16, 1))


def _emb_opts(emb_opt):
    if emb_opt == "sgd":
        return JaxSparseSGD(), SparseSGD()
    # the sparse regime, forced in both
    return (JaxSparseAdagrad(dense_apply_ratio=None),
            SparseAdagrad(dense_apply_ratio=None))


@functools.lru_cache(maxsize=None)
def _jax_dlrm(compute, tables, emb_opt, nan_guard):
    """The JAX side of ``_dlrm``: layer, jitted train step (compiled once
    and shared by the tests) and the initial state as host arrays (the
    step donates its state, so each test builds its own from these)."""
    jcdt = DTYPES[compute][0]
    jpdt = DTYPES[tables][0]
    jcfg = JaxConfig(compute_dtype=jcdt, **_dlrm_kw())
    jconfigs = jcfg.embedding_configs(combiner="sum")
    jconfigs[1]["combiner"] = "mean"
    jde = JaxDE(jconfigs, world_size=1, compute_dtype=jcdt)
    rng = np.random.default_rng(0)
    jparams = jde.set_weights(
        [rng.uniform(-s ** -0.5, s ** -0.5, size=(s, DIM)).astype(np.float32)
         for s in SIZES], dtype=jpdt)
    jdense = JaxDense(jcfg)
    dp = jax.jit(jdense.init)(jax.random.key(1), jnp.zeros((2, NUM)),
                              [jnp.zeros((2, DIM))] * len(SIZES))
    tx = optax.sgd(LR)
    jopt = _emb_opts(emb_opt)[0]
    jstate = JaxState(jparams, jopt.init(jparams), dp, tx.init(dp),
                      jnp.zeros((), jnp.int32))
    host = jax.tree.map(np.asarray, jstate)
    weights = [np.asarray(t) for t in jde.get_weights(jparams)]

    def jloss(p, outs, batch):
        n, y = batch
        return jax_bce(jdense.apply(p, n, outs), y)

    jstep = jax_train_step(jde, jloss, tx, jopt, lr_schedule=LR,
                           with_metrics=False, nan_guard=nan_guard,
                           telemetry=False)
    return jde, jstep, host, weights


def _dlrm(compute, tables="float32", emb_opt="sgd", nan_guard=True):
    """Both packages' (layer, state, step) from one state: a toy DLRM
    whose categorical inputs are all ragged (table 1 a mean table,
    input 2 weighted)."""
    tcdt = DTYPES[compute][1]
    tpdt = DTYPES[tables][1]
    jde, jstep, host, weights = _jax_dlrm(compute, tables, emb_opt,
                                          nan_guard)
    jstate = jax.tree.map(jnp.asarray, host)
    tcfg = DLRMConfig(compute_dtype=tcdt, **_dlrm_kw())
    tconfigs = tcfg.embedding_configs(combiner="sum")
    tconfigs[1]["combiner"] = "mean"
    topt = _emb_opts(emb_opt)[1]
    tde = DistributedEmbedding(tconfigs, world_size=1, compute_dtype=tcdt)
    tstate = hybrid_state_from_jax(
        tde, DLRMDense(tcfg, device="cpu"), weights, host.dense_params,
        host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, dtype=tpdt, device="cpu",
        emb_optimizer=topt)

    def tloss(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    tstep = make_hybrid_train_step(tde, tloss, SGD(LR), topt,
                                   lr_schedule=LR, nan_guard=nan_guard)
    return (jde, jstate, jstep), (tde, tstate, tstep), topt, tloss


def _batches(n_steps, seed=3):
    """Ragged batches (hotness 1..5, ~15% bad ids, input 2 weighted) with
    one capacity, numerical features and labels, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        cats = []
        for t, s in enumerate(SIZES):
            v, sp, w, _ = _case(rng, TB, s, 5, cap=TCAP, weighted=t == 2,
                                min_hot=1)
            cats.append((v, sp, w))
        num = rng.normal(size=(TB, NUM)).astype(np.float32)
        lab = (rng.random(TB) < 0.3).astype(np.float32)
        out.append((cats, num, lab))
    return out


def _run(js, ts, batches):
    jde, jstate, jstep = js
    tde, tstate, tstep = ts
    jl, tl = [], []
    for cats, num, lab in batches:
        loss, jstate = jstep(jstate, [_jax_ragged(*c) for c in cats],
                             (jnp.asarray(num), jnp.asarray(lab)))
        jl.append(float(loss))
        loss, tstate = tstep(tstate, [_torch_ragged(*c) for c in cats],
                             (torch.from_numpy(num), torch.from_numpy(lab)))
        tl.append(float(loss))
    return np.array(jl), np.array(tl), jstate, tstate


def _compare_state(jde, jstate, tde, tstate, atol_tables, atol_dense):
    for i, (g, w) in enumerate(zip(tde.get_weights(tstate.emb_params),
                                   jde.get_weights(jstate.emb_params))):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=atol_tables, rtol=0,
                                   err_msg=f"table {i}")
    tree = jstate.dense_params["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    for name, lin in zip(names, tstate.dense_params.linears()):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(tree[name]["kernel"]).T,
                                   atol=atol_dense, rtol=0, err_msg=name)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(tree[name]["bias"]),
                                   atol=atol_dense, rtol=0, err_msg=name)
    assert int(tstate.step) == int(jstate.step)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_ragged_dlrm_trajectory_matches_jax(compute):
    """10 steps of the toy DLRM on ragged inputs, float32 tables."""
    js, ts, _, _ = _dlrm(compute)
    before = [t.copy() for t in ts[0].get_weights(ts[1].emb_params)]
    jl, tl, jstate, tstate = _run(js, ts, _batches(10))
    assert np.isfinite(tl).all()
    if compute == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        _compare_state(js[0], jstate, ts[0], tstate, 1e-5, 1e-5)
    else:
        np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)
        _compare_state(js[0], jstate, ts[0], tstate, 1e-3, 5e-3)
    after = ts[0].get_weights(tstate.emb_params)
    assert all((a != b).any() for a, b in zip(after, before))


def test_ragged_train_loop_equals_single_steps():
    """``make_hybrid_train_loop`` over stacked ``Ragged`` inputs (every
    field leads with K) gives the losses and state of K single steps,
    bitwise."""
    K = 3
    batches = _batches(K, seed=6)
    results = []
    for use_loop in (False, True):
        _, (tde, tstate, tstep), _, tloss = _dlrm("float32")
        if use_loop:
            loop = make_hybrid_train_loop(tde, tloss, SGD(LR), SparseSGD(),
                                          lr_schedule=LR, nan_guard=True)
            stacks = []
            for t in range(len(SIZES)):
                cs = [b[0][t] for b in batches]
                stacks.append(_torch_ragged(
                    np.stack([c[0] for c in cs]), np.stack([c[1] for c in cs]),
                    None if cs[0][2] is None
                    else np.stack([c[2] for c in cs])))
            losses, tstate = loop(
                tstate, stacks,
                (torch.from_numpy(np.stack([b[1] for b in batches])),
                 torch.from_numpy(np.stack([b[2] for b in batches]))))
        else:
            losses = []
            for cats, num, lab in batches:
                loss, tstate = tstep(
                    tstate, [_torch_ragged(*c) for c in cats],
                    (torch.from_numpy(num), torch.from_numpy(lab)))
                losses.append(loss)
            losses = torch.stack(losses)
        results.append((losses, tde.get_weights(tstate.emb_params),
                        [p.detach().clone()
                         for p in tstate.dense_params.parameters()]))
    (l0, t0, d0), (l1, t1, d1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(t0, t1):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)


def test_ragged_nan_batch_skips_update_bitwise():
    """A NaN numerical batch on ragged inputs: a non-finite loss, tables
    and dense params bitwise unchanged, ``step`` advanced."""
    js, ts, _, _ = _dlrm("float32")
    batches = _batches(2, seed=8)
    _, _, jstate, tstate = _run(js, ts, batches[:1])
    tables = [t.copy() for t in ts[0].get_weights(tstate.emb_params)]
    dense = [p.detach().clone() for p in tstate.dense_params.parameters()]
    cats, num, lab = batches[1]
    num = num.copy()
    num[3, 1] = np.nan
    jl, tl, jstate, tstate = _run(js[:1] + (jstate, js[2]),
                                  ts[:1] + (tstate, ts[2]),
                                  [(cats, num, lab)])
    assert not np.isfinite(tl).any() and not np.isfinite(jl).any()
    for a, b in zip(ts[0].get_weights(tstate.emb_params), tables):
        np.testing.assert_array_equal(a, b)
    for p, q in zip(tstate.dense_params.parameters(), dense):
        assert torch.equal(p, q)
    assert int(tstate.step) == int(jstate.step) == 2


def test_ragged_adagrad_sparse_regime_matches_jax():
    """3 ``SparseAdagrad`` steps (sparse regime: the ragged stream goes
    through the dedup, K5, and the row update, K6) on ragged inputs."""
    js, ts, topt, _ = _dlrm("float32", emb_opt="adagrad")
    assert not topt.dense_apply(ts[0].rows_cap[DIM], len(SIZES) * TCAP)
    jl, tl, jstate, tstate = _run(js, ts, _batches(3, seed=9))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _compare_state(js[0], jstate, ts[0], tstate, 1e-5, 1e-5)
    for k, acc in tstate.emb_opt_state.items():
        want = unpack_rows_np(to_np(jstate.emb_opt_state[k][0]),
                              acc.shape[-1])
        np.testing.assert_allclose(to_np(acc[0]), want, rtol=1e-5, atol=0,
                                   err_msg=f"accumulator {k}")
