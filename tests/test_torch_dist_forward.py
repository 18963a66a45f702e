"""The port's exchange layer and its world-8 forward against the JAX
package.

* K19/K20's plain versions (``ops/exchange_pack.py``, the copy plans of
  ``parallel/exchange.py``) against the JAX package's concatenation of
  cells (``exchange.assemble_cells``, kept in the port as the reference
  layout), bitwise, at world 1 and 8: dead cells, multi-slot (slot-major)
  instances, ragged ``"rw"`` blocks, int64 ids, float32 -> bfloat16
  casts, a rank that routes nothing; and the kernels' descriptors
  (addresses, units, modes) run by a byte-level emulation of the kernel.
* The world-8 forward: eight gloo ranks (``torch_dist_worker.py``, one
  group for the whole file) against the JAX layer on the 8-device CPU
  mesh, from the same tables and ids. Each rank's received id block
  (the residual) is bitwise JAX's block of that rank; one-hot outputs
  are bitwise; combined outputs (sum/mean over hotness > 1) are within
  float32 summation order (rtol 1e-6, atol 1e-7); the tables gathered
  back over the group are the tables given, bitwise, and each rank's
  slab is JAX's slab of that rank, bitwise.
"""

import functools

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

from distributed_embeddings_torch.ops import exchange_pack as xp
from distributed_embeddings_torch.ops.embedding_lookup import Ragged
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.parallel import exchange

from torch_dist_worker import RankGroup, join_unreachable

torch.set_num_threads(1)

WORLD = 8
LOCAL_B = 4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_forward"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


# ----------------------------------------------------------------- models


def random_model(rng, num_tables=12, shared=False):
    """Random table configs and input map (the JAX distributed tests'
    ``random_model``): widths 1-8, 4-99 rows, combiner None/sum/mean."""
    configs = [{"input_dim": int(rng.integers(4, 100)),
                "output_dim": int(rng.integers(1, 9)),
                "combiner": rng.choice([None, "sum", "mean"])}
               for _ in range(num_tables)]
    if not shared:
        return configs, list(range(num_tables))
    itm = list(rng.integers(0, num_tables, size=num_tables + 2))
    for t in range(num_tables):
        if t not in itm:
            itm[rng.integers(0, len(itm))] = t
    return configs, sorted(int(t) for t in itm)


def make_inputs(rng, configs, itm, batch, multihot_nocombiner=True):
    """Global ``[batch, hot]`` int32 ids: hot 1-4 on combiner tables
    (and on combiner-less ones with ``multihot_nocombiner``)."""
    out = []
    for t in itm:
        c = configs[t]
        hot = (int(rng.integers(1, 5))
               if c["combiner"] or multihot_nocombiner else 1)
        out.append(rng.integers(0, c["input_dim"], size=(batch, hot))
                   .astype(np.int32))
    return out


def ragged_inputs(rng, configs, itm, weighted):
    """Per-rank static-capacity CSR ids of every combiner table (the
    rest dense one-hot): ``("ragged", values, splits, weights)`` per
    input, each a list over ranks."""
    cap = LOCAL_B * 4
    out = []
    for t in itm:
        c = configs[t]
        if not c["combiner"]:
            out.append(rng.integers(0, c["input_dim"],
                                    size=(WORLD * LOCAL_B, 1))
                       .astype(np.int32))
            continue
        vals, splits, wts = [], [], []
        for _ in range(WORLD):
            lens = rng.integers(0, 5, size=LOCAL_B)
            n = int(lens.sum())
            v = np.zeros(cap, np.int32)
            v[:n] = rng.integers(0, c["input_dim"], size=n)
            vals.append(v)
            splits.append(np.concatenate([[0], np.cumsum(lens)])
                          .astype(np.int32))
            w = np.zeros(cap, np.float32)
            w[:n] = rng.uniform(0.5, 2.0, size=n)
            wts.append(w)
        out.append(("ragged", vals, splits, wts if weighted else None))
    return out


def tables_of(rng, configs):
    return [rng.normal(size=(c["input_dim"], c["output_dim"]))
            .astype(np.float32) for c in configs]


# ------------------------------------------------------------- JAX side


def _jax_inputs(inputs):
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


def jax_forward(spec):
    """JAX's world-8 forward: per-rank id blocks ``[world, world,
    l_max]``, global outputs, and per-rank logical slabs."""
    jde = JaxDE(spec["configs"], world_size=WORLD,
                strategy=spec.get("strategy", "basic"),
                column_slice_threshold=spec.get("column_slice_threshold"),
                input_table_map=spec.get("input_table_map"))
    params = jde.set_weights(spec["tables"], mesh=_mesh())
    inputs = _jax_inputs(spec["inputs"])

    def fwd(p, *inps):
        outs, res = jde.forward_with_residuals(p, list(inps))
        return tuple(outs), res[1]

    outs, ids = jax.jit(jax.shard_map(
        fwd, mesh=_mesh(), in_specs=(P("data"),) * (1 + len(inputs)),
        out_specs=(P("data"), P("data"))))(params, *inputs)
    slabs = {k: [unpack_rows_np(np.asarray(v[r]), int(k[1:]))
                 for r in range(WORLD)] for k, v in params.items()}
    return (np.asarray(ids).reshape(WORLD, WORLD, -1),
            [np.asarray(o) for o in outs], slabs, jde)


def check_forward(group, spec):
    group.submit("forward", spec)
    ids, outs, slabs, jde = jax_forward(spec)
    ranks = group.collect()
    one_hot = [not isinstance(x, tuple) and x.shape[1] == 1
               for x in spec["inputs"]]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ids"], ids[r],
                                      err_msg=f"rank {r} id block")
        for i, (o, want) in enumerate(zip(got["outs"], outs)):
            want = want[r * LOCAL_B:(r + 1) * LOCAL_B]
            assert o.shape == want.shape, (r, i, o.shape, want.shape)
            if one_hot[i]:
                np.testing.assert_array_equal(o, want,
                                              err_msg=f"rank {r} out {i}")
            else:
                np.testing.assert_allclose(o, want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"rank {r} out {i}")
        for k, s in got["slabs"].items():
            np.testing.assert_array_equal(s, slabs[k][r][:s.shape[0]],
                                          err_msg=f"rank {r} slab {k}")
    for a, b in zip(ranks[0]["tables"], spec["tables"]):
        np.testing.assert_array_equal(a, b)
    assert all(r["tables"] is None for r in ranks[1:])
    return ranks, jde


# ---------------------------------------------------- world-8 forward cases


@pytest.mark.parametrize("strategy", ["basic", "comm_balanced"])
@pytest.mark.parametrize("column_slice_threshold", [None, 150])
def test_world8_forward_matches_jax(group, strategy, column_slice_threshold):
    rng = np.random.default_rng(
        {"basic": 101, "comm_balanced": 404}[strategy])
    configs, itm = random_model(rng)
    spec = dict(configs=configs, strategy=strategy,
                column_slice_threshold=column_slice_threshold,
                input_table_map=itm, tables=tables_of(rng, configs),
                inputs=make_inputs(
                    rng, configs, itm, WORLD * LOCAL_B,
                    multihot_nocombiner=column_slice_threshold is None))
    _, jde = check_forward(group, spec)
    if column_slice_threshold is not None:
        assert jde.strategy.sliced_out_ranges, "column slicing engaged"


def test_world8_shared_table_inputs(group):
    rng = np.random.default_rng(11)
    configs, itm = random_model(rng, num_tables=10, shared=True)
    check_forward(group, dict(
        configs=configs, input_table_map=itm,
        tables=tables_of(rng, configs),
        inputs=make_inputs(rng, configs, itm, WORLD * LOCAL_B)))


def test_world8_rank_with_no_inputs(group):
    """Table 8's owner routes no input: its cells are all dead."""
    rng = np.random.default_rng(23)
    configs = [{"input_dim": 16, "output_dim": 4, "combiner": None}
               for _ in range(9)]
    itm = list(range(8))
    check_forward(group, dict(
        configs=configs, input_table_map=itm,
        tables=tables_of(rng, configs),
        inputs=make_inputs(rng, configs, itm, WORLD * LOCAL_B,
                           multihot_nocombiner=False)))


def test_world8_column_slice_dup_worker(group):
    """Aggressive slicing: every table split over several ranks (a rank
    may hold two slices of one table)."""
    rng = np.random.default_rng(17)
    configs = [{"input_dim": 64, "output_dim": 8, "combiner": None}
               for _ in range(8)]
    _, jde = check_forward(group, dict(
        configs=configs, column_slice_threshold=16,
        tables=tables_of(rng, configs),
        inputs=make_inputs(rng, configs, list(range(8)), WORLD * LOCAL_B,
                           multihot_nocombiner=False)))
    assert sum(map(len, jde.strategy.table_ids_list)) > 2 * len(configs)


def test_world8_ragged_weighted_forward(group):
    """Ragged features with per-id weights beside dense ones."""
    rng = np.random.default_rng(31)
    configs, itm = random_model(rng, num_tables=10)
    for c in configs[::2]:
        c["combiner"] = "sum" if c["combiner"] is None else c["combiner"]
    check_forward(group, dict(
        configs=configs, input_table_map=itm, strategy="comm_balanced",
        tables=tables_of(rng, configs),
        inputs=ragged_inputs(rng, configs, itm, weighted=True)))


# ------------------------------------------- K19/K20 against the reference


def _entries(de, inputs, device="cpu"):
    entries, encs, _, dt = de._normalize_inputs(
        [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
         for x in inputs], torch.device(device))
    b = entries[0][2].shape[0] if isinstance(entries[0], tuple) \
        else entries[0].shape[0]
    return entries, de._get_plan(encs, b), dt, b


def _pack_cases():
    """``(world, layer, inputs)``: multi-slot no-combiner inputs, dead
    cells, column slices, ragged "rw" inputs, a rank without inputs."""
    rng = np.random.default_rng(5)
    configs, itm = random_model(rng)
    yield (1, DistributedEmbedding(configs, 1, input_table_map=itm),
           make_inputs(rng, configs, itm, 6))
    yield (WORLD, DistributedEmbedding(configs, WORLD, input_table_map=itm,
                                       strategy="comm_balanced"),
           make_inputs(rng, configs, itm, 6))
    yield (WORLD, DistributedEmbedding(configs, WORLD, input_table_map=itm,
                                       column_slice_threshold=150),
           make_inputs(rng, configs, itm, 6, multihot_nocombiner=False))
    cfg9 = [{"input_dim": 16, "output_dim": 4, "combiner": None}] * 9
    yield (WORLD, DistributedEmbedding(cfg9, WORLD,
                                       input_table_map=list(range(8))),
           make_inputs(rng, cfg9, list(range(8)), 3, False))
    rcfg = [dict(c, combiner=c["combiner"] or "mean") for c in configs]
    for world in (1, WORLD):
        rin = []
        for t in itm:
            rows = [list(rng.integers(0, rcfg[t]["input_dim"],
                                      size=rng.integers(0, 4)))
                    for _ in range(5)]
            rin.append(Ragged.from_lists(
                rows, capacity=16,
                weights=[list(rng.uniform(0.5, 2, len(r))) for r in rows]))
        yield (world, DistributedEmbedding(rcfg, world, input_table_map=itm),
               rin)


PACK_CASES = list(_pack_cases())


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_k19_plain_matches_assembled_cells(case, ids_dtype):
    world, de, inputs = PACK_CASES[case]
    inputs = [x.astype(ids_dtype) if isinstance(x, np.ndarray) else
              Ragged(values=x.values.to(torch.from_numpy(
                  np.zeros(0, ids_dtype)).dtype),
                     row_splits=x.row_splits, weights=x.weights)
              for x in inputs]
    entries, plan, dt, _ = _entries(de, inputs)
    assert dt == (torch.int64 if ids_dtype == np.int64 else torch.int32)
    got = exchange.build_send_blocks(de, plan, entries, dt, "cpu")
    want = exchange.build_send_blocks_plain(de, plan, entries, dt, "cpu")
    assert got.shape == (world, plan.l_max) and got.dtype == dt
    assert torch.equal(got, want)


def _column_slices(rng, b, widths, dtype):
    """Cotangents as column slices of one wider tensor (what autograd
    gives for the outputs the interaction stacks)."""
    wide = torch.from_numpy(rng.normal(size=(b, sum(widths) + 3))
                            .astype(np.float32)).to(dtype)
    pos = np.concatenate([[1], 1 + np.cumsum(widths)])
    return [wide[:, p:p + w] for p, w in zip(pos, widths)]


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_k20_grad_pack_matches_assembled_cells(case, dtype, strided):
    """The cotangent pack, column slices inverted in the same launch;
    cotangents that are column slices of a wider tensor read in place."""
    _, de, inputs = PACK_CASES[case]
    _, plan, _, b = _entries(de, inputs)
    _, widths = exchange.slice_map(de, plan)
    rng = np.random.default_rng(case)
    grads = (_column_slices(rng, b, widths, dtype) if strided else
             [torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32))
              .to(dtype) for w in widths])
    got = exchange.pack_grad_blocks(de, plan, grads, b, dtype)
    want = exchange.pack_grad_blocks_plain(de, plan, grads, b, dtype)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not match its output"):
        exchange.pack_grad_blocks(de, plan, [g[:, :0] for g in grads], b,
                                  dtype)


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.float32)])
def test_k20_lookup_rows_and_unpack_match_jax_layout(case, dtypes):
    """The lookup rows (casting) and the dp-side unpack against the JAX
    package's transposes, concatenates and slices, for every rank."""
    world, de, inputs = PACK_CASES[case]
    _, plan, _, b = _entries(de, inputs)
    src_dt, dst_dt = dtypes
    rng = np.random.default_rng(case + 7)
    reds = [torch.from_numpy(rng.normal(size=(world * g.n, b, g.width))
                             .astype(np.float32)).to(src_dt)
            for g in plan.groups]
    for r in range(world):
        de._rank = r
        got = exchange.pack_lookup_rows(de, plan, reds, dst_dt, "cpu")
        # JAX plan_lookup: [world, n, b, w] -> [world, b, n * w], concat
        secs = []
        for gi, g in enumerate(plan.groups):
            red = reds[gi].reshape(world, g.n, b, g.width).clone()
            red[:, plan.valid[gi][r] == 0] = 0  # this rank's dead slots
            secs.append(red.transpose(1, 2).reshape(world, b, -1))
        assert torch.equal(got, torch.cat(secs, dim=2).to(dst_dt))
    # the unpack: JAX's static slices in worker order, then the input-
    # order permutation and the concatenation of column slices
    dp_recv = torch.from_numpy(rng.normal(size=(world, b, plan.s_max))
                               .astype(np.float32)).to(dst_dt)
    outs = exchange.unpack_outputs(de, plan, dp_recv)
    worker = []
    for inst in plan.instances:
        g = plan.groups[inst.group]
        c0 = g.col + inst.slot0 * g.width
        worker.append(dp_recv[inst.rank, :, c0:c0 + plan.out_width(inst)])
    result = [worker[i] for i in de.strategy.rev_global_input_ids]
    for start, end in sorted(de.strategy.sliced_out_ranges):
        result[start:end] = [torch.cat(result[start:end], dim=-1)]
    assert len(outs) == len(result)
    for o, w in zip(outs, result):
        assert o.is_contiguous() and torch.equal(o, w)


# ------------------------------------------- the kernels' descriptors


def _emulate(desc, tensors):
    """Run kernel descriptors on the tensors' bytes, as the kernel does:
    per descriptor ``rows x cols`` units of its mode's size, raw units
    copied, cast units converted (float32 -> bfloat16 round to nearest
    even, bfloat16 -> float32 exact), a null source zero-filled."""
    stores = [t.untyped_storage() for t in tensors]
    spans = [(st.data_ptr(), st.nbytes(),
              torch.empty(0, dtype=torch.uint8).set_(st).numpy())
             for st in stores]

    def at(addr, nbytes):
        for base, n, arr in spans:
            if base <= addr and addr + nbytes <= base + n:
                return arr[addr - base:addr - base + nbytes]
        raise AssertionError(f"address {addr:#x} outside every tensor")

    for src, dst, ss, ds, rows, cols, _, mode in desc.tolist():
        if mode <= 3:
            su = du = 2 << mode
            per = None
        elif mode <= 6:
            per = 1 << (mode - 4)
            su, du = 4 * per, 2 * per
        else:
            per = 1 << (mode - 7)
            su, du = 2 * per, 4 * per
        for r in range(rows):
            d = at(dst + r * ds * du, cols * du)
            if src == 0:
                d[:] = 0
                continue
            s = at(src + r * ss * su, cols * su)
            if per is None:
                d[:] = s
            elif mode <= 6:
                d[:] = torch.from_numpy(s.copy().view(np.float32)).to(
                    torch.bfloat16).view(torch.uint8).numpy()
            else:
                d[:] = torch.from_numpy(s.copy()).view(torch.bfloat16).to(
                    torch.float32).view(torch.uint8).numpy()


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
def test_descriptors_emulated_match_plain(case):
    """The descriptors the card would get (addresses patched from the
    tensors, widest units, cast modes), run byte by byte, give the plain
    copy's bits: the id blocks, the cotangent pack (bf16), the lookup
    rows with a float32 -> bfloat16 cast, and the unpack."""
    world, de, inputs = PACK_CASES[case]
    de._rank = 0 if world == 1 else 3
    entries, plan, dt, b = _entries(de, inputs)
    # the id blocks
    cplan = exchange._ids_copy_plan(de, plan, entries)
    srcs = [t.contiguous() for e in entries
            for t in (e[1:] if isinstance(e, tuple) else (e,))]
    want = torch.empty((world, plan.l_max), dtype=dt)
    xp.batched_copy_plain(cplan, srcs, [want])
    got = torch.full_like(want, -7)
    _emulate(xp.descriptors(cplan, srcs, [got], dt, dt), srcs + [got])
    assert torch.equal(got, want)
    # the cotangent pack, the lookup rows (cast) and the unpack
    _, widths = exchange.slice_map(de, plan)
    rng = np.random.default_rng(case)
    grads = _column_slices(rng, b, widths, torch.bfloat16)
    reds = [torch.from_numpy(rng.normal(size=(world * g.n * b * g.width))
                             .astype(np.float32)) for g in plan.groups]
    dp = torch.from_numpy(rng.normal(size=(world, b, plan.s_max))
                          .astype(np.float32))
    cases = [(exchange._grad_copy_plan(de, plan, b), grads,
              torch.bfloat16, (world, b, plan.s_max)),
             (exchange.lookup_copy_plan(de, plan), reds, torch.bfloat16,
              (world, b, plan.s_max)),
             (exchange._unpack_copy_plan(de, plan)[0], [dp], torch.float32,
              (sum(b * w for w in widths),))]
    for cp, srcs, ddt, shape in cases:
        want = torch.empty(shape, dtype=ddt)
        xp.batched_copy_plain(cp, srcs, [want])
        got = torch.full(shape, 3.0, dtype=ddt)
        _emulate(xp.descriptors(cp, srcs, [got], srcs[0].dtype, ddt),
                 list(srcs) + [got])
        assert torch.equal(got, want)


def test_descriptor_units_follow_alignment():
    """A 16-byte-aligned row of 8 bf16 moves as one 16-byte unit; an odd
    offset falls back to 2-byte units; a float32 -> bfloat16 cast of 4
    aligned floats is one 4-element unit."""
    src = torch.zeros(64, dtype=torch.bfloat16)
    dst = torch.zeros(64, dtype=torch.bfloat16)
    d = xp.descriptors(xp.CopyPlan([(0, 0, 8, 0, 0, 8, 2, 8),
                                    (0, 1, 8, 0, 17, 8, 2, 8)]),
                       [src], [dst], torch.bfloat16, torch.bfloat16)
    assert d[0, 7] == 3 and d[0, 5] == 1 and d[0, 2] == 1
    assert d[1, 7] == 0 and d[1, 5] == 8
    f = torch.zeros(64, dtype=torch.float32)
    d = xp.descriptors(xp.CopyPlan([(0, 0, 4, 0, 0, 4, 3, 4),
                                    (-1, 0, 0, 0, 16, 8, 1, 8)]),
                       [f], [dst], torch.float32, torch.bfloat16)
    assert d[0, 7] == 6 and d[0, 5] == 1
    assert d[1, 0] == 0 and d[1, 7] == 3  # zero fill: raw 16-byte units


def test_world8_paths_not_ported_raise():
    """What of world > 1 waits (ROADMAP A7b) raises, naming it: the
    serving runtime (the serving mesh). The checkpoints and the streaming
    state's codec are collectives at world > 1: outside a process group
    they raise for the missing group, not for a missing port
    (``tests/test_torch_world_checkpoint.py`` runs them in one). The
    instrumented, telemetry and streaming steps build at world 8 with
    the arity of world 1; a world-8 layer outside a process group plans
    but cannot run. The streaming forms are ``True``, ``False`` and the
    pipelined step's ``"serve"``; any other raises."""
    import inspect

    from distributed_embeddings_torch.parallel import (
        SGD, ServingRuntime, SparseSGD, make_hybrid_eval_step,
        make_hybrid_train_loop, make_hybrid_train_step, streaming)
    from distributed_embeddings_torch.utils.checkpoint import (
        restore_train_state, save_train_state)

    configs = [{"input_dim": 16, "output_dim": 4, "combiner": None}] * 8
    de = DistributedEmbedding(configs, WORLD)
    assert len(de._get_plan([("d", 1, 1)] * 8, 2).instances) == 8
    with pytest.raises(RuntimeError, match="process group"):
        de.rank
    # model-parallel input is ported: a plain id list to such a layer
    # raises, naming the MpInputs batch it takes
    mp = DistributedEmbedding(configs, WORLD, dp_input=False)
    with pytest.raises(ValueError, match="MpInputs"):
        mp.forward_with_residuals({"w4": torch.zeros((1, 8, 4))},
                                  [torch.zeros((2, 1), dtype=torch.int32)]
                                  * 8)
    args = (de, lambda *a: None, SGD(0.1), SparseSGD())
    base = ["state", "cat_inputs", "batch"]
    for kw, aux in ((dict(telemetry=True), ["telem"]),
                    (dict(dynamic=True), ["stream"]),
                    (dict(telemetry=True, dynamic=True, with_metrics=True),
                     ["telem", "stream"]),
                    (dict(with_metrics=True), [])):
        step = make_hybrid_train_step(*args, **kw)
        assert list(inspect.signature(step).parameters) == base + aux, kw
        assert callable(make_hybrid_train_loop(*args, **kw))
    ev = make_hybrid_eval_step(de, lambda *a: None, dynamic=True)
    assert list(inspect.signature(ev).parameters) == base + ["stream"]
    with pytest.raises(NotImplementedError, match="A7b"):
        ServingRuntime(de, lambda *a: None, None)
    for fn in (lambda: save_train_state("/nonexistent", de, None),
               lambda: restore_train_state("/nonexistent", de, SparseSGD(),
                                           None, None, device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            fn()
    sde = DistributedEmbedding(configs[:7] + [
        {"input_dim": 20, "output_dim": 4,
         "streaming": {"capacity": 16, "buckets": 4}}], WORLD)
    with pytest.raises(ValueError, match="'serve'"):
        sde._streaming_remap(None, None, (None, None, "stage"))
    for fn in (lambda: streaming.encode_state(sde, {}),
               lambda: streaming.decode_state(sde, {}, {})):
        with pytest.raises(RuntimeError, match="process group"):
            fn()


def test_bootstrap_join_gives_up_and_backends_are_explicit(tmp_path):
    """A join whose peers never come raises ``CoordinatorUnreachable``
    after its retries (in a child process: the group is global); an
    unknown backend raises at once, with no fallback."""
    import torch.multiprocessing as mp

    from distributed_embeddings_torch.parallel import bootstrap

    with pytest.raises(ValueError, match="nccl' or 'gloo"):
        bootstrap.initialize("mpi", "file:///nowhere", 2, 0)
    assert bootstrap.process_count() == 1 and bootstrap.process_index() == 0
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=join_unreachable,
                    args=(str(tmp_path / "store"), q))
    p.start()
    try:
        assert q.get(timeout=120) == "CoordinatorUnreachable"
    finally:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()

