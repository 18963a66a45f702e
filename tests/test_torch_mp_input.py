"""Model-parallel input (``dp_input=False``, ``MpInputs``) in the port
against the JAX package.

* ``pack_mp_inputs``: the packed blocks equal JAX's
  ``pack_mp_inputs(as_numpy=True)`` bit for bit (dense one-hot,
  multi-hot with and without a combiner, ragged and weighted ragged;
  ``hots`` given and inferred; ``None`` entries; ``comm_balanced`` and
  ``memory_balanced``, with and without column and row slicing; int32
  and int64), ``rank=`` packs that rank's block alone, a shard past its
  ragged capacity raises, and ``DummyDataset(dp_input=False)`` gives the
  global batch it packs. A plain id list to a ``dp_input=False`` layer,
  an ``MpInputs`` at world 1 and one to a data-parallel layer raise.
* World 8 (eight gloo ranks, ``torch_dist_worker.py``, one group for the
  file): the model-parallel forward and ``SparseSGD`` steps (row-sliced
  tables, ragged and weighted features) equal the data-parallel ones on
  the same global batch bit for bit (both see the same received id
  block), and JAX's model-parallel forward and steps on the 8-device CPU
  mesh: the received blocks bitwise, one-hot outputs bitwise, sums within
  rtol 1e-6 atol 1e-7, losses within 1e-5 and tables rtol 1e-5 atol
  1e-6. The DLRM hybrid step (``make_hybrid_train_step``, guard on, a
  NaN batch, eval) with ``MpInputs`` equals the data-parallel step bit
  for bit, and ``make_hybrid_train_loop`` over stacked ``MpInputs``
  equals the steps. Control: a data-parallel batch with its rows rolled
  by one rank is packed, and fails the bitwise equality.
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
from distributed_embeddings_tpu.parallel import DistributedEmbedding as JaxDE
from distributed_embeddings_tpu.parallel.dist_embedding import (
    MpInputs as JaxMpInputs)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)

from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
from distributed_embeddings_torch.ops.embedding_lookup import Ragged
from distributed_embeddings_torch.parallel import (DistributedEmbedding,
                                                   MpInputs)
from distributed_embeddings_torch.utils.convert import flax_dense_tree
from distributed_embeddings_torch.utils.data import DummyDataset

from torch_dist_worker import RankGroup, global_inputs

torch.set_num_threads(1)

WORLD = 8
LOCAL_B = 4
B = WORLD * LOCAL_B
LR = 0.05


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_mp_input"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


# ------------------------------------------------------- pack_mp_inputs


CONFIGS = [
    {"input_dim": 100, "output_dim": 8, "combiner": None},
    {"input_dim": 100, "output_dim": 8, "combiner": "mean"},
    {"input_dim": 100, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 60, "output_dim": 4, "combiner": "sum"},
    {"input_dim": 40, "output_dim": 8, "combiner": None},
    {"input_dim": 30, "output_dim": 8, "combiner": "sum"},
    {"input_dim": 22, "output_dim": 8, "combiner": None},
    {"input_dim": 26, "output_dim": 4, "combiner": "mean"},
    {"input_dim": 70, "output_dim": 8, "combiner": None},
]
#: per input: dense ``[B, h]`` (h), or "r"/"rw" ragged
KINDS = [1, 3, "r", "rw", 2, 2, 1, 1, 1]


def _global_ragged(rng, dim, weighted, cap):
    """A global-batch CSR (0-4 ids a row) at capacity ``cap``."""
    lens = rng.integers(0, 5, size=B)
    splits = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(splits[-1])
    v = np.zeros(cap, np.int32)
    v[:n] = rng.integers(-1, dim + 1, size=n)
    w = np.zeros(cap, np.float32)
    w[:n] = rng.uniform(0.5, 2, size=n)
    return v, splits, (w if weighted else None)


def _pack_inputs(rng, dtype=np.int32):
    """Per input: a global dense array, or ``(values, splits, weights)``
    of a global CSR."""
    out = []
    for c, kind in zip(CONFIGS, KINDS):
        if isinstance(kind, int):
            out.append(rng.integers(0, c["input_dim"], size=(B, kind))
                       .astype(dtype))
        else:
            v, s, w = _global_ragged(rng, c["input_dim"], kind == "rw", 4 * B)
            out.append((v.astype(dtype), s.astype(dtype), w))
    return out


def _as(x, cls, arr):
    if isinstance(x, tuple):
        v, s, w = x
        return cls(values=arr(v), row_splits=arr(s),
                   weights=None if w is None else arr(w))
    return x


@pytest.mark.parametrize("strategy", ["comm_balanced", "memory_balanced"])
@pytest.mark.parametrize("cst,rs", [(None, None), (None, 300), (500, 300)])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pack_mp_inputs_matches_jax(strategy, cst, rs, given, dtype):
    rng = np.random.default_rng(len(strategy) + (rs or 0) + given)
    inputs = _pack_inputs(rng, dtype)
    kw = dict(strategy=strategy, column_slice_threshold=cst, row_slice=rs,
              dp_input=False)
    t, j = DistributedEmbedding(CONFIGS, WORLD, **kw), JaxDE(CONFIGS, WORLD,
                                                             **kw)
    assert bool(t.strategy.row_sliced_tables) == (rs is not None)
    hots = None
    if given:  # a tighter ragged capacity, as a multi-host feed gives
        hots = [k if isinstance(k, int) else (k, 2 * B // WORLD + 8)
                for k in KINDS]
    jp = j.pack_mp_inputs([_as(x, JaxRagged, np.asarray) for x in inputs],
                          hots=hots, as_numpy=True)
    tp = t.pack_mp_inputs([_as(x, Ragged, torch.from_numpy)
                           for x in inputs], hots=hots, as_numpy=True)
    assert tp.hots == jp.hots and tp.local_batch == jp.local_batch
    assert tp.packed.dtype == np.asarray(jp.packed).dtype
    np.testing.assert_array_equal(tp.packed, np.asarray(jp.packed))
    t._rank = 5  # a rank's block alone, as a tensor
    one = t.pack_mp_inputs([_as(x, Ragged, torch.from_numpy)
                            for x in inputs], hots=hots, device="cpu")
    assert isinstance(one, MpInputs)
    np.testing.assert_array_equal(one.packed.numpy(), tp.packed[5])


def test_pack_mp_inputs_none_entries_match_jax():
    """Features held elsewhere (``None``) leave their blocks zero; the
    layout comes from ``hots`` and ``local_batch``."""
    rng = np.random.default_rng(7)
    inputs = _pack_inputs(rng)
    hots = [k if isinstance(k, int) else (k, 4 * B) for k in KINDS]
    kw = dict(strategy="comm_balanced", row_slice=300, dp_input=False)
    t, j = DistributedEmbedding(CONFIGS, WORLD, **kw), JaxDE(CONFIGS, WORLD,
                                                             **kw)
    for keep in ([0, 2, 5], []):
        tin = [_as(x, Ragged, torch.from_numpy) if i in keep else None
               for i, x in enumerate(inputs)]
        jin = [_as(x, JaxRagged, np.asarray) if i in keep else None
               for i, x in enumerate(inputs)]
        jp = j.pack_mp_inputs(jin, hots=hots, local_batch=LOCAL_B,
                              as_numpy=True)
        tp = t.pack_mp_inputs(tin, hots=hots, local_batch=LOCAL_B,
                              as_numpy=True)
        np.testing.assert_array_equal(tp.packed, np.asarray(jp.packed))
    with pytest.raises(ValueError, match="hots="):
        t.pack_mp_inputs([None] * len(CONFIGS), as_numpy=True)


def test_pack_mp_inputs_capacity_overflow_raises():
    rng = np.random.default_rng(3)
    inputs = _pack_inputs(rng)
    v, s, w = inputs[2]
    s = s.copy()
    s[1:] = np.arange(1, B + 1) * 3  # 12 ids a shard past a capacity of 8
    v = np.arange(4 * B, dtype=np.int32) % 90
    inputs[2] = (v, s, w)
    hots = [k if isinstance(k, int) else (k, 8) for k in KINDS]
    t = DistributedEmbedding(CONFIGS, WORLD, dp_input=False)
    j = JaxDE(CONFIGS, WORLD, dp_input=False)
    for de, cls, arr in ((t, Ragged, torch.from_numpy),
                         (j, JaxRagged, np.asarray)):
        with pytest.raises(ValueError, match="exceeds per-shard capacity"):
            de.pack_mp_inputs([_as(x, cls, arr) for x in inputs], hots=hots,
                              as_numpy=True)


def test_dummy_dataset_mp_batch_packs():
    ds = DummyDataset(B, 4, [c["input_dim"] for c in CONFIGS], 2,
                      hotness=[1] * len(CONFIGS), num_workers=WORLD,
                      dp_input=False)
    num, cats, lab = ds[0]
    assert num.shape == (LOCAL_B, 4) and lab.shape == (LOCAL_B, 1)
    assert all(c.shape == (B, 1) for c in cats)
    de = DistributedEmbedding(CONFIGS, WORLD, dp_input=False)
    mp = de.pack_mp_inputs(cats, as_numpy=True)
    assert mp.local_batch == LOCAL_B and mp.packed.shape[:2] == (WORLD,
                                                                 WORLD)
    dp = DummyDataset(B, 4, [c["input_dim"] for c in CONFIGS], 2,
                      num_workers=WORLD)
    assert all(c.shape == (LOCAL_B, 1) for c in dp[0][1])


def test_input_kind_mismatches_raise():
    ids = [torch.zeros((LOCAL_B, 1), dtype=torch.int32)] * len(CONFIGS)
    de = DistributedEmbedding(CONFIGS, WORLD, dp_input=False)
    de._rank = 0
    params = {f"w{w}": torch.zeros((1, de.rows_cap[w], w))
              for w in de.widths}
    with pytest.raises(ValueError, match="requires an MpInputs batch"):
        de.forward_with_residuals(params, ids)
    one = DistributedEmbedding(CONFIGS, 1)
    mp = MpInputs(packed=np.zeros((1, 1, 4), np.int32), hots=(1,) * 9,
                  local_batch=4)
    with pytest.raises(ValueError, match="plain input list"):
        one.forward_with_residuals(one.init(device="cpu"), mp)
    dp = DistributedEmbedding(CONFIGS, WORLD)
    dp._rank = 0
    with pytest.raises(ValueError, match="dp_input=False"):
        dp.forward_with_residuals(params, mp)
    bad = de.pack_mp_inputs([np.zeros((B, 1), np.int32)] * len(CONFIGS),
                            as_numpy=True)
    bad.packed = bad.packed[:, :, :-1]
    with pytest.raises(ValueError, match="does not match the plan"):
        de.forward_with_residuals(params, bad)


# ------------------------------------------------------------- world 8


def _dp_inputs(rng):
    """Global dense ids and per-rank CSRs (``("ragged", values, splits,
    weights)``), the worker's data-parallel form."""
    cap = LOCAL_B * 4
    out = []
    for c, kind in zip(CONFIGS, KINDS):
        if isinstance(kind, int):
            out.append(rng.integers(-1, c["input_dim"] + 1, size=(B, kind))
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
            wts.append(np.where(np.arange(cap) < n,
                                rng.uniform(0.5, 2, cap), 0)
                       .astype(np.float32))
        out.append(("ragged", vals, splits, wts if kind == "rw" else None))
    return out


ROW_THR = 100 * 8 // 4 + 1
LAYER = dict(configs=CONFIGS, strategy="comm_balanced", row_slice=ROW_THR)


def _fwd_spec(seed, **kw):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(c["input_dim"], c["output_dim"]))
              .astype(np.float32) for c in CONFIGS]
    return dict(LAYER, tables=tables, inputs=_dp_inputs(rng), **kw)


def _jax_mp(spec, steps=None):
    """JAX's world-8 model-parallel forward (``steps`` None) or
    ``SparseSGD`` steps from the spec's tables: per-rank blocks and
    outputs, or per-rank losses and the tables."""
    jde = JaxDE(spec["configs"], world_size=WORLD,
                strategy=spec["strategy"], row_slice=spec["row_slice"],
                dp_input=False)
    params = jde.set_weights(spec["tables"], mesh=_mesh())
    packs = []
    for inputs in ([spec["inputs"]] if steps is None else steps):
        ins, hots = global_inputs(inputs, WORLD)
        packs.append(jde.pack_mp_inputs(
            [JaxRagged(values=np.asarray(x.values),
                       row_splits=np.asarray(x.row_splits),
                       weights=None if x.weights is None
                       else np.asarray(x.weights))
             if isinstance(x, Ragged) else x for x in ins],
            hots=hots, mesh=_mesh()))
    hots, b = packs[0].hots, packs[0].local_batch
    if steps is None:
        def fwd(p, packed):
            mp = JaxMpInputs(packed=packed, hots=hots, local_batch=b)
            outs, res = jde.forward_with_residuals(p, mp)
            return tuple(outs), res[1]

        outs, ids = jax.jit(jax.shard_map(
            fwd, mesh=_mesh(), in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data"))))(params, packs[0].packed)
        return (np.asarray(ids).reshape(WORLD, WORLD, -1),
                [np.asarray(o) for o in outs])
    opt = JaxSparseSGD()
    ost = opt.init(params)

    def step(p, o, packed):
        local, lo = jde.local_view(p), jde.local_view(o)
        mp = JaxMpInputs(packed=packed, hots=hots, local_batch=b)
        outs, res = jde.forward_with_residuals(local, mp)
        loss, g = jax.value_and_grad(lambda os: sum(
            jnp.mean(x.astype(jnp.float32) ** 2) for x in os))(outs)
        new, no = jde.sparse_apply_gradients(local, lo, res, g, opt, LR)
        return jde.stacked_view(new), jde.stacked_view(no), loss[None]

    fn = jax.jit(jax.shard_map(step, mesh=_mesh(),
                               in_specs=(P("data"),) * 3,
                               out_specs=(P("data"),) * 3))
    losses = []
    for pk in packs:
        params, ost, loss = fn(params, ost, pk.packed)
        losses.append(np.asarray(loss))
    return np.stack(losses, axis=1), jde.get_weights(params)


def test_world8_mp_forward_matches_dp_and_jax(group):
    spec = _fwd_spec(41)
    mp = group.run("forward", dict(spec, dp_input=False))
    group.submit("forward", spec)
    ids, outs = _jax_mp(spec)
    dp = group.collect()
    for r in range(WORLD):
        np.testing.assert_array_equal(mp[r]["ids"], dp[r]["ids"])
        np.testing.assert_array_equal(mp[r]["ids"], ids[r])
        for i, (a, b) in enumerate(zip(mp[r]["outs"], dp[r]["outs"])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} out {i}")
            want = outs[i][r * LOCAL_B:(r + 1) * LOCAL_B]
            if KINDS[i] == 1:
                np.testing.assert_array_equal(a, want)
            else:
                np.testing.assert_allclose(a, want, rtol=1e-6, atol=1e-7)


def _train_spec(seed):
    rng = np.random.default_rng(seed)
    spec = _fwd_spec(seed)
    spec.pop("inputs")
    return dict(spec, steps=[_dp_inputs(rng) for _ in range(2)],
                optimizer="sgd", lr=LR)


def test_world8_mp_sgd_steps_match_dp_and_jax(group):
    spec = _train_spec(43)
    mp = group.run("train", dict(spec, dp_input=False))
    group.submit("train", spec)
    jlosses, jtables = _jax_mp(spec, steps=spec["steps"])
    dp = group.collect()
    for r in range(WORLD):
        assert mp[r]["losses"] == dp[r]["losses"]
        for k, s in mp[r]["slabs"].items():
            np.testing.assert_array_equal(s, dp[r]["slabs"][k])
        np.testing.assert_allclose(mp[r]["losses"], jlosses[r], rtol=0,
                                   atol=1e-5)
    for a, b in zip(mp[0]["tables"], jtables):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # control: the dp batch rolled by one rank's rows differs
    rolled = [np.roll(x, LOCAL_B, axis=0) if isinstance(x, np.ndarray)
              else x for x in spec["steps"][0]]
    bad = group.run("train", dict(spec, steps=[rolled, spec["steps"][1]],
                                  dp_input=False))
    assert any(bad[r]["losses"] != dp[r]["losses"] for r in range(WORLD))


SIZES = [60, 7, 33, 120, 90, 15, 48, 200]
MODEL = dict(table_sizes=SIZES, embedding_dim=16, num_numerical_features=5,
             bottom_mlp_dims=(8, 16), top_mlp_dims=(32, 16, 1))


def _dlrm_batch(rng, nan_rank=None):
    cats = [rng.integers(-2, s + 2, size=(B,)).astype(np.int32)
            for s in SIZES]
    num = rng.normal(size=(B, 5)).astype(np.float32)
    if nan_rank is not None:
        num[nan_rank * LOCAL_B + 1, 2] = np.nan
    return cats, num, (rng.random(B) < 0.3).astype(np.float32)


def _dlrm_spec():
    rng = np.random.default_rng(0)
    cfg = DLRMConfig(**MODEL)
    tree = flax_dense_tree(DLRMDense(
        cfg, device="cpu", generator=torch.Generator().manual_seed(1)))
    return dict(model=MODEL, compute_dtype="float32", table_dtype="float32",
                tables=[rng.uniform(-0.1, 0.1, size=(s, 16))
                        .astype(np.float32) for s in SIZES],
                dense_tree={"params": {k: {n: t.numpy()
                                           for n, t in v.items()}
                                       for k, v in tree["params"].items()}},
                lr=LR, batches=[_dlrm_batch(rng) for _ in range(2)],
                nan_batch=_dlrm_batch(rng, nan_rank=3),
                eval_batch=_dlrm_batch(rng), strategy="comm_balanced",
                column_slice_threshold=1000, row_slice=500)


def test_world8_mp_dlrm_step_equals_dp(group):
    """The trainer with ``MpInputs``: losses, slabs, dense parameters,
    the NaN batch's skip and the eval predictions, bit for bit."""
    spec = _dlrm_spec()
    mp = group.run("dlrm", dict(spec, dp_input=False))
    dp = group.run("dlrm", spec)
    for r in range(WORLD):
        a, b = mp[r], dp[r]
        assert a["losses"] == b["losses"] and a["unchanged"]
        assert not np.isfinite(a["nan_loss"]) and a["step"] == 3
        for k, s in a["slabs"].items():
            np.testing.assert_array_equal(s, b["slabs"][k])
        for x, y in zip(a["dense"], b["dense"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a["pred"], b["pred"])


def test_world8_mp_train_loop_equals_steps(group):
    spec = _dlrm_spec()
    got = group.run("mp_loop", dict(spec, dp_input=False))
    for r in got:
        assert r["losses"] == r["loop_losses"]
        assert r["slabs_equal"] and r["dense_equal"]
