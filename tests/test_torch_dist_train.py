"""The port's world-8 training against the JAX package on its 8-device
CPU mesh: eight gloo ranks (``torch_dist_worker.py``, one group for the
whole file) from the same tables, dense parameters and ids.

* Sparse steps of random column-sliced 12-table models (``sum(mean(out
  ** 2))`` on every rank's rows, the sparse backward through the reverse
  exchange, ``scale = 1/world``): 3 ``SparseSGD`` steps (``basic``) and 3
  ``SparseAdagrad`` steps (``memory_balanced``). Per rank: the local
  losses within rtol 1e-5 (float32 summation order, compounded over the
  steps), the slab within atol 1e-5 (the same
  scatter in another duplicate order; XLA's CPU rsqrt is an
  approximation), the Adagrad accumulator within rtol 1e-5.
* The DLRM hybrid step (``make_hybrid_train_step``) at world 8: 8 tables
  of width 16 (the layer needs at least one table a rank), some of them
  column-sliced, float32 tables, float32 or bf16 compute, guard on, 2
  steps, then a NaN batch on rank 3's rows only, then eval. The losses
  are the global batch's on every rank; dense parameters are equal on
  every rank (bitwise: one all-reduce gives every rank the same mean).
  Slabs and dense parameters are held by their two-step update against
  JAX's (``DLRM_BOUNDS``): tight at float32, where two controls (dense
  gradients summed over the ranks instead of averaged, the sparse apply
  skipped) must fail the bounds; loose at bf16, where rounding alone
  moves JAX's own update far. The NaN batch is skipped by EVERY rank,
  slabs and dense parameters bitwise unchanged, the step advanced; eval
  predictions gathered in rank order by ``bootstrap.to_host``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.ops.packed_slab import unpack_rows_np
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad, SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_eval_step as jax_eval_step,
    make_hybrid_train_step as jax_train_step)

from torch_dist_worker import RankGroup

torch.set_num_threads(1)

WORLD = 8
LOCAL_B = 4
LR = 0.05


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_train"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _rank_rows(packed, w):
    """JAX's global packed ``[world, phys, pw]`` as per-rank logical
    rows."""
    return [unpack_rows_np(np.asarray(packed[r], np.float32), w)
            for r in range(WORLD)]


# ------------------------------------------------- sparse random models


def _random_spec(seed, strategy, cst, optimizer):
    rng = np.random.default_rng(seed)
    configs = [{"input_dim": int(rng.integers(4, 100)),
                "output_dim": int(rng.integers(1, 9)),
                "combiner": rng.choice([None, "sum", "mean"])}
               for _ in range(12)]
    tables = [rng.normal(size=(c["input_dim"], c["output_dim"]))
              .astype(np.float32) for c in configs]
    steps = []
    for _ in range(3):
        steps.append([rng.integers(0, c["input_dim"], size=(
            WORLD * LOCAL_B,
            int(rng.integers(1, 5)) if c["combiner"] else 1))
            .astype(np.int32) for c in configs])
    return dict(configs=configs, strategy=strategy,
                column_slice_threshold=cst, tables=tables, steps=steps,
                optimizer=optimizer, lr=LR)


@functools.lru_cache(maxsize=None)
def _jax_train(seed, strategy, cst, optimizer):
    spec = _random_spec(seed, strategy, cst, optimizer)
    jde = JaxDE(spec["configs"], world_size=WORLD, strategy=strategy,
                column_slice_threshold=cst)
    params = jde.set_weights(spec["tables"], mesh=_mesh())
    opt = (JaxSparseAdagrad(initial_accumulator_value=0.1)
           if optimizer == "adagrad" else JaxSparseSGD())
    ost = opt.init(params)
    n = len(spec["configs"])

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
        params, ost, loss = fn(params, ost, *[jnp.asarray(x)
                                             for x in inputs])
        losses.append(np.asarray(loss))
    slabs = {k: _rank_rows(v, int(k[1:])) for k, v in params.items()}
    acc = ({k: _rank_rows(v, int(k[1:])) for k, v in ost.items()}
           if optimizer == "adagrad" else None)
    return spec, np.stack(losses, axis=1), slabs, acc


@pytest.mark.parametrize("optimizer,strategy", [("sgd", "basic"),
                                                ("adagrad", "memory_balanced")])
def test_world8_sparse_steps_match_jax(group, optimizer, strategy):
    """Column-sliced random models (threshold 150 elements)."""
    seed, cst = {"sgd": 13, "adagrad": 29}[optimizer], 150
    group.submit("train", _random_spec(seed, strategy, cst, optimizer))
    spec, jlosses, jslabs, jacc = _jax_train(seed, strategy, cst, optimizer)
    ranks = group.collect()
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jlosses[r], rtol=1e-5,
                                   err_msg=f"rank {r} losses")
        for k, s in got["slabs"].items():
            np.testing.assert_allclose(s, jslabs[k][r][:s.shape[0]],
                                       atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} slab {k}")
        if jacc is not None:
            for k, a in got["acc"].items():
                np.testing.assert_allclose(a, jacc[k][r][:a.shape[0]],
                                           rtol=1e-5,
                                           err_msg=f"rank {r} acc {k}")
    trained = [a != b for a, b in zip(ranks[0]["tables"], spec["tables"])]
    assert all(t.any() for t in trained[:1]) and any(t.any()
                                                     for t in trained)


# ------------------------------------------------------- the DLRM step


SIZES = [60, 7, 33, 120, 90, 15, 48, 200]
NUM = 5
DIM = 16
MODEL = dict(table_sizes=SIZES, embedding_dim=DIM,
             num_numerical_features=NUM, bottom_mlp_dims=(8, DIM),
             top_mlp_dims=(32, 16, 1))
NAN_RANK = 3


def _dlrm_batch(rng, nan_rank=None):
    b = WORLD * LOCAL_B
    cats = [rng.integers(-2, s + 2, size=(b,)).astype(np.int32)
            for s in SIZES]
    num = rng.normal(size=(b, NUM)).astype(np.float32)
    if nan_rank is not None:
        num[nan_rank * LOCAL_B + 1, 2] = np.nan
    lab = (rng.random(b) < 0.3).astype(np.float32)
    return cats, num, lab


KW = dict(world_size=WORLD, strategy="comm_balanced",
          column_slice_threshold=1000)
#: per compute dtype: (losses atol, prediction atol, slab and dense
#: update gaps, controls run). The gaps are ``max|port update - JAX
#: update| / max|JAX update|`` over each slab / dense parameter of each
#: rank after the two steps (see :func:`_update_gaps`).
#:
#: float32 compute is held tight, and its controls must fail it. Measured
#: on the CPU: losses and predictions within 6e-8, slab gap 2.4e-5, dense
#: gap 9.1e-6; the dense-summed control gives a dense gap of 6.84, the
#: sparse-skipped one a slab gap of 1.0.
#:
#: bf16 compute rounds at other places in the two frameworks, and at a
#: 4-row local batch the updates are sums of cotangents that mostly
#: cancel, so rounding moves them a long way: JAX's own bf16 update lies
#: up to 0.77 (slabs) and 0.21 (dense) of its size from JAX's float32
#: update. Measured port-vs-JAX at bf16: losses within 2.0e-4,
#: predictions within 1.7e-3, slab gap 0.80, dense gap 0.12. Its bounds
#: only catch gross faults; the float32 case is the parity test of the
#: update.
DLRM_BOUNDS = {
    "float32": (1e-5, 1e-5, 1e-4, 1e-4, ("dense_summed", "sparse_skipped")),
    "bfloat16": (5e-3, 2e-2, 1.0, 0.25, ()),
}


@functools.lru_cache(maxsize=None)
def _dlrm_spec(compute_dtype):
    """The state (tables, flax dense parameters) and batches both sides
    start from."""
    rng = np.random.default_rng(0)
    tables = [rng.uniform(-s ** -0.5, s ** -0.5, size=(s, DIM))
              .astype(np.float32) for s in SIZES]
    jdense = JaxDense(JaxConfig(compute_dtype=getattr(jnp, compute_dtype),
                                **MODEL))
    dp = jdense.init(jax.random.key(1), jnp.zeros((2, NUM)),
                     [jnp.zeros((2, DIM))] * len(SIZES))
    return dict(model=MODEL, compute_dtype=compute_dtype,
                table_dtype="float32", tables=tables,
                dense_tree=jax.tree.map(np.asarray, dp), lr=LR,
                batches=[_dlrm_batch(rng) for _ in range(2)],
                nan_batch=_dlrm_batch(rng, nan_rank=NAN_RANK),
                eval_batch=_dlrm_batch(rng),
                controls=DLRM_BOUNDS[compute_dtype][-1], **KW)


@functools.lru_cache(maxsize=None)
def _jax_dlrm(compute_dtype):
    spec = _dlrm_spec(compute_dtype)
    cdt = getattr(jnp, compute_dtype)
    jcfg = JaxConfig(compute_dtype=cdt, **MODEL)
    jde = JaxDE(jcfg.embedding_configs(), compute_dtype=cdt, **KW)
    jparams = jde.set_weights(spec["tables"], mesh=_mesh())
    jdense = JaxDense(jcfg)
    dp = jax.tree.map(jnp.asarray, spec["dense_tree"])
    tx = optax.sgd(LR)
    state = JaxState(jparams, JaxSparseSGD().init(jparams), dp,
                     tx.init(dp), jnp.zeros((), jnp.int32))

    def jloss(p, outs, batch):
        n, y = batch
        return jax_bce(jdense.apply(p, n, outs), y)

    step = jax_train_step(jde, jloss, tx, JaxSparseSGD(), mesh=_mesh(),
                          lr_schedule=LR, with_metrics=False,
                          nan_guard=True, telemetry=False)

    def run(st, batch):
        cats, num, lab = batch
        return step(st, [jnp.asarray(c) for c in cats],
                    (jnp.asarray(num), jnp.asarray(lab)))

    start = jax.tree.map(np.asarray, state)
    losses = []
    for batch in spec["batches"]:
        loss, state = run(state, batch)
        losses.append(float(loss))
    host = jax.tree.map(np.asarray, state)
    nan_loss, state = run(state, spec["nan_batch"])
    after = jax.tree.map(np.asarray, state)
    cats, num, _ = spec["eval_batch"]
    pred = jax_eval_step(jde, lambda p, outs, n: jax.nn.sigmoid(
        jdense.apply(p, n, outs).astype(jnp.float32)), mesh=_mesh())(
        state, [jnp.asarray(c) for c in cats], jnp.asarray(num))
    return (jde, losses, float(nan_loss), start, host, after,
            np.asarray(pred))


def _dense_list(tree):
    """Flax DLRMDense parameters in the port's ``parameters()`` order."""
    tree = tree["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    return [a for n in names for a in (tree[n]["kernel"].T, tree[n]["bias"])]


def _update_gaps(res, slabs0, slabs1, dense0, dense1):
    """How far one rank's two-step update lies from JAX's, relative to
    JAX's: ``max|(port - start) - (jax - start)| / max|jax - start|`` for
    each slab (``slabs0``/``slabs1``: JAX's rows of this rank before and
    after) and each dense parameter; a tensor JAX left unchanged must
    stay bitwise unchanged. Returns (worst slab gap, worst dense gap)."""
    def gap(got, before, after):
        err = np.abs(got.astype(np.float64) - after).max()
        step = np.abs(after.astype(np.float64) - before).max()
        if step == 0:  # a slab this rank holds no table of
            return 0.0 if err == 0 else np.inf
        return float(err / step)

    slab = max(gap(s, slabs0[k][:s.shape[0]], slabs1[k][:s.shape[0]])
               for k, s in res["slabs"].items())
    dense = max(gap(a, b, c) for a, b, c in zip(res["dense"], dense0, dense1))
    return slab, dense


@pytest.mark.parametrize("compute_dtype", sorted(DLRM_BOUNDS))
def test_world8_dlrm_hybrid_step_matches_jax(group, compute_dtype):
    loss_atol, pred_atol, slab_gap, dense_gap, controls = DLRM_BOUNDS[
        compute_dtype]
    group.submit("dlrm", _dlrm_spec(compute_dtype))
    jde, jlosses, jnan, start, host, after, jpred = _jax_dlrm(compute_dtype)
    assert jde.strategy.sliced_out_ranges, "column slicing engaged"
    ranks = group.collect()
    # JAX skipped the NaN batch too
    jax.tree.map(np.testing.assert_array_equal, after.emb_params,
                 host.emb_params)
    jax.tree.map(np.testing.assert_array_equal, after.dense_params,
                 host.dense_params)
    assert not np.isfinite(jnan)
    slabs0 = {k: _rank_rows(v, int(k[1:]))
              for k, v in start.emb_params.items()}
    slabs1 = {k: _rank_rows(v, int(k[1:]))
              for k, v in host.emb_params.items()}
    dense0 = _dense_list(start.dense_params)
    dense1 = _dense_list(host.dense_params)
    gaps = {}
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jlosses, atol=loss_atol,
                                   rtol=0, err_msg=f"rank {r} losses")
        assert got["losses"] == ranks[0]["losses"]  # one global mean
        assert not np.isfinite(got["nan_loss"])
        assert got["unchanged"], f"rank {r} changed on the NaN batch"
        assert got["step"] == 3 == int(after.step)
        for a, b in zip(got["dense"], ranks[0]["dense"]):
            np.testing.assert_array_equal(a, b)  # replicas stay equal
        for run, res in [("step", got)] + sorted(got["controls"].items()):
            slab, dense = _update_gaps(
                res, {k: v[r] for k, v in slabs0.items()},
                {k: v[r] for k, v in slabs1.items()}, dense0, dense1)
            gaps[run] = (max(gaps.get(run, (0, 0))[0], slab),
                         max(gaps.get(run, (0, 0))[1], dense))
        np.testing.assert_allclose(
            got["pred"], jpred[r * LOCAL_B:(r + 1) * LOCAL_B],
            atol=pred_atol, rtol=0)
        np.testing.assert_array_equal(
            got["pred_all"], np.concatenate([x["pred"] for x in ranks]))
    assert sorted(gaps) == sorted(("step",) + controls)
    assert gaps["step"][0] <= slab_gap and gaps["step"][1] <= dense_gap, gaps
    # the controls break the step and must fall outside the bounds
    if "dense_summed" in controls:
        assert gaps["dense_summed"][1] > dense_gap, gaps
    if "sparse_skipped" in controls:
        assert gaps["sparse_skipped"][0] > slab_gap, gaps


# -------------------------------------------- the gradient glue, bootstrap


def test_world8_gradient_glue_and_bootstrap(group):
    """``mean_flat``/``resolve_dp_gradient`` give the mean over ranks (a
    SUM all-reduce then / world, in the tensors' dtypes), without
    touching their inputs; ``hybrid_gradients`` divides mp leaves by the
    world and averages dp ones; ``broadcast_variables`` copies the root's
    values in place; ``to_host`` gathers in rank order; ``shard_batch``
    pads every rank's ragged rows to one capacity; ``init`` draws each
    rank's slab from ``(seed, rank)``, the same twice."""
    configs = [{"input_dim": 50, "output_dim": 4}] * 8
    ranks = group.run("glue", {"configs": configs})
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    mean = x * np.mean(np.arange(1, WORLD + 1))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mean"][0], mean, rtol=1e-6)
        assert got["mean"][1].item() == np.mean(np.arange(WORLD))  # 3.5
        assert got["mean_dtypes"] == ["torch.float32", "torch.bfloat16"]
        np.testing.assert_allclose(got["resolved"], mean, rtol=1e-6)
        np.testing.assert_array_equal(got["x_after"], x * (r + 1))
        mp_mp, mp_dp, dp_mp, dp_dp = got["split"]
        np.testing.assert_array_equal(mp_mp, x * (r + 1))
        assert mp_dp == [None, None] and dp_mp is None
        np.testing.assert_array_equal(dp_dp[1], x[0] * (r + 1))
        np.testing.assert_allclose(got["hybrid"][0], x * (r + 1) / WORLD)
        np.testing.assert_allclose(got["hybrid"][1][0], mean, rtol=1e-6)
        np.testing.assert_array_equal(got["params"][0], np.full(3, 2.0))
        np.testing.assert_array_equal(got["params"][1], np.full(2, -2.0))
        np.testing.assert_array_equal(got["to_host"], np.stack(
            [x[0] * (k + 1) for k in range(WORLD)]))
        assert got["seed"] == 100
        assert got["world"] == (WORLD, r, WORLD)
        values, splits, weights = got["ragged"]
        np.testing.assert_array_equal(values, [1, 2, 3, 4, 5, 6])
        np.testing.assert_array_equal(splits, [0, 1, 3, 3, 6])
        np.testing.assert_allclose(weights, [0.5, 1, 2, 3, 4, 5])
        assert got["init_same"]
    slabs = [got["init"]["w4"] for got in ranks]
    assert not np.array_equal(slabs[0], slabs[1])
