"""The port's multichip dryrun twin (``distributed_embeddings_torch/
dryrun.py``) against the JAX package's step on the same weights.

``dryrun_multichip(8, device="cpu")`` runs eight gloo ranks of one
hybrid train step: ``comm_balanced``, ``column_slice_threshold`` 2000 and
``row_slice`` 1000 (both slicing modes engage), feature 0 a ragged
``sum`` feature, ``SparseAdagrad`` on the tables and SGD at 0.01 on the
dense half. The JAX layer on the 8-device CPU mesh takes the same step
from the same tables and dense parameters (``dryrun_problem``; the port's
ranks load them through ``hybrid_state_from_jax``): the loss within 1e-5
and the tables within rtol 1e-5, atol 1e-6 (the JAX row-slicing test's
bounds), the dense parameters within the same. Controls: the tables
before the step (no update) and the step's tables with one row-sliced
table's update shifted by its first slice's rows (where ids left
unrebased would have put it) must fail the table bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JaxRagged)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JaxSparseAdagrad)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch import dryrun

WORLD = 8
LOSS_ATOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _port():
    return dryrun.dryrun_multichip(WORLD, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax():
    prob = dryrun.dryrun_problem(WORLD)
    cfg = prob["config"]
    jcfg = JaxConfig(table_sizes=cfg.table_sizes,
                     embedding_dim=cfg.embedding_dim,
                     num_numerical_features=cfg.num_numerical_features,
                     bottom_mlp_dims=tuple(cfg.bottom_mlp_dims),
                     top_mlp_dims=tuple(cfg.top_mlp_dims))
    emb = jcfg.embedding_configs()
    emb[0]["combiner"] = "sum"
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jde = JaxDE(emb, world_size=WORLD, strategy="comm_balanced",
                column_slice_threshold=dryrun.COLUMN_SLICE_THRESHOLD,
                row_slice=dryrun.ROW_SLICE)
    params = jde.set_weights(prob["tables"], mesh=mesh)
    dense = JaxDense(jcfg)
    dp = jax.tree.map(jnp.asarray, prob["dense_tree"])
    opt, tx = JaxSparseAdagrad(), optax.sgd(dryrun.LR)
    state = JaxState(params, opt.init(params), dp, tx.init(dp),
                     jnp.zeros((), jnp.int32))

    def loss_fn(p, outs, batch):
        n, y = batch
        return jax_bce(dense.apply(p, n, outs), y)

    step = jax_train_step(jde, loss_fn, tx, opt, mesh=mesh,
                          lr_schedule=dryrun.LR, with_metrics=False)
    values, splits = prob["categorical"][0]
    cats = [JaxRagged(values=jnp.asarray(values.reshape(-1)),
                      row_splits=jnp.asarray(splits.reshape(-1)))]
    cats += [jnp.asarray(c) for c in prob["categorical"][1:]]
    loss, state = step(state, cats, (jnp.asarray(prob["numerical"]),
                                     jnp.asarray(prob["labels"])))
    tree = jax.tree.map(np.asarray, state.dense_params)["params"]
    names = sorted(tree, key=lambda k: int(k.split("_")[-1]))
    dense_after = [a for n in names
                   for a in (tree[n]["kernel"].T, tree[n]["bias"])]
    return (prob, jde, float(loss), jde.get_weights(state.emb_params),
            dense_after)


def _table_errs(got, want):
    """Tables outside ``|got - want| <= ATOL + RTOL |want|``."""
    return [t for t, (a, b) in enumerate(zip(got, want))
            if not np.allclose(a, b, rtol=RTOL, atol=ATOL)]


def test_dryrun_twin_engages_both_slicings():
    port = _port()
    _, jde, _, _, _ = _jax()
    assert port["row_sliced_tables"] == sorted(jde.strategy.row_sliced_tables)
    assert port["row_sliced_tables"], "row slicing engaged"
    assert port["sliced_out_ranges"] == [
        list(r) for r in jde.strategy.sliced_out_ranges]
    assert port["sliced_out_ranges"], "column slicing engaged"
    assert np.isfinite(port["loss"])


def test_dryrun_twin_matches_jax_step():
    port = _port()
    prob, _, jloss, jtables, jdense = _jax()
    assert abs(port["loss"] - jloss) <= LOSS_ATOL, (port["loss"], jloss)
    assert _table_errs(port["tables"], jtables) == []
    for a, b in zip(port["dense"], jdense):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # every table the batch reads moved
    moved = [t for t, (a, b) in enumerate(zip(jtables, prob["tables"]))
             if not np.array_equal(a, b)]
    assert moved == list(range(len(prob["tables"])))


def _slice_rows(strategy, tid):
    """The first row slice's rows of row-sliced table ``tid``."""
    return min(cfg["input_dim"]
               for tids, cfgs in zip(strategy.table_ids_list,
                                     strategy.local_configs_list)
               for t, cfg in zip(tids, cfgs)
               if t == tid and cfg.get("_row_base") == 0)


@pytest.mark.parametrize("control", ["no_update", "rbase_dropped"])
def test_dryrun_table_bound_controls(control):
    """Table states the bound must reject: the tables before the step,
    and the step's tables with a row-sliced table's update shifted by its
    first slice's rows (where ids left unrebased would have put it)."""
    port = _port()
    prob, jde, _, jtables, _ = _jax()
    if control == "no_update":
        bad = prob["tables"]
    else:
        t = sorted(jde.strategy.row_sliced_tables)[0]
        before = prob["tables"][t]
        upd = port["tables"][t] - before
        bad = list(port["tables"])
        bad[t] = before + np.roll(upd, -_slice_rows(jde.strategy, t), axis=0)
    assert _table_errs(bad, jtables), f"{control} passes the bound"


def test_dryrun_twin_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
