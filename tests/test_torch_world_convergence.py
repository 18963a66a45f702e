"""``train_dlrm_convergence`` at world 8: eight gloo ranks
(``torch_dist_worker.py:case_convergence``) each take their rows of the
same seeded batches and eval set, and gather the eval predictions in
rank order, against the JAX package's program on its 8-device CPU mesh
(``models/learnable.py:train_dlrm_convergence``, ``tests/
test_convergence.py``'s configuration cut to 20 steps), from JAX's
initial tables and dense parameters carried over.

Tolerances (``tests/test_torch_convergence.py::
test_short_convergence_run_matches_jax``'s): the per-step losses within
1e-6 relative and the three AUCs within 1e-6, on every rank (one AUC on
all of them). Control: the run with the eval predictions taken from
each rank's own rows only (no gather) must fail the AUC bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense, bce_with_logits as jbce)
from distributed_embeddings_tpu.models.learnable import (
    LearnableClicks as JaxClicks)
from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, SparseAdam as JaxSparseAdam,
    init_hybrid_state as jax_init, make_hybrid_eval_step as jax_eval_step)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)
from distributed_embeddings_tpu.utils.metrics import binary_auc as jax_auc

from distributed_embeddings_torch.utils import binary_auc

from torch_dist_worker import RankGroup
from torch_world_ref import WORLD, mesh

torch.set_num_threads(1)

SIZES = [200] * 8
STEPS, BATCH, DIM, EVAL_N, SEED = 20, 1024, 8, 8192, 0
SCHED = (0.01, 20, 180, 60)
LOSS_RTOL, AUC_ATOL = 1e-6, 1e-6


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_conv"))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's initial tables and dense parameters (numpy) and its
    program's pieces on the mesh."""
    cfg = JaxConfig(table_sizes=SIZES, embedding_dim=DIM,
                    num_numerical_features=4, bottom_mlp_dims=[2 * DIM, DIM],
                    top_mlp_dims=[64, 32, 1])
    de = JaxDE(cfg.embedding_configs(), world_size=WORLD,
               strategy="memory_balanced")
    dense = JaxDense(cfg)
    dp = dense.init(jax.random.key(SEED), jnp.zeros((2, 4), jnp.float32),
                    [jnp.zeros((2, DIM), jnp.float32) for _ in SIZES])
    tx = optax.adam(jax_schedule(*SCHED))
    state = jax_init(de, JaxSparseAdam(), dp, tx, jax.random.key(SEED + 1),
                     mesh=mesh())
    tables = [np.asarray(t) for t in de.get_weights(state.emb_params)]
    return cfg, de, dense, tx, state, tables, jax.tree.map(np.asarray, dp)


def _jax_run():
    """The JAX program on the mesh: per-step losses and three AUCs."""
    cfg, de, dense, tx, state, _, _ = _jax_init()
    task = JaxClicks(SIZES, num_numerical=4, seed=123, scale=1.2)

    def loss_fn(d, outs, batch_):
        num, y = batch_
        return jbce(dense.apply(d, num, outs), y)

    step = jax_train_step(de, loss_fn, tx, JaxSparseAdam(), mesh=mesh(),
                          lr_schedule=jax_schedule(*SCHED),
                          with_metrics=False)
    eval_fn = jax_eval_step(
        de, lambda d, outs, num: jax.nn.sigmoid(dense.apply(d, num, outs)),
        mesh=mesh())

    def put(x):
        return jax.device_put(jnp.asarray(x),
                              NamedSharding(mesh(), P(de.axis_name)))

    ev_num, ev_cats, ev_y = task.sample(np.random.default_rng(999), EVAL_N)
    ev_num, ev_cats = put(ev_num), [put(c) for c in ev_cats]

    def auc(st):
        return jax_auc(ev_y, np.asarray(eval_fn(st, ev_cats, ev_num)))

    aucs, losses = [auc(state)], []
    rng = np.random.default_rng(SEED + 7)
    for i in range(STEPS):
        num, cats, y = task.sample(rng, BATCH)
        loss, state = step(state, [put(c) for c in cats], (put(num), put(y)))
        losses.append(float(loss))
        if i == STEPS // 3:
            aucs.append(auc(state))
    aucs.append(auc(state))
    return np.array(losses), aucs


def test_world8_convergence_run_matches_jax(group):
    _, _, _, _, _, tables, dense_tree = _jax_init()
    group.submit("convergence", dict(
        sizes=SIZES, tables=tables, dense_tree=dense_tree, steps=STEPS,
        batch=BATCH, dim=DIM, sched=SCHED, eval_n=EVAL_N))
    jl, jaucs = _jax_run()
    ranks = group.collect()
    for r, got in enumerate(ranks):
        assert len(got["losses"]) == STEPS
        np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["aucs"], jaucs, atol=AUC_ATOL,
                                   rtol=0, err_msg=f"rank {r}")
        assert got["aucs"] == ranks[0]["aucs"]
    assert ranks[0]["aucs"][2] > ranks[0]["aucs"][0]
    # control: rank 0's predictions alone against the eval labels of its
    # rows (what an un-gathered eval would score) miss JAX's AUC
    from distributed_embeddings_torch.models import LearnableClicks

    ev = LearnableClicks(SIZES, num_numerical=4, seed=123, scale=1.2
                         ).sample(np.random.default_rng(999), EVAL_N)
    rows = EVAL_N // WORLD
    own = binary_auc(ev[2][:rows], ranks[0]["preds0"])
    assert abs(own - jaucs[2]) > AUC_ATOL, own
