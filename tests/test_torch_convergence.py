"""The planted-signal convergence path against the JAX package: the
port's copies of ``LearnableClicks``, ``binary_auc`` and
``warmup_poly_decay_schedule``, then a short ``train_dlrm_convergence``
run (``SparseAdam`` + ``Adam``, the learning test's configuration cut to
20 steps) from the JAX package's initial state, carried over, against
the same steps of the JAX package's program.

Tolerances, with their reasons:
  - the task's batches, the AUC and the schedule: bitwise (numpy in
    both; the schedule's float32 ops in the same order);
  - the 20-step run, float32 tables: the losses within 1e-6 relative
    and the three AUCs within 1e-6 (measured 2.4e-7 and 1.2e-7: one
    state, and only the MLP sums' order differs between jitted XLA and
    eager PyTorch; Adam's normalized steps could turn such a difference
    into up to lr per element, but over 20 steps none reaches the
    ranking of the 8,192 eval samples);
  - a 6-step ``optimizer="mixed"`` run (dense Adam + ``SparseSGD``) on
    bfloat16 tables under a schedule (the promoted scatter, K18's plain
    version): losses within 2e-5 and AUCs within 1e-5 (measured 3.8e-6
    and 1.8e-6: a bf16 cotangent rounds after MLP sums in another order,
    so an update element can differ by a bf16 ulp of the cotangent).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense, bce_with_logits as jbce)
from distributed_embeddings_tpu.models.learnable import (
    LearnableClicks as JaxClicks)
from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, SparseAdam as JaxSparseAdam,
    SparseSGD as JaxSparseSGD,
    init_hybrid_state as jax_init, make_hybrid_eval_step as jax_eval_step)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)
from distributed_embeddings_tpu.utils.metrics import binary_auc as jax_auc

from distributed_embeddings_torch.models import (
    LearnableClicks, train_dlrm_convergence, warmup_poly_decay_schedule)
from distributed_embeddings_torch.parallel import SparseAdam, SparseSGD
from distributed_embeddings_torch.utils import binary_auc
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

torch.set_num_threads(1)

# tests/test_convergence.py's configuration, cut to STEPS steps
SIZES = [200] * 8
STEPS = 20
BATCH = 1024
DIM = 8
EVAL_N = 8192
SEED = 0
MIXED_SCHED = (0.5, 3, 4, 4)  # base lr, warmup, decay start, decay steps


def test_learnable_clicks_sample_bitwise():
    for sizes, nnum, seed, scale in (([200] * 8, 4, 123, 1.2),
                                     ([2000] * 8 + [7], 13, 0, 1.0)):
        a = LearnableClicks(sizes, num_numerical=nnum, seed=seed,
                            scale=scale)
        b = JaxClicks(sizes, num_numerical=nnum, seed=seed, scale=scale)
        ra, rb = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(2):
            (na, ca, ya), (nb, cb, yb) = a.sample(ra, 300), b.sample(rb, 300)
            np.testing.assert_array_equal(na, nb)
            np.testing.assert_array_equal(ya, yb)
            assert len(ca) == len(cb) == len(sizes)
            for x, y in zip(ca, cb):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)


def test_binary_auc_equal():
    rng = np.random.default_rng(3)
    labels = (rng.random(5000) < 0.3).astype(np.float32)
    preds = rng.random(5000).astype(np.float32)
    ties = np.round(preds * 20) / 20  # many ties: average ranks
    for p in (preds, ties, labels * 0.5 + preds * 0.1):
        assert binary_auc(labels, p) == jax_auc(labels, p)
    assert binary_auc(labels, labels) == 1.0
    assert np.isnan(binary_auc(np.zeros(4), preds[:4]))


@pytest.mark.parametrize("args", [(0.01, 20, 180, 60), (0.3, 7, 50, 200, 3)])
def test_warmup_poly_decay_schedule_equal(args):
    """Steps 0-300 as the train state's int32 step tensor and as Python
    ints: a 0-d float32 on the step's device, equal to JAX's bit for
    bit."""
    ours, theirs = warmup_poly_decay_schedule(*args), jax_schedule(*args)
    for s in range(301):
        want = np.asarray(theirs(jnp.asarray(s, jnp.int32)))
        got = ours(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy() == want, (s, float(got), float(want))
        assert ours(s).numpy() == want


def test_convergence_run_rejects_what_is_not_ported():
    """The port has no mesh object: a mesh raises. ``world_size=8`` is
    ported (``tests/test_torch_world_example.py`` runs it in eight
    ranks); outside a process group it raises for the missing group,
    and a batch the world does not divide raises."""
    task = LearnableClicks([10] * 8, num_numerical=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        train_dlrm_convergence(task, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        train_dlrm_convergence(task, world_size=8, steps=1, batch=8,
                               eval_n=16, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        train_dlrm_convergence(task, world_size=8, steps=1, batch=12,
                               eval_n=16, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        train_dlrm_convergence(task, steps=1, batch=8, eval_n=16,
                               optimizer="lamb", device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(mixed_bf16=False, steps=STEPS):
    """The JAX package's program (``models/learnable.py:
    train_dlrm_convergence``) for ``steps`` steps, keeping its initial
    state (as numpy, before any donating step), its losses and its AUCs.
    ``mixed_bf16``: ``optimizer="mixed"`` (dense Adam + ``SparseSGD``)
    on bfloat16 tables under MIXED_SCHED."""
    task = JaxClicks(SIZES, num_numerical=4, seed=123, scale=1.2)
    sched = jax_schedule(*(MIXED_SCHED if mixed_bf16 else
                           (0.01, 20, 180, 60)))
    cfg = JaxConfig(table_sizes=SIZES, embedding_dim=DIM,
                    num_numerical_features=4, bottom_mlp_dims=[2 * DIM, DIM],
                    top_mlp_dims=[64, 32, 1])
    de = JaxDE(cfg.embedding_configs(), world_size=1,
               strategy="memory_balanced")
    dense = JaxDense(cfg)
    dp = dense.init(jax.random.key(SEED), jnp.zeros((2, 4), jnp.float32),
                    [jnp.zeros((2, DIM), jnp.float32) for _ in SIZES])
    tx = optax.adam(sched)
    emb_opt = JaxSparseSGD() if mixed_bf16 else JaxSparseAdam()

    def loss_fn(d, outs, batch_):
        num, y = batch_
        return jbce(dense.apply(d, num, outs), y)

    state = jax_init(de, emb_opt, dp, tx, jax.random.key(SEED + 1),
                     dtype=jnp.bfloat16 if mixed_bf16 else jnp.float32)
    init = (de.get_weights(state.emb_params),
            jax.tree.map(np.array, state))
    step = jax_train_step(de, loss_fn, tx, emb_opt, lr_schedule=sched,
                          with_metrics=False)
    eval_fn = jax_eval_step(
        de, lambda d, outs, num: jax.nn.sigmoid(dense.apply(d, num, outs)))
    ev_num, ev_cats, ev_y = task.sample(np.random.default_rng(999), EVAL_N)
    ev_cats = [jnp.asarray(c) for c in ev_cats]

    def auc(st):
        return jax_auc(ev_y, np.asarray(eval_fn(st, ev_cats,
                                                jnp.asarray(ev_num))))

    aucs = [auc(state)]
    rng = np.random.default_rng(SEED + 7)
    losses = []
    for i in range(steps):
        num, cats, y = task.sample(rng, BATCH)
        loss, state = step(state, [jnp.asarray(c) for c in cats],
                           (jnp.asarray(num), jnp.asarray(y)))
        losses.append(float(loss))
        if i == steps // 3:
            aucs.append(auc(state))
    aucs.append(auc(state))
    return init, np.array(losses), aucs


def test_short_convergence_run_matches_jax():
    """``train_dlrm_convergence`` on the CPU from the JAX program's
    initial state: per-step losses and the three AUCs."""
    (tables, host), jl, jaucs = _jax_run()
    task = LearnableClicks(SIZES, num_numerical=4, seed=123, scale=1.2)

    def init_state(de, dense, emb_opt, tx):
        assert isinstance(emb_opt, SparseAdam)
        return hybrid_state_from_jax(
            de, dense, tables, host.dense_params, host.step,
            emb_opt_state=host.emb_opt_state,
            dense_opt_state=host.dense_opt_state, device="cpu",
            emb_optimizer=emb_opt, dense_tx=tx)

    losses = []
    aucs = train_dlrm_convergence(
        task, steps=STEPS, batch=BATCH, embedding_dim=DIM,
        lr_schedule=warmup_poly_decay_schedule(0.01, 20, 180, 60),
        eval_n=EVAL_N, seed=SEED, device="cpu", init_state=init_state,
        on_step=lambda i, loss, st: losses.append(float(loss)))
    assert len(losses) == STEPS and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jl, rtol=1e-6)
    np.testing.assert_allclose(aucs, jaucs, atol=1e-6, rtol=0)
    assert aucs[2] > aucs[0]  # it learns, even in 20 warmup steps


def test_mixed_bf16_scheduled_run_matches_jax():
    """``train_dlrm_convergence(optimizer="mixed", param_dtype=bfloat16,
    lr_schedule=<schedule>)``, which raised until the promoted scatter
    was ported, from the JAX program's initial state: 6 steps."""
    steps = 6
    (tables, host), jl, jaucs = _jax_run(True, steps)
    task = LearnableClicks(SIZES, num_numerical=4, seed=123, scale=1.2)

    def init_state(de, dense, emb_opt, tx):
        assert isinstance(emb_opt, SparseSGD)
        return hybrid_state_from_jax(
            de, dense, tables, host.dense_params, host.step,
            emb_opt_state=host.emb_opt_state,
            dense_opt_state=host.dense_opt_state, dtype=torch.bfloat16,
            device="cpu", emb_optimizer=emb_opt, dense_tx=tx)

    losses = []
    aucs = train_dlrm_convergence(
        task, steps=steps, batch=BATCH, embedding_dim=DIM,
        lr_schedule=warmup_poly_decay_schedule(*MIXED_SCHED),
        param_dtype=torch.bfloat16, optimizer="mixed", eval_n=EVAL_N,
        seed=SEED, device="cpu", init_state=init_state,
        on_step=lambda i, loss, st: losses.append(float(loss)))
    assert len(losses) == steps and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jl, atol=2e-5, rtol=0)
    np.testing.assert_allclose(aucs, jaucs, atol=1e-5, rtol=0)
