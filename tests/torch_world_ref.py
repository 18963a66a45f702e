"""JAX side of the world-8 instrumented-step tests of the port
(``test_torch_world_*.py``): the hybrid train step or loop of the JAX
package on its 8-device CPU mesh, with step metrics, telemetry and
streaming as a spec asks, from the same numpy tables, dense weight and
ids the ranks of ``torch_dist_worker.case_hybrid`` take. Every result
comes back as numpy (or the host summaries' plain values).

A spec holds ``configs`` (and optionally ``strategy``, ``row_slice``),
``tables``, ``w``, ``lr``, ``loss`` (``"proj"``, ``"sq"`` or
``"mean"``, as ``torch_dist_worker.loss_of``), ``local_batch``,
``steps`` (global inputs: dense ``[B, ...]`` int32 arrays or
``("ragged", values, splits, weights)`` per-rank CSRs), and optionally
``telemetry`` / ``dynamic`` (the configs' fields as tuples),
``with_metrics``, ``nan_guard`` and ``loop``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JaxRagged)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import streaming as jstream
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_loop, make_hybrid_train_step)

WORLD = 8


@functools.lru_cache(maxsize=None)
def mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def jax_inputs(inputs):
    """Global JAX inputs from a spec's (per-rank ragged CSRs stacked in
    the distributed ``Ragged`` convention)."""
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


def loss_of(name):
    """The JAX twins of ``torch_dist_worker.loss_of``."""

    def f(dp, outs, batch):
        if name == "proj":
            x = jnp.concatenate([o.reshape(o.shape[0], -1)
                                 .astype(jnp.float32) for o in outs], 1)
            loss = jnp.mean((x @ dp["w"]) ** 2)
        elif name == "sq":
            loss = sum(jnp.mean(o.astype(jnp.float32) ** 2)
                       for o in outs) * dp["w"]
        else:
            loss = sum(jnp.mean(o.astype(jnp.float32)) for o in outs) \
                * jnp.mean(dp["w"])
        return loss + jnp.sum(batch) * 0.0

    return f


def layer(spec):
    return JaxDE(spec["configs"], world_size=WORLD,
                 strategy=spec.get("strategy", "basic"),
                 row_slice=spec.get("row_slice"))


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def jax_hybrid(spec):
    """The JAX package's run of a spec: losses, per-step metrics (a
    stacked dict for the loop), the telemetry and streaming states
    (``[world, ...]``; after each step too, ``aux_steps``) and the host
    summaries of each."""
    jde = layer(spec)
    params = jde.set_weights(spec["tables"], mesh=mesh())
    opt, tx = JaxSparseSGD(), optax.sgd(spec["lr"])
    dp = {"w": jnp.asarray(np.asarray(spec["w"], np.float32))}
    state = JaxState(params, opt.init(params), dp, tx.init(dp),
                     jnp.zeros((), jnp.int32))
    tcfg = (jtel.TelemetryConfig(*spec["telemetry"])
            if spec.get("telemetry") else None)
    scfg = (jstream.StreamingConfig(*spec["dynamic"])
            if spec.get("dynamic") else None)
    aux = []
    if tcfg is not None:
        aux.append(jtel.init_telemetry(jde, tcfg, mesh=mesh()))
    if scfg is not None:
        aux.append(jstream.init_streaming(jde, scfg, mesh=mesh()))
    with_metrics = spec.get("with_metrics", False)
    kw = dict(mesh=mesh(), lr_schedule=spec["lr"], with_metrics=with_metrics,
              nan_guard=spec.get("nan_guard", False),
              telemetry=tcfg or False, dynamic=scfg or False)
    args = (jde, loss_of(spec["loss"]), tx, opt)
    B = WORLD * spec["local_batch"]
    losses, metrics, aux_steps = [], [], []
    if spec.get("loop"):
        stacks = [jnp.stack(x) for x in zip(*[jax_inputs(s)
                                              for s in spec["steps"]])]
        out = make_hybrid_train_loop(*args, **kw)(
            state, stacks, jnp.zeros((len(spec["steps"]), B)), *aux)
        losses = [float(x) for x in np.asarray(out[0])]
        if with_metrics:
            metrics = _np(out[2])
    else:
        step = make_hybrid_train_step(*args, **kw)
        for inputs in spec["steps"]:
            out = step(state, jax_inputs(inputs), jnp.zeros((B,)), *aux)
            state = out[1]
            losses.append(float(out[0]))
            if with_metrics:
                metrics.append(_np(out[2]))
            aux = list(out[3:] if with_metrics else out[2:])
            aux_steps.append([_np(a) for a in aux])
    aux = list(out[3:] if with_metrics else out[2:])
    res = {"losses": losses, "metrics": metrics, "aux_steps": aux_steps}
    if tcfg is not None:
        telem = _np(aux[0])
        res.update(telem=telem, hot_rows=jtel.hot_rows(jde, telem),
                   load_balance=jtel.load_balance(telem),
                   summary=jtel.summarize_telemetry(jde, telem))
    if scfg is not None:
        sstate = _np(aux[-1])
        res.update(stream=sstate, occupancy=jstream.occupancy(jde, sstate))
    return res


def assert_tree_rows_equal(got, want, rank, what=""):
    """A rank's ``[1, ...]`` state equal, bit for bit, to JAX's row
    ``rank`` of its ``[world, ...]`` state (same keys, dtypes)."""
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_rows_equal(got[k], want[k], rank, f"{what}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])[rank:rank + 1]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k} rank "
                                                    f"{rank}")


def rows_differ(ranks, want, key):
    """The ranks whose state ``key`` differs anywhere from JAX's row."""
    bad = []
    for r, got in enumerate(ranks):
        try:
            assert_tree_rows_equal(got[key], want[key], r)
        except AssertionError:
            bad.append(r)
    return bad


#: step metrics held exactly (counts, bytes, fractions of plan tallies,
#: the guard's flag); the rest (the loss, the norms and the update
#: bound) within float32 summation order
EXACT_METRICS = ("ids_routed", "id_overflow", "invalid_id_count",
                 "skipped_steps", "step", "id_a2a_bytes", "out_a2a_bytes",
                 "grad_a2a_bytes", "out_pad_frac", "table_nonfinite",
                 "stream_admitted", "stream_evicted", "stream_bucket_ids",
                 "stream_hit_ids")
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-7


def metrics_mismatch(got, want):
    """The keys of one metrics dict (numpy) that differ from JAX's in
    key set, shape, dtype or value (exact keys bit for bit, the others
    within (METRIC_RTOL, METRIC_ATOL))."""
    if sorted(got) != sorted(want):
        return ["<keys>"]
    bad = []
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            bad.append(k)
        elif k in EXACT_METRICS:
            if not np.array_equal(g, w):
                bad.append(k)
        elif not np.allclose(g, w, rtol=METRIC_RTOL, atol=METRIC_ATOL):
            bad.append(k)
    return bad


# ------------------------------------------------ checkpoints (world 8)

#: the DLRM of ``tests/test_torch_checkpoint.py`` (>= 8 tables: the mesh)
CKPT_SIZES = [50, 37, 64, 29, 50, 41, 23, 58, 33, 45]
CKPT_DIM, CKPT_NUM, CKPT_B = 8, 4, 64
CKPT_MODEL = dict(table_sizes=CKPT_SIZES, embedding_dim=CKPT_DIM,
                  num_numerical_features=CKPT_NUM, bottom_mlp_dims=(16, 8),
                  top_mlp_dims=(16, 1))
CKPT_SCHED = (2.0, 4, 8, 6)  # base lr, warmup, decay start, decay steps
#: the checkpoint cases: sparse optimizer, table dtype, plan
CKPT_CASES = {
    "sgd_bf16": dict(opt="sgd", dtype="bfloat16"),
    "adagrad": dict(opt="adagrad", dtype="float32"),
    "adam": dict(opt="adam", dtype="float32"),
    "colslice": dict(opt="sgd", dtype="float32", column_slice_threshold=256),
    "rowslice": dict(opt="sgd", dtype="float32", row_slice=300),
}


def ckpt_batches(n, seed=5):
    """``n`` global DLRM batches ``(cats, num, labels)`` of CKPT_B rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cats = [rng.integers(0, s, size=(CKPT_B,)).astype(np.int32)
                for s in CKPT_SIZES]
        num = rng.normal(size=(CKPT_B, CKPT_NUM)).astype(np.float32)
        lab = (rng.random((CKPT_B, 1)) < 0.3).astype(np.float32)
        out.append((cats, num, lab))
    return out


def ckpt_spec(case, **kw):
    """The rank side's spec of a checkpoint case (``case_ckpt``)."""
    c = CKPT_CASES[case]
    return dict(model=CKPT_MODEL, strategy="memory_balanced",
                column_slice_threshold=c.get("column_slice_threshold"),
                row_slice=c.get("row_slice"), opt=c["opt"],
                sched=CKPT_SCHED, batches=ckpt_batches(6), **kw)


@functools.lru_cache(maxsize=None)
def jax_ckpt_parts(case):
    """JAX (layer, dense module, sparse optimizer, optax tx, train step)
    of a checkpoint case on the 8-device mesh."""
    from distributed_embeddings_tpu.models.dlrm import (
        DLRMConfig as JaxConfig, DLRMDense as JaxDense, bce_with_logits)
    from distributed_embeddings_tpu.models.schedules import (
        warmup_poly_decay_schedule)
    from distributed_embeddings_tpu.parallel.optimizers import (
        SparseAdagrad, SparseAdam)

    c = CKPT_CASES[case]
    cfg = JaxConfig(**CKPT_MODEL)
    jde = JaxDE(cfg.embedding_configs(), world_size=WORLD,
                strategy="memory_balanced",
                column_slice_threshold=c.get("column_slice_threshold"),
                row_slice=c.get("row_slice"))
    dense = JaxDense(cfg)
    if c["opt"] == "sgd":
        lr = warmup_poly_decay_schedule(*CKPT_SCHED)
        emb_opt, tx = JaxSparseSGD(), optax.sgd(lr)
    elif c["opt"] == "adagrad":
        emb_opt, tx, lr = SparseAdagrad(), optax.adagrad(0.1), 0.05
    else:
        emb_opt, tx, lr = SparseAdam(), optax.adam(1e-3), 0.01

    def loss(p, outs, batch):
        n, y = batch
        return bce_with_logits(dense.apply(p, n, outs), y)

    step = make_hybrid_train_step(jde, loss, tx, emb_opt, mesh=mesh(),
                                  lr_schedule=lr, with_metrics=False,
                                  telemetry=False)
    return jde, dense, emb_opt, tx, step


def jax_ckpt_state(case, seed=0):
    """A JAX train state of a checkpoint case on the mesh with every
    component non-trivial: random tables, random slab-shaped optimizer
    state, Adam counts 3 + rank (so a gather out of rank order shows),
    the dense parameters of flax's init and step 7."""
    jde, dense, emb_opt, tx, _ = jax_ckpt_parts(case)
    dtype = getattr(jnp, CKPT_CASES[case]["dtype"])
    rng = np.random.default_rng(seed)

    def tables(lo, hi):
        return [rng.uniform(lo, hi, size=(s, CKPT_DIM)).astype(np.float32)
                for s in CKPT_SIZES]

    params = jde.set_weights(tables(-0.1, 0.1), mesh=mesh(), dtype=dtype)
    opt = emb_opt.init(params)

    def slab_like(like):
        return jde.set_weights(tables(0.05, 0.2), mesh=mesh(),
                               dtype=like.dtype)

    if CKPT_CASES[case]["opt"] == "adagrad":
        new = slab_like(next(iter(opt.values())))
        assert {k: v.shape for k, v in new.items()} == \
            {k: v.shape for k, v in opt.items()}
        opt = new
    elif CKPT_CASES[case]["opt"] == "adam":
        mu = slab_like(next(iter(opt.values()))[0])
        nu = slab_like(next(iter(opt.values()))[1])
        assert all(mu[k].shape == opt[k][0].shape for k in opt)
        opt = {k: (mu[k], nu[k], jnp.asarray(
            (3 + np.arange(WORLD)).reshape(WORLD, 1, 1).astype(
                np.asarray(c).dtype)))
            for k, (_, _, c) in opt.items()}
    dp = dense.init(jax.random.key(1), jnp.zeros((2, CKPT_NUM)),
                    [jnp.zeros((2, CKPT_DIM))] * len(CKPT_SIZES))
    # flax's init keeps its modules' creation order (kernel, bias); a
    # state a step returns has JAX's sorted dict order, as the port
    # writes it: checkpoints of trained states are what is compared
    dp = jax.tree.map(lambda a: a, dp)
    return JaxState(params, opt, dp, tx.init(dp), jnp.asarray(7, jnp.int32))


def jax_ckpt_steps(case, state, batches):
    """The JAX train step over ``batches``: (losses, state)."""
    step = jax_ckpt_parts(case)[4]
    losses = []
    for cats, num, lab in batches:
        loss, state = step(state, [jnp.asarray(c) for c in cats],
                           (jnp.asarray(num), jnp.asarray(lab)))
        losses.append(float(loss))
    return losses, state


def tree_bits_equal(a, b):
    """Two JAX (or numpy) trees equal bit for bit (bf16 compared as
    raw bits)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype.itemsize == 2:
            x, y = x.view(np.uint16), y.view(np.uint16)
        if not np.array_equal(x, y):
            return False
    return True
