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
