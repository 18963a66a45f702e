"""Hybrid train step, its loop, the train state and the eval step
(counterpart of ``distributed_embeddings_tpu/parallel/trainer.py``).

* dense (data-parallel) parameters: autograd + a dense optimizer with
  ``optax``'s ``init``/``update`` contract (:class:`~.optimizers.SGD`,
  :class:`~.optimizers.Adagrad`, :class:`~.optimizers.Adam`), updated
  in place;
* embedding slabs: **no autograd through the tables**. The forward runs
  outside autograd; its outputs are detached leaves, the dense model is
  differentiated w.r.t. them, and their cotangents feed
  :meth:`~.dist_embedding.DistributedEmbedding.sparse_apply_gradients`,
  which scatters per-row updates into the slabs in place. (A graph edge
  to a slab would make PyTorch build a dense gradient as large as the
  slab.)

At world > 1 every rank runs the step on its rows of the batch, in
lockstep (a ``dp_input=False`` layer takes its embedding input as an
:class:`~.dist_embedding.MpInputs` batch, the ids of its tables over the
global batch, while the dense batch stays this rank's rows): the
embedding forward and the sparse backward exchange over the layer's
process group, and the loss, the guard's probe and every
dense gradient are averaged in ONE float32 all-reduce
(:func:`~.grads.mean_flat`), so every rank applies the same dense update
and skips a non-finite batch together.

Two hand-written kernels carry the step's epilogue: K21
(``ops/grad_health.py``) reads every cotangent and dense gradient once
for the non-finite guard's energies (and, under ``with_metrics``, the
norms and the per-table health sentinels), and K22
(``ops/dense_update.py``, through the dense optimizer's ``update_``)
updates the dense parameters and their optimizer state in place with the
guard's select fused.

Access telemetry (``telemetry=``, ``analysis/telemetry.py``) and
streaming vocabularies (``dynamic=``, ``parallel/streaming.py``) ride
through both as extra arguments and results, telemetry first; at world
> 1 each rank carries its own row of either state. The instrumented step
(``with_metrics`` / ``DETPU_OBS=1``) returns the
:data:`~..utils.obs.STEP_METRIC_KEYS` dict beside the loss and state; at
world > 1 every rank gets every rank's metrics, gathered in rank order
into JAX's ``[world]`` and ``[world, n_tables]`` vectors by one
collective.

A layer built with a pipelined schedule (``DistributedEmbedding(...,
schedule="pipelined")`` or ``schedule=pipelined_schedule(K)``,
``parallel/schedule.py``) runs the K-microbatch pipelined step
(:func:`_pipelined_local_step`) in the train step and the loop: the
rank's batch splits into K microbatches whose id, output and cotangent
exchanges stay in flight (``torch.distributed``'s ``async_op``) under
the other microbatches' lookups and dense compute, on the one compute
stream, with the losses, dense gradients and per-width update streams
accumulated so the applied update is the serialized step's up to float
summation order. K = 1 runs the serialized step. The eval step stays
serialized.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from ..analysis import telemetry as tel
from ..ops.embedding_lookup import Ragged, SparseIds, row_to_split
from ..ops.grad_health import grad_health
from ..utils import obs
from . import apply as apply_mod
from . import bootstrap
from . import grads as grads_mod
from . import schedule as schedule_mod
from . import streaming as smod
from .dist_embedding import MpInputs


class HybridTrainState(NamedTuple):
    """All mutable model state. ``emb_params`` is the slab dict
    ``{"w<width>": [world, rows_cap, width]}`` and ``emb_opt_state`` its
    optimizer state (``SparseAdagrad``: one slab-shaped accumulator per
    width; ``SparseMomentum``: one trace; ``SparseAdam``: ``(mu, nu,
    count)``; updated in place with the slab); ``dense_params`` is the
    dense module (a ``DLRMDense``, a ``SyntheticDense``) and
    ``dense_opt_state`` its optimizer state; ``step``
    is a 0-d int32 tensor on the card. The optimizer fields stay ``None``
    for a serving-only state."""
    emb_params: Any
    emb_opt_state: Any = None
    dense_params: Any = None
    dense_opt_state: Any = None
    step: Any = None


def _table_sentinels(de, health: torch.Tensor, lr) -> dict:
    """The three per-table health sentinels (JAX ``_table_sentinels``),
    each ``[1, n_tables]``, folded from K21's per-input ``health [3,
    n_inputs]`` (sum of squares, max |g|, non-finite count of each
    embedding cotangent) through ``input_table_map``: per table the sum
    of its inputs' sums and counts and the max of their maxima (NaN
    propagates); a table with no input gets a real 0. The update bound
    is ``|lr| / world * max |g|``, the ``1/world`` pre-scale of the
    sparse apply."""
    tmap = de.strategy.input_table_map
    n_tables = len(de.strategy.global_configs)
    idx = _table_index(de, health.device)
    zero = torch.zeros((3, 1), dtype=health.dtype, device=health.device)
    per = torch.cat([health[:, :len(tmap)], zero], dim=1)[:, idx]
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=health.device)
    scale = (lr_t / de.world_size).abs()
    return {
        "table_grad_norm": torch.sqrt(per[0].sum(dim=1)).reshape(
            1, n_tables),
        "table_update_maxabs": (scale * per[1].amax(dim=1)).reshape(
            1, n_tables),
        "table_nonfinite": per[2].sum(dim=1).reshape(1, n_tables),
    }


def _table_index(de, device) -> torch.Tensor:
    """``[n_tables, k]`` int64: each table's inputs (in input order),
    padded with ``n_inputs`` (the zero column), cached per layer and
    device."""
    key = ("table_index", str(device))
    idx = de._meta_cache.get(key)
    if idx is None:
        tmap = de.strategy.input_table_map
        n_tables = len(de.strategy.global_configs)
        mine = [[i for i, t in enumerate(tmap) if t == tt]
                for tt in range(n_tables)]
        k = max([len(m) for m in mine] + [1])
        idx = torch.as_tensor([m + [len(tmap)] * (k - len(m)) for m in mine],
                              dtype=torch.int64, device=device)
        de._meta_cache[key] = idx
    return idx


def _finish_metrics(de, metrics, health, n_out, loss, ok, state, sstats,
                    lr):
    """The instrumented step's metrics beyond ``step_metrics`` (JAX
    ``_finish_metrics``): the sentinels, both norms (square roots of
    K21's sums), the loss, ``skipped_steps`` (``1 - ok``) and ``step``
    (the count at the start of the step), and a streaming step's
    guard-gated ``stream_*`` counts."""
    metrics.update(_table_sentinels(de, health[:, :n_out], lr))
    metrics["emb_grad_norm"] = torch.sqrt(health[0, :n_out].sum()).reshape(1)
    metrics["dense_grad_norm"] = torch.sqrt(
        health[0, n_out:].sum()).reshape(1)
    metrics["loss"] = loss.float().reshape(1)
    dev = loss.device
    metrics["skipped_steps"] = (
        (1 - ok.to(torch.int32)).reshape(1) if ok is not None
        else torch.zeros((1,), dtype=torch.int32, device=dev))
    metrics["step"] = state.step.to(torch.int32).reshape(1).clone()
    if sstats is not None:
        for k, v in sstats.items():
            metrics[f"stream_{k}"] = v
    return metrics


def _check_mesh(de, mesh):
    """``mesh`` (the JAX step's mesh argument) is the layer's process
    group or ``None``."""
    if mesh is not None and mesh is not de.process_group:
        raise ValueError(
            "mesh must be the layer's process group (or None): the ranks "
            "exchange over DistributedEmbedding(process_group=...)")


def _gather_metrics(de, metrics) -> dict:
    """Every rank's metrics in rank order on every rank (JAX's
    ``out_specs=P(axis)``): a ``[1]`` entry becomes ``[world]``, a ``[1,
    n_tables]`` one ``[world, n_tables]``. ONE all-gather of one float32
    buffer; the int32 entries travel as their bits. Stays on the card."""
    keys = list(metrics)
    flat = torch.cat([metrics[k].reshape(-1).view(torch.float32)
                      for k in keys])
    rows = bootstrap.all_gather(flat, de.process_group, de.world_size)
    out, pos = {}, 0
    for k in keys:
        v = metrics[k]
        n = v.numel()
        out[k] = rows[:, pos:pos + n].contiguous().view(v.dtype).reshape(
            (de.world_size,) + tuple(v.shape[1:]))
        pos += n
    return out


def _apply_dense_and_assemble(state, dense_grads, dense_tx, ok, nan_guard):
    """The step's epilogue: the dense optimizer update with the
    non-finite guard's select fused, and the new state.

    ``dense_tx.update_`` (K22) updates the dense parameters and every
    tensor of the dense optimizer state IN PLACE; under the guard it
    writes nothing on a skipped step and advances the optimizer's counts
    by ``ok``, so a skipped step leaves them bitwise unchanged. The
    slabs need no select: their scatter already routed every id to the
    dropped-row sentinel. ``step`` advances either way. The state keeps
    its tensors: a caller that needs the old dense state clones it
    first."""
    dense_tx.update_(dense_grads, state.dense_opt_state,
                     list(state.dense_params.parameters()),
                     ok=ok if nan_guard else None)
    return HybridTrainState(
        emb_params=state.emb_params, emb_opt_state=state.emb_opt_state,
        dense_params=state.dense_params,
        dense_opt_state=state.dense_opt_state, step=state.step + 1)


def _small_leaves(de, emb_opt_state) -> List[torch.Tensor]:
    """The tensor leaves of the embedding-optimizer state that are not
    slab-shaped (Adam's step counts): the guard selects these, as the
    JAX step does; slab-shaped state is protected by the sentinel."""
    slab_shapes = {(1, r, w) for w, r in de.rows_cap.items()}
    return [t for t in pytree.tree_leaves(emb_opt_state)
            if isinstance(t, torch.Tensor)
            and tuple(t.shape) not in slab_shapes]


def _hybrid_local_step(de, loss_fn, dense_tx, emb_optimizer, lr_schedule,
                       state, cat_inputs, batch, nan_guard=False,
                       telemetry_cfg=None, telem=None, streaming_cfg=None,
                       sstate=None, with_metrics=False):
    """One hybrid step (shared by :func:`make_hybrid_train_step` and
    :func:`make_hybrid_train_loop`): embedding forward, one backward
    giving the dense gradients and the embedding-output cotangents,
    both optimizer updates, step counter bump. Returns ``(loss, state)``,
    or ``(loss, state, metrics)`` with ``with_metrics``.

    With ``telemetry_cfg``, the forward's routed ids fold into ``telem``
    (this rank's telemetry state, in place) right after the forward,
    whatever the guard decides: as in the JAX step, a skipped step still
    counts the ids it routed.

    With ``streaming_cfg``, the forward remaps the streaming tables'
    external ids through the slot map of ``sstate`` (this rank's
    streaming state) and stages the admissions; they commit, in place,
    after the sparse apply and under the guard's verdict
    (:func:`~.streaming.commit`): a skipped step leaves the slot map,
    sketch, counters, slabs and moments bitwise unchanged, and an
    evictee's last update is dropped with its slot.

    ``nan_guard=True`` checks the loss and both gradient energies for
    NaN/Inf ON THE CARD and, on a non-finite verdict, skips the dense
    and sparse updates with parameters and optimizer state bitwise
    unchanged (the slab-shaped state through the sentinel, the small
    leaves, Adam's counts included, through a select); the step counter
    still advances and the returned loss is the true (non-finite)
    value. The verdict is never read on the host.

    At world > 1 the loss, the guard's probe and the dense gradients are
    means over the ranks (one all-reduce), so the returned loss is the
    global batch's and every rank takes the same verdict; the sparse
    apply scales the local cotangents by ``1/world``. K21 then runs
    twice, when the guard or the metrics need it: once on the local
    cotangents (the probe, the sentinels and ``emb_grad_norm``) and once
    on the averaged dense gradients (the guard's dense energy and
    ``dense_grad_norm``); the metrics of every rank are gathered after.
    """
    K = _microbatch_count(de)
    if K > 1:
        return _pipelined_local_step(
            de, loss_fn, dense_tx, emb_optimizer, lr_schedule, state,
            cat_inputs, batch, K, nan_guard=nan_guard,
            telemetry_cfg=telemetry_cfg, telem=telem,
            streaming_cfg=streaming_cfg, sstate=sstate,
            with_metrics=with_metrics)
    pending = None
    with torch.no_grad():
        if streaming_cfg is not None:
            outs, res, pending = de.forward_with_residuals(
                state.emb_params, cat_inputs,
                streaming=(streaming_cfg, smod.local_state(sstate)))
        else:
            outs, res = de.forward_with_residuals(state.emb_params,
                                                  cat_inputs)
        if telemetry_cfg is not None:
            with obs.scope("telemetry"):
                de.update_telemetry(tel.local_state(telem), res,
                                    telemetry_cfg)
    loss, dense_grads, out_grads = _dense_forward_backward(
        state, loss_fn, outs, batch)
    loss, dense_grads, health, ok = _guard(
        de, loss, dense_grads, list(out_grads), nan_guard, with_metrics)
    lr = lr_schedule(state.step) if callable(lr_schedule) else lr_schedule
    return _apply_and_finish(
        de, state, dense_tx, emb_optimizer, lambda: de.sparse_apply_gradients(
            state.emb_params, state.emb_opt_state, res, list(out_grads),
            emb_optimizer, lr, enable=ok),
        dense_grads, loss, ok, nan_guard, streaming_cfg, pending, sstate,
        with_metrics, health, len(out_grads), lr, [res],
        out_grads[0].dtype if out_grads else None)


def _dense_forward_backward(state, loss_fn, outs, batch, tag: str = ""):
    """The dense model's forward and one backward (the
    ``dense_forward_backward{tag}`` phase): the loss (detached), the dense
    gradients and the embedding outputs' cotangents. The outputs enter
    as detached leaves: no graph edge reaches a slab."""
    outs = [o.detach().requires_grad_() for o in outs]
    params = list(state.dense_params.parameters())
    with obs.scope(schedule_mod.PHASE_DENSE + tag), torch.enable_grad():
        loss = loss_fn(state.dense_params, outs, batch)
        grads = torch.autograd.grad(loss, params + outs)
    return loss.detach(), list(grads[:len(params)]), grads[len(params):]


def _guard(de, loss, dense_grads, out_grads, nan_guard, with_metrics):
    """K21 and, at world > 1, the one all-reduce: returns ``(loss, dense
    gradients, health, ok)``, the loss and dense gradients averaged over
    the ranks, ``health`` K21's ``[3, n_out + n_dense]`` (``None`` when
    neither the guard nor the metrics ask) and ``ok`` the guard's verdict
    (``None`` without the guard).

    The guard reads the energies K21 gives: 0 * (embedding-cotangent
    energy) is 0 when finite and NaN otherwise. At world > 1 the JAX
    step's pmeans of the loss, the dense gradients and that probe are
    ONE all-reduce (``dense_all_reduce``), so a NaN on any rank reaches
    every rank and all skip together; K21 runs on the local cotangents
    before it and on the averaged dense gradients after it."""
    n_out = len(out_grads)
    health = probe = dense_sq = None
    if de.world_size > 1:
        if nan_guard or with_metrics:
            health = grad_health(out_grads)
            probe = 0.0 * health[0].sum()
        extra = [loss] + ([probe] if nan_guard else [])
        with obs.scope("dense_all_reduce"):
            means = grads_mod.mean_flat(extra + dense_grads,
                                        de.process_group, de.world_size)
        loss, dense_grads = means[0], means[len(extra):]
        if nan_guard:
            probe = means[1]
        if health is not None:
            if dense_grads:  # [3, n_out + n_dense], as at world 1
                health = torch.cat([health, grad_health(dense_grads)], 1)
            dense_sq = health[0, n_out:].sum()
    elif nan_guard or with_metrics:
        health = grad_health(out_grads + dense_grads)
        probe = 0.0 * health[0, :n_out].sum()
        dense_sq = health[0, n_out:].sum()
    ok = None
    if nan_guard:
        ok = (torch.isfinite(loss.float()) & torch.isfinite(dense_sq)
              & torch.isfinite(probe))
    return loss, dense_grads, health, ok


def _apply_and_finish(de, state, dense_tx, emb_optimizer, sparse_apply,
                      dense_grads, loss, ok, nan_guard, streaming_cfg,
                      pending, sstate, with_metrics, health, n_out, lr,
                      res_list, out_dtype):
    """The step from its sparse apply on, shared by the serialized and the
    pipelined step: ``sparse_apply()`` (the per-slab scatters, in place)
    with the guard's select of the small optimizer leaves around it, the
    streaming commit, the dense update (K22) and the metrics (each
    residual's ``step_metrics`` summed, ``out_pad_frac`` kept from the
    first, as JAX sums its microbatches')."""
    small = _small_leaves(de, state.emb_opt_state) if nan_guard else []
    before = [t.clone() for t in small]
    sparse_apply()
    with torch.no_grad():
        for t, old in zip(small, before):
            # the sparse apply advanced it in place: keep the old value
            # on a skipped step (JAX's where-select of non-slab leaves)
            t.copy_(torch.where(ok, t, old))
        sstats = None
        if streaming_cfg is not None:
            with obs.scope("streaming_commit"):
                sstats = smod.commit(
                    de, de.local_view(state.emb_params), pending,
                    smod.local_state(sstate), enable=ok,
                    opt_state=de.local_view(state.emb_opt_state),
                    optimizer=emb_optimizer)
    with obs.scope("dense_update"):
        new_state = _apply_dense_and_assemble(state, dense_grads, dense_tx,
                                              ok, nan_guard)
    if not with_metrics:
        return loss, new_state
    metrics = None
    for res in res_list:
        m = de.step_metrics(res, out_dtype=out_dtype)
        if metrics is None:
            metrics = m
            continue
        for k in m:
            if k != "out_pad_frac":  # a plan tally, equal per microbatch
                metrics[k] = metrics[k] + m[k]
    metrics = _finish_metrics(de, metrics, health, n_out, loss, ok, state,
                              sstats, lr)
    if de.world_size > 1:
        metrics = _gather_metrics(de, metrics)
    return loss, new_state, metrics


def _microbatch_count(de) -> int:
    """The schedule's microbatch count the step builders split by (1: the
    serialized step)."""
    return int(getattr(getattr(de, "schedule", None), "microbatches", 1)
               or 1)


def _microbatch_inputs(cat_inputs, batch, K: int):
    """Split one rank's batch into K microbatches along the leading batch
    dimension: ``[(cat_inputs_k, batch_k), ...]`` (JAX
    ``_microbatch_inputs``).

    Dense categorical inputs and every tensor of ``batch`` take rows
    ``[k*b/K, (k+1)*b/K)`` (views). A
    :class:`~..ops.embedding_lookup.Ragged` keeps its FULL static
    capacity a microbatch (a skewed microbatch may hold most of the ids):
    its values (and weights) are gathered from the CSR offset of the
    microbatch's first row, the index clipped to ``capacity - 1`` (JAX's
    ``mode="clip"``), and its row splits rebased to 0; the offset stays
    on the device (no host read). A :class:`~..ops.embedding_lookup.
    SparseIds` goes to CSR first (``row_to_split``, K10 on the card).
    ``b % K != 0`` raises ``ValueError`` (unequal microbatches would break
    the exact mean-of-means loss accumulation)."""

    def norm(x):
        if isinstance(x, SparseIds):
            values = torch.as_tensor(x.values)
            return Ragged(values=values,
                          row_splits=row_to_split(
                              torch.as_tensor(x.indices).to(values.device),
                              x.dense_shape[0], dtype=values.dtype),
                          weights=x.weights)
        if isinstance(x, Ragged):
            return Ragged(values=torch.as_tensor(x.values),
                          row_splits=torch.as_tensor(x.row_splits),
                          weights=(None if x.weights is None
                                   else torch.as_tensor(x.weights)))
        return torch.as_tensor(x)

    cats = [norm(c) for c in cat_inputs]

    def rows_of(x):
        return (x.row_splits.shape[0] - 1 if isinstance(x, Ragged)
                else x.shape[0])

    if cats:
        b = rows_of(cats[0])
    else:
        b = pytree.tree_leaves(batch)[0].shape[0]
    if b % K:
        raise ValueError(
            f"pipelined step: per-rank batch {b} does not divide into {K} "
            "microbatches; pick K | batch (DETPU_MICROBATCH / the "
            "pipelined_schedule argument)")
    mbb = b // K

    def slice_cat(x, k):
        if isinstance(x, Ragged):
            splits = x.row_splits
            lo = splits[k * mbb]
            sub = splits[k * mbb:(k + 1) * mbb + 1] - lo
            cap = x.values.shape[0]
            idx = (lo + torch.arange(cap, dtype=splits.dtype,
                                     device=splits.device)).clamp_(
                0, cap - 1)
            vals = x.values.index_select(0, idx)
            wts = (None if x.weights is None
                   else x.weights.index_select(0, idx))
            return Ragged(values=vals, row_splits=sub, weights=wts)
        return x[k * mbb:(k + 1) * mbb]

    out = []
    for k in range(K):
        batch_k = pytree.tree_map(
            lambda a, k=k: a[k * mbb:(k + 1) * mbb]
            if isinstance(a, torch.Tensor) else a, batch)
        out.append(([slice_cat(c, k) for c in cats], batch_k))
    return out


def _pipelined_local_step(de, loss_fn, dense_tx, emb_optimizer, lr_schedule,
                          state, cat_inputs, batch, K, nan_guard=False,
                          telemetry_cfg=None, telem=None, streaming_cfg=None,
                          sstate=None, with_metrics=False):
    """The K-microbatch pipelined hybrid step (JAX
    ``_pipelined_local_step``; run when ``de.schedule`` has ``microbatches
    > 1``, with the serialized step's arguments and results).

    JAX leaves the overlap to XLA's scheduler; eager PyTorch issues it in
    this order, on one compute stream, every rank issuing its collectives
    in the same order:

    1. every microbatch's send blocks (K19), its id exchange started;
    2. per microbatch: wait for its ids, the read-only streaming serve
       (K16), the lookups (K1, K8 + K10), the lookup rows (K20), its
       output exchange started;
    3. per microbatch: wait for its outputs, unpack them (K20), its dense
       forward/backward, its cotangents packed (K20) and their exchange
       started;
    4. with the cotangent exchanges in flight: the telemetry fold over
       every microbatch's residuals (one K13 + K14 pool + K15 a width),
       the one admission-staging pass (:meth:`~.dist_embedding.
       DistributedEmbedding.streaming_stage`, one K16 update a width),
       the accumulated loss and dense gradients, the guard's probe on the
       concatenated cotangents (K21) and the one all-reduce;
    5. per microbatch: wait for its cotangents and rebuild its streams
       (K9, K10); then ONE apply a width slab over the streams
       concatenated microbatch-major, scaled by ``1/(world K)``, the
       commit (K17), the dense update (K22) and the metrics.

    Numerics are JAX's, in JAX's order: ``loss = sum(losses[1:],
    losses[0]) * (1/K)``; the dense gradients summed the same way, times
    1/K, then averaged over the ranks; the concatenated cotangents (each
    input's over the microbatches, times 1/K) feed the probe, the
    sentinels and the norms. Like JAX's, it relies on ``loss_fn`` being an
    unweighted mean over the rank's batch (then each microbatch's
    cotangents are K times the full batch's, and the 1/K undoes it
    exactly for a power-of-two K). The step metrics sum over the
    microbatches (``out_pad_frac`` excepted). ``dp_input=False`` raises
    ``NotImplementedError``, as JAX does: model-parallel input has no id
    exchange to hide."""
    if not de.dp_input:
        raise NotImplementedError(
            "pipelined schedules need dp inputs: mp-input mode has no id "
            "exchange to hide (use dp_input=True or a serialized "
            "schedule)")
    world = de.world_size
    mbs = _microbatch_inputs(cat_inputs, batch, K)
    tags = [schedule_mod.microbatch_tag(k) for k in range(K)]
    serve = (None if streaming_cfg is None else
             (streaming_cfg, smod.local_state(sstate), "serve"))
    with torch.no_grad():
        fwds = [de._forward_begin(state.emb_params, cats_k, serve, tag,
                                  in_flight=True)
                for (cats_k, _), tag in zip(mbs, tags)]
        for f in fwds:
            de._forward_lookup(f)
    losses, dense_list, out_list, res_list, serve_list, cots = (
        [], [], [], [], [], [])
    fallback = next(iter(state.emb_params.values())).dtype
    for (_, batch_k), f, tag in zip(mbs, fwds, tags):
        with torch.no_grad():
            fwd = de._forward_finish(f)
        outs, res = fwd[0], fwd[1]
        if serve is not None:
            serve_list.append(fwd[2])
        loss_k, dgrads_k, ograds_k = _dense_forward_backward(
            state, loss_fn, outs, batch_k, tag)
        with torch.no_grad():
            cots.append(apply_mod.cotangent_exchange(
                de, res, list(ograds_k), fallback_dtype=fallback, tag=tag,
                in_flight=True))
        losses.append(loss_k)
        dense_list.append(dgrads_k)
        out_list.append(ograds_k)
        res_list.append(res)
    del fwds

    with torch.no_grad():
        if telemetry_cfg is not None:
            with obs.scope("telemetry"):
                de.update_telemetry(tel.local_state(telem), res_list,
                                    telemetry_cfg)
        pending = None
        if serve is not None:
            pending = de.streaming_stage(serve_list, streaming_cfg,
                                         smod.local_state(sstate))
        inv_k = 1.0 / K
        loss = sum(losses[1:], losses[0]) * inv_k
        dense_grads = [sum(gs[1:], gs[0]) * inv_k
                       for gs in zip(*dense_list)]
        cat_grads = [torch.cat([og[i] for og in out_list], 0) * inv_k
                     for i in range(len(out_list[0]))]
        loss, dense_grads, health, ok = _guard(
            de, loss, dense_grads, cat_grads, nan_guard, with_metrics)
    lr = lr_schedule(state.step) if callable(lr_schedule) else lr_schedule

    def sparse_apply():
        # each microbatch's cotangents rebuilt into its streams (K9, K10),
        # merged microbatch-major into ONE scatter a width slab
        per_width = {}
        with torch.no_grad():
            for cot in cots:
                for key, tris in apply_mod.cotangent_streams_finish(
                        de, cot).items():
                    per_width.setdefault(key, []).extend(tris)
            opt_state = state.emb_opt_state
            apply_mod.apply_width_streams(
                de, de.local_view(state.emb_params),
                de.local_view(opt_state) if isinstance(opt_state, dict)
                else opt_state, per_width, emb_optimizer, lr,
                scale=1.0 / (world * K), enable=ok)

    return _apply_and_finish(
        de, state, dense_tx, emb_optimizer, sparse_apply, dense_grads, loss,
        ok, nan_guard, streaming_cfg, pending, sstate, with_metrics, health,
        len(cat_grads), lr, res_list,
        cat_grads[0].dtype if cat_grads else None)


def _with_aux_signature(core, tel_on: bool, dyn_on: bool):
    """Give ``core(state, cat_inputs, batch, aux_tuple)`` the explicit
    positional signature its aux combination implies (aux order:
    telemetry, then streaming), as the JAX package does."""
    if tel_on and dyn_on:
        def step(state, cat_inputs, batch, telem, stream):
            return core(state, cat_inputs, batch, (telem, stream))
    elif tel_on:
        def step(state, cat_inputs, batch, telem):
            return core(state, cat_inputs, batch, (telem,))
    elif dyn_on:
        def step(state, cat_inputs, batch, stream):
            return core(state, cat_inputs, batch, (stream,))
    else:
        def step(state, cat_inputs, batch):
            return core(state, cat_inputs, batch, ())
    return step


def make_hybrid_train_step(de, loss_fn: Callable, dense_tx, emb_optimizer,
                           mesh=None, lr_schedule=1.0,
                           with_metrics: Optional[bool] = None,
                           nan_guard: Optional[bool] = None,
                           telemetry=None, dynamic=None):
    """Build ``step(state, cat_inputs, batch) -> (loss, state)``; with
    telemetry and/or streaming, ``step(state, cat_inputs, batch[,
    telem][, stream]) -> (loss, state[, telem][, stream])``.

    Args:
      de: the embedding layer; at world > 1 every rank of its group
        calls the step, in the same order, with its rows of the batch
        (``cat_inputs`` an :class:`~.dist_embedding.MpInputs` batch for a
        ``dp_input=False`` layer).
      loss_fn: ``loss_fn(dense_params, emb_outputs, batch) -> scalar``
        mean loss over the batch.
      dense_tx: the dense optimizer (``init(params)``,
        ``update(grads, state, params) -> (updates, state)``;
        :class:`~.optimizers.SGD`, :class:`~.optimizers.Adagrad`,
        :class:`~.optimizers.Adam`).
      emb_optimizer: :class:`~.optimizers.SparseSGD`,
        :class:`~.optimizers.SparseAdagrad`,
        :class:`~.optimizers.SparseMomentum` or
        :class:`~.optimizers.SparseAdam`.
      lr_schedule: the embedding learning rate, a constant or a
        ``step -> lr`` callable (called with the 0-d step tensor; it
        returns a 0-d float32 tensor on the card).
      nan_guard: build the step with the on-card non-finite guard;
        ``None`` follows ``DETPU_NANGUARD`` (default on).
      telemetry: carry access telemetry (``analysis/telemetry.py``)
        through the step: ``None``/``False`` off, ``True`` the
        ``DETPU_TELEMETRY_*`` geometry, or a ``TelemetryConfig``. An
        explicit opt-in, never an env default: it changes the call
        arity. The telemetry state (``init_telemetry``) is the fourth
        argument and a result, updated in place; the parameter and
        optimizer math is the same as without it.
      dynamic: streaming vocabularies (``parallel/streaming.py``), the
        same explicit opt-in: ``None``/``False`` off, ``True`` the
        ``DETPU_ADMIT_*`` policy, or a ``StreamingConfig``. The streaming
        state (``init_streaming``) is the last argument and the last
        result (after the telemetry state when both ride), updated in
        place. A step built without a streaming table raises
        ``ValueError`` when called.
      mesh: ``None`` or the layer's process group (the JAX step's mesh).
      with_metrics: instrument the step: it then returns ``(loss, state,
        metrics[, telem][, stream])``, ``metrics`` the
        :data:`~..utils.obs.STEP_METRIC_KEYS` dict (with a streaming
        step, :data:`~..utils.obs.STREAMING_METRIC_KEYS` too) of
        ``[world]`` tensors on the card (every rank's, in rank order),
        the ``table_*`` sentinels ``[world, n_tables]``. Nothing is read
        on the host. ``None`` follows ``DETPU_OBS``.

    The state's slabs and dense parameters are updated in place (the
    JAX step donates them); the returned state holds the same tensors.
    """
    if with_metrics is None:
        with_metrics = obs.metrics_enabled()
    if nan_guard is None:
        nan_guard = obs.nanguard_enabled()
    tel_cfg = tel.resolve_config(telemetry)
    dyn_cfg = smod.resolve_config(dynamic)
    _check_mesh(de, mesh)

    def core(state: HybridTrainState, cat_inputs, batch, aux):
        telem = aux[0] if tel_cfg is not None else None
        sstate = aux[-1] if dyn_cfg is not None else None
        out = _hybrid_local_step(
            de, loss_fn, dense_tx, emb_optimizer, lr_schedule, state,
            cat_inputs, batch, nan_guard=nan_guard, telemetry_cfg=tel_cfg,
            telem=telem, streaming_cfg=dyn_cfg, sstate=sstate,
            with_metrics=with_metrics)
        return out + tuple(aux)

    return _with_aux_signature(core, tel_cfg is not None,
                               dyn_cfg is not None)


def _index(tree, k: int):
    """The ``k``-th leading slice of every tensor in a batch structure
    (a :class:`Ragged` or :class:`SparseIds` stack carries its leading
    axis on every field; ``dense_shape`` is per step)."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    if isinstance(tree, MpInputs):
        return MpInputs(packed=tree.packed[k], hots=tree.hots,
                        local_batch=tree.local_batch)
    if isinstance(tree, (Ragged, SparseIds)):
        w = None if tree.weights is None else tree.weights[k]
        if isinstance(tree, Ragged):
            return Ragged(values=tree.values[k],
                          row_splits=tree.row_splits[k], weights=w)
        return SparseIds(indices=tree.indices[k], values=tree.values[k],
                         dense_shape=tree.dense_shape, weights=w)
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, k) for v in tree)
    raise TypeError(f"batch leaves must be tensors, got {type(tree)}")


def make_hybrid_train_loop(de, loss_fn: Callable, dense_tx, emb_optimizer,
                           mesh=None, lr_schedule=1.0,
                           with_metrics: Optional[bool] = None,
                           nan_guard: Optional[bool] = None,
                           telemetry=None, dynamic=None):
    """Multi-step loop: ``loop(state, cat_stacks, batch_stacks) ->
    (losses [K], state)`` (with telemetry and/or streaming ``loop(state,
    cat_stacks, batch_stacks[, telem][, stream]) -> (losses, state[,
    telem][, stream])``, one such state carried through every step) runs
    K steps of
    :func:`make_hybrid_train_step`
    over the leading axis of every input (each categorical input
    ``[K, batch, ...]``, or a :class:`Ragged` / :class:`SparseIds` whose
    fields all lead with ``K``; for a ``dp_input=False`` layer one
    :class:`~.dist_embedding.MpInputs` whose ``packed`` leads with ``K``;
    ``batch`` any structure of ``[K, ...]`` tensors). The JAX loop scans
    inside one compiled program (its ``unroll`` is a ``lax.scan`` knob,
    not taken here); this is a Python loop with the same per-step
    semantics, guard included.

    ``with_metrics`` (``None`` follows ``DETPU_OBS``) instruments every
    step: the loop then returns ``(losses, state, metrics[, telem][,
    stream])``, each metric stacked along a leading step axis (``[K,
    world]``; the sentinels ``[K, world, n_tables]``), as JAX's scan
    stacks them."""
    if with_metrics is None:
        with_metrics = obs.metrics_enabled()
    step = make_hybrid_train_step(
        de, loss_fn, dense_tx, emb_optimizer, mesh=mesh,
        lr_schedule=lr_schedule, with_metrics=with_metrics,
        nan_guard=nan_guard, telemetry=telemetry, dynamic=dynamic)

    def loop(state: HybridTrainState, cat_stacks, batch_stacks, *telem):
        mp = isinstance(cat_stacks, MpInputs)
        c0 = cat_stacks.packed if mp else cat_stacks[0]
        K = (c0.values if isinstance(c0, (Ragged, SparseIds))
             else c0).shape[0]
        losses: List[torch.Tensor] = []
        per_step = []
        for k in range(K):
            cats = (_index(cat_stacks, k) if mp
                    else [_index(c, k) for c in cat_stacks])
            out = step(state, cats, _index(batch_stacks, k), *telem)
            loss, state = out[:2]
            if with_metrics:
                per_step.append(out[2])
            telem = out[3:] if with_metrics else out[2:]
            losses.append(loss)
        head = (torch.stack(losses), state)
        if with_metrics:
            head += ({key: torch.stack([m[key] for m in per_step])
                      for key in per_step[0]},)
        return head + tuple(telem)

    return loop


def init_hybrid_state(de, emb_optimizer, dense_params, dense_tx,
                      generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.float32,
                      device="cuda") -> HybridTrainState:
    """Initialize all state: slabs from the tables' initializers (in
    place, see ``DistributedEmbedding.init``), both optimizer states
    (``emb_optimizer.init`` builds any slab-shaped state beside the slabs,
    on the same device), and ``step = 0`` on ``device``. At world > 1
    the dense parameters are overwritten with rank 0's (every rank must
    call), so the replicas start equal."""
    emb_params = de.init(generator, dtype=dtype, device=device)
    dev = next(iter(emb_params.values())).device
    if de.world_size > 1:
        grads_mod.broadcast_variables(list(dense_params.parameters()),
                                      False, de.process_group)
    return HybridTrainState(
        emb_params=emb_params,
        emb_opt_state=emb_optimizer.init(emb_params),
        dense_params=dense_params,
        dense_opt_state=dense_tx.init(list(dense_params.parameters())),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def make_hybrid_eval_step(de, pred_fn: Callable, mesh=None, dynamic=None):
    """Build ``eval_step(state, cat_inputs, batch) -> predictions``.

    ``pred_fn(dense_params, emb_outputs, batch)`` maps the embedding
    outputs to predictions. The step runs under ``torch.inference_mode``
    and PyTorch's eager dispatch (nothing to compile).

    ``dynamic`` (streaming vocabularies, resolved as the train step's):
    the step then takes the carried streaming state as a fourth argument,
    ``eval_step(state, cat_inputs, batch, stream)``, and serves ids
    through the slot map READ-ONLY: admitted ids read their slots,
    everything else its shared bucket; nothing is admitted and the state
    is never written, so interleaved eval leaves the training trajectory
    alone. At world > 1 every rank calls with its rows of the batch (and
    its streaming state) and gets ITS predictions (``bootstrap.to_host``
    gathers them);
    ``mesh`` is ``None`` or the layer's process group. The JAX version's
    ``donate_inputs`` is an XLA buffer-reuse knob with no counterpart
    here.
    """
    dyn_cfg = smod.resolve_config(dynamic)
    _check_mesh(de, mesh)

    if dyn_cfg is None:
        def eval_step(state: HybridTrainState, cat_inputs, batch):
            with torch.inference_mode():
                outs = de(state.emb_params, cat_inputs)
                return pred_fn(state.dense_params, outs, batch)
        return eval_step

    def eval_step_dynamic(state: HybridTrainState, cat_inputs, batch,
                          stream):
        with torch.inference_mode():
            outs, _ = de.forward_with_residuals(
                state.emb_params, cat_inputs,
                streaming=(dyn_cfg, smod.local_state(stream), False))
            return pred_fn(state.dense_params, outs, batch)

    return eval_step_dynamic
