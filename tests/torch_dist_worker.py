"""Rank side of the world-8 ``torch.distributed`` (gloo) parity tests of
the port, and the parent's handle on the ranks.

:class:`RankGroup` spawns one process per rank (``spawn`` start method,
a ``file://`` store under the test's temporary directory, one thread
each) that joins one gloo group and then serves named cases from a queue
until it is closed, so a test file pays for the group once. Each case
builds the port's objects from numpy (tables, ids, dense parameters),
runs them on this rank's rows of the batch and sends numpy back; the
parent holds the results against the JAX package on its 8-device mesh.

This module imports torch, numpy and the port only: the ranks never
load JAX.
"""

import logging
import os
import queue
import traceback

import torch

#: seconds a case may take before the parent gives up on the group
CASE_TIMEOUT_S = 240


# ------------------------------------------------------------ rank side


def _dtype(name):
    return None if name is None else getattr(torch, name)


def _layer(spec, world):
    from distributed_embeddings_torch.parallel import DistributedEmbedding

    return DistributedEmbedding(
        spec["configs"], world_size=world,
        strategy=spec.get("strategy", "basic"),
        column_slice_threshold=spec.get("column_slice_threshold"),
        row_slice=spec.get("row_slice"),
        dp_input=spec.get("dp_input", True),
        masked_reads=spec.get("masked_reads", False),
        input_table_map=spec.get("input_table_map"),
        compute_dtype=_dtype(spec.get("compute_dtype")))


def _inputs(spec_inputs, rank, world):
    """This rank's inputs: a global dense array gives its rows; a
    ``("ragged", values, splits, weights)`` entry holds one static-
    capacity CSR per rank already."""
    from distributed_embeddings_torch.ops.embedding_lookup import Ragged
    from distributed_embeddings_torch.parallel import bootstrap

    out = []
    for x in spec_inputs:
        if isinstance(x, tuple) and x[0] == "ragged":
            _, vals, splits, wts = x
            out.append(Ragged(
                values=torch.from_numpy(vals[rank].copy()),
                row_splits=torch.from_numpy(splits[rank].copy()),
                weights=(None if wts is None
                         else torch.from_numpy(wts[rank].copy()))))
        else:
            out.append(bootstrap.shard_batch(torch.from_numpy(x.copy()),
                                             rank, world))
    return out


def global_inputs(spec_inputs, world):
    """The global batch of a spec's inputs for ``pack_mp_inputs``, with
    each input's ``hots`` entry: a dense array as it is; a ragged entry's
    per-rank CSRs as one global :class:`Ragged` packed at the per-rank
    capacity, so the model-parallel blocks equal the ones the
    data-parallel id exchange builds."""
    import numpy as np

    from distributed_embeddings_torch.ops.embedding_lookup import Ragged

    out, hots = [], []
    for x in spec_inputs:
        if not (isinstance(x, tuple) and x[0] == "ragged"):
            out.append(x)
            hots.append(x.shape[1] if x.ndim == 2 else 1)
            continue
        _, vals, splits, wts = x
        cap = len(vals[0])
        n = [int(s[-1]) for s in splits]
        off = np.concatenate([[0], np.cumsum(n)])
        gs = np.concatenate([splits[0][:1]] + [s[1:] + o for s, o in
                                                zip(splits, off)])
        gv = np.zeros(cap * world, vals[0].dtype)
        gv[:off[-1]] = np.concatenate([v[:k] for v, k in zip(vals, n)])
        gw = None
        if wts is not None:
            gw = np.zeros(cap * world, np.float32)
            gw[:off[-1]] = np.concatenate([w[:k] for w, k in zip(wts, n)])
        out.append(Ragged(values=torch.from_numpy(gv),
                          row_splits=torch.from_numpy(gs.astype(
                              splits[0].dtype)),
                          weights=None if gw is None
                          else torch.from_numpy(gw)))
        hots.append(("r" if wts is None else "rw", cap))
    return out, hots


def _feed(de, spec_inputs, rank, world):
    """This rank's embedding input: its rows (data-parallel input) or its
    block of the packed global batch (``dp_input=False``)."""
    if de.dp_input:
        return _inputs(spec_inputs, rank, world)
    inputs, hots = global_inputs(spec_inputs, world)
    return de.pack_mp_inputs(inputs, hots=hots, device="cpu")


def _control_rbase(de, rank, spec):
    """The control that drops the row bases on ``spec["drop_rbase"]``'s
    rank: its row-sliced slots read their table's first rows."""
    if spec.get("drop_rbase") != rank:
        return
    real = de._plan_rbase

    def zeros(plan, gi, device, reps=1):
        rb = real(plan, gi, device, reps)
        return None if rb is None else torch.zeros_like(rb)

    de._plan_rbase = zeros


def case_forward(rank, world, spec):
    """Forward on this rank's rows (or its model-parallel block): the
    received id block, the outputs and (rank 0) the tables gathered back
    over the group."""
    de = _layer(spec, world)
    _control_rbase(de, rank, spec)
    params = de.set_weights(spec["tables"], device="cpu")
    outs, res = de.forward_with_residuals(
        params, _feed(de, spec["inputs"], rank, world))
    tables = de.get_weights(params, all_ranks=False)
    return {"ids": res[1].numpy(),
            "outs": [o.float().numpy() for o in outs],
            "tables": tables,
            "slabs": {k: v[0].float().numpy() for k, v in params.items()}}


def _quadratic_loss(outs):
    return sum((o.float() ** 2).mean() for o in outs)


def case_train(rank, world, spec):
    """``spec["steps"]`` sparse steps of ``sum(mean(out ** 2))`` (each
    step's inputs global, this rank takes its rows): the local losses,
    and this rank's slabs and optimizer state at the end."""
    from distributed_embeddings_torch.parallel import (SparseAdagrad,
                                                       SparseSGD)

    de = _layer(spec, world)
    _control_rbase(de, rank, spec)
    params = de.set_weights(spec["tables"], device="cpu")
    opt = (SparseAdagrad(initial_accumulator_value=0.1)
           if spec["optimizer"] == "adagrad" else SparseSGD())
    opt_state = opt.init(params)
    losses = []
    for step_inputs in spec["steps"]:
        with torch.no_grad():
            outs, res = de.forward_with_residuals(
                params, _feed(de, step_inputs, rank, world))
        outs = [o.detach().requires_grad_() for o in outs]
        loss = _quadratic_loss(outs)
        grads = torch.autograd.grad(loss, outs)
        de.sparse_apply_gradients(params, opt_state, res, list(grads), opt,
                                  spec["lr"])
        losses.append(float(loss))
    acc = ({k: v[0].numpy() for k, v in opt_state.items()}
           if spec["optimizer"] == "adagrad" else None)
    return {"losses": losses, "acc": acc, "ids": res[1].numpy(),
            "slabs": {k: v[0].float().numpy() for k, v in params.items()},
            "tables": de.get_weights(params, all_ranks=False)}


def _dlrm_control(name):
    """Patches that break the world > 1 step on purpose (the parity
    test's controls must fail its bounds); returns ``(module, attr,
    replacement)`` or ``None``.

    * ``"dense_summed"``: the dense gradients summed over the ranks, not
      averaged (the guarded step's ``mean_flat`` list is ``[loss, probe,
      *dense grads]``).
    * ``"sparse_skipped"``: the sparse apply leaves the slabs as they
      are."""
    from distributed_embeddings_torch.parallel import apply, grads

    if name is None:
        return None
    if name == "dense_summed":
        real = grads.mean_flat

        def summed(tensors, group, world_size):
            out = real(tensors, group, world_size)
            return out[:2] + [t * world_size for t in out[2:]]

        return grads, "mean_flat", summed
    if name == "sparse_skipped":
        return apply, "apply_width_streams", (
            lambda de, params, opt_state, *a, **kw: (params, opt_state))
    raise ValueError(f"unknown control {name!r}")


def case_dlrm(rank, world, spec):
    """The hybrid DLRM train step at world ``world`` from a JAX state
    (tables, flax dense params): ``spec["steps"]`` steps, then one batch
    with a NaN on ``spec["nan_rank"]``'s rows, then eval predictions.
    Then, for each of ``spec["controls"]`` (:func:`_dlrm_control`), the
    same steps from the same state with the step broken that way: their
    losses, slabs and dense parameters under ``"controls"``."""
    from distributed_embeddings_torch.models import (DLRMConfig, DLRMDense,
                                                     bce_with_logits)
    from distributed_embeddings_torch.parallel import (
        SGD, SparseSGD, bootstrap, make_hybrid_eval_step,
        make_hybrid_train_step)
    from distributed_embeddings_torch.utils.convert import (
        hybrid_state_from_jax)

    cdt = _dtype(spec["compute_dtype"])
    cfg = DLRMConfig(compute_dtype=cdt, **spec["model"])
    de = _layer(dict(spec, configs=cfg.embedding_configs()), world)

    def fresh():
        return hybrid_state_from_jax(de, DLRMDense(cfg, device="cpu"),
                                     spec["tables"], spec["dense_tree"], 0,
                                     dtype=_dtype(spec["table_dtype"]),
                                     device="cpu")

    def loss_fn(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    step = make_hybrid_train_step(de, loss_fn, SGD(spec["lr"]), SparseSGD(),
                                  lr_schedule=spec["lr"], nan_guard=True)

    def run(st, batch):
        cats, num, lab = batch
        cats = _feed(de, cats, rank, world)
        num, lab = bootstrap.shard_batch(
            (torch.from_numpy(num.copy()), torch.from_numpy(lab.copy())),
            rank, world)
        return step(st, cats, (num, lab))

    def snapshot(st):
        return ({k: v.clone() for k, v in st.emb_params.items()},
                [p.detach().clone() for p in st.dense_params.parameters()])

    def train(control):
        patch = _dlrm_control(control)
        if patch is not None:
            mod, attr, fn = patch
            real = getattr(mod, attr)
            setattr(mod, attr, fn)
        try:
            st, losses = fresh(), []
            for batch in spec["batches"]:
                loss, st = run(st, batch)
                losses.append(float(loss))
        finally:
            if patch is not None:
                setattr(mod, attr, real)
        return st, losses

    state, losses = train(None)
    slabs, dense_p = snapshot(state)
    nan_loss, state = run(state, spec["nan_batch"])
    unchanged = (all(torch.equal(slabs[k], v)
                     for k, v in state.emb_params.items())
                 and all(torch.equal(a, b) for a, b in zip(
                     dense_p, state.dense_params.parameters())))
    cats, num, lab = spec["eval_batch"]
    pred = make_hybrid_eval_step(
        de, lambda m, outs, b: torch.sigmoid(m(b, outs).float()))(
        state, _feed(de, cats, rank, world),
        bootstrap.shard_batch(torch.from_numpy(num.copy()), rank, world))
    controls = {}
    for control in spec.get("controls", ()):
        st, closs = train(control)
        controls[control] = {
            "losses": closs,
            "slabs": {k: v[0].float().numpy()
                      for k, v in st.emb_params.items()},
            "dense": [p.detach().numpy()
                      for p in st.dense_params.parameters()]}
    return {"losses": losses, "nan_loss": float(nan_loss),
            "unchanged": unchanged, "step": int(state.step),
            "slabs": {k: v[0].float().numpy() for k, v in slabs.items()},
            "dense": [p.detach().numpy() for p in dense_p],
            "pred": pred.float().numpy(),
            "pred_all": bootstrap.to_host(pred), "controls": controls}


def case_mp_loop(rank, world, spec):
    """The DLRM step over ``spec["batches"]`` with model-parallel input,
    once step by step and once through ``make_hybrid_train_loop`` with
    the batches' blocks stacked into one :class:`MpInputs`, each from the
    same state: the losses, slabs and dense parameters of both."""
    from distributed_embeddings_torch.models import (DLRMConfig, DLRMDense,
                                                     bce_with_logits)
    from distributed_embeddings_torch.parallel import (
        SGD, MpInputs, SparseSGD, bootstrap, make_hybrid_train_loop,
        make_hybrid_train_step)
    from distributed_embeddings_torch.utils.convert import (
        hybrid_state_from_jax)

    cfg = DLRMConfig(**spec["model"])
    de = _layer(dict(spec, configs=cfg.embedding_configs()), world)

    def fresh():
        return hybrid_state_from_jax(de, DLRMDense(cfg, device="cpu"),
                                     spec["tables"], spec["dense_tree"], 0,
                                     device="cpu")

    def loss_fn(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    args = (de, loss_fn, SGD(spec["lr"]), SparseSGD())
    kw = dict(lr_schedule=spec["lr"], nan_guard=True)
    blocks, dense = [], []
    for cats, num, lab in spec["batches"]:
        blocks.append(_feed(de, cats, rank, world))
        dense.append(bootstrap.shard_batch(
            (torch.from_numpy(num.copy()), torch.from_numpy(lab.copy())),
            rank, world))
    st, losses = fresh(), []
    step = make_hybrid_train_step(*args, **kw)
    for mp, batch in zip(blocks, dense):
        loss, st = step(st, mp, batch)
        losses.append(float(loss))
    stacked = MpInputs(packed=torch.stack([b.packed for b in blocks]),
                       hots=blocks[0].hots,
                       local_batch=blocks[0].local_batch)
    llosses, lst = make_hybrid_train_loop(*args, **kw)(
        fresh(), stacked, tuple(torch.stack(x) for x in zip(*dense)))
    return {"losses": losses, "loop_losses": [float(x) for x in llosses],
            "slabs_equal": all(torch.equal(st.emb_params[k], v)
                               for k, v in lst.emb_params.items()),
            "dense_equal": all(torch.equal(a, b) for a, b in zip(
                st.dense_params.parameters(),
                lst.dense_params.parameters()))}


def case_glue(rank, world, spec):
    """The process-group helpers and the gradient glue on rank-dependent
    values: ``mean_flat``, ``resolve_dp_gradient``, ``hybrid_gradients``,
    ``split_mp_dp``, ``broadcast_variables``, ``to_host``,
    ``broadcast_seed``, ``shard_batch`` of a global ragged batch, and a
    per-rank ``init`` drawn twice from one seed."""
    from distributed_embeddings_torch.ops.embedding_lookup import Ragged
    from distributed_embeddings_torch.parallel import (
        DistributedEmbedding, bootstrap, broadcast_variables,
        hybrid_gradients, mean_flat, resolve_dp_gradient, split_mp_dp)

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    y = torch.tensor([float(rank)], dtype=torch.bfloat16)
    grads = {"mp": x.clone(), "dp": [x.clone(), x[0].clone()]}
    mask = {"mp": True, "dp": False}
    mp, dp = split_mp_dp(grads, mask)
    hyb = hybrid_gradients(grads, mask, None, world)
    params = [torch.full((3,), float(rank)), torch.full((2,), -float(rank))]
    broadcast_variables(params, False, None, root_rank=2)
    ragged = Ragged.from_lists([[1], [2, 3], [], [4, 5, 6]] * world,
                               weights=[[0.5], [1, 2], [], [3, 4, 5]] * world)
    mine = bootstrap.shard_batch(ragged, rank, world)
    means = mean_flat([x, y], None, world)
    de = DistributedEmbedding(spec["configs"], world)
    a = de.init(torch.Generator().manual_seed(7), device="cpu")
    b = de.init(torch.Generator().manual_seed(7), device="cpu")
    return {
        "mean": [t.float().numpy() for t in means],
        "mean_dtypes": [str(t.dtype) for t in means],
        "resolved": resolve_dp_gradient(x, None, world).numpy(),
        "x_after": x.numpy(),
        "split": (mp["mp"].numpy(), mp["dp"], dp["mp"],
                  [t.numpy() for t in dp["dp"]]),
        "hybrid": (hyb["mp"].numpy(), [t.numpy() for t in hyb["dp"]]),
        "params": [p.numpy() for p in params],
        "to_host": bootstrap.to_host(x[:1]),
        "seed": bootstrap.broadcast_seed(100 + rank),
        "world": (bootstrap.world(), bootstrap.process_index(),
                  bootstrap.process_count()),
        "ragged": (mine.values.numpy(), mine.row_splits.numpy(),
                   mine.weights.numpy()),
        "init_same": all(torch.equal(a[k], b[k]) for k in a),
        "init": {k: v[0].numpy() for k, v in a.items()}}


class Linear(torch.nn.Module):
    """A dense part of one weight ``w`` (the JAX tests' ``{"w": w}``)."""

    def __init__(self, w):
        super().__init__()
        import numpy as np

        self.w = torch.nn.Parameter(torch.from_numpy(
            np.array(w, np.float32)))


def loss_of(name):
    """The instrumented cases' losses, each plus ``0 * sum(batch)`` (a
    NaN batch makes the loss NaN):

    * ``"proj"``: ``mean((concat(outs) @ w) ** 2)``;
    * ``"sq"``: ``sum(mean(out ** 2)) * w``;
    * ``"mean"``: ``sum(mean(out)) * mean(w)``."""

    def f(m, outs, batch):
        if name == "proj":
            x = torch.cat([o.reshape(o.shape[0], -1).float() for o in outs],
                          1)
            loss = ((x @ m.w) ** 2).mean()
        elif name == "sq":
            loss = sum((o.float() ** 2).mean() for o in outs) * m.w
        else:
            loss = sum(o.float().mean() for o in outs) * m.w.mean()
        return loss + batch.sum() * 0.0

    return f


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np_tree(v) for v in tree)
    return tree.detach().cpu().numpy().copy()


def _hybrid_controls(de, rank, spec):
    """The instrumented cases' controls (each must fail its bound):

    * ``"stream_rank0"``: the streaming plan taken from rank 0's row on
      every rank (the world-1 code);
    * ``"metrics_reversed"``: the metrics gathered in reversed rank
      order.

    Returns a function that undoes the patch."""
    from distributed_embeddings_torch.parallel import bootstrap

    control = spec.get("control")
    if control == "stream_rank0":
        real = de._streaming_plan_arrays

        def rank0(plan, gi, device):
            mine, de._rank = de._rank, 0
            try:
                return real(plan, gi, device)
            finally:
                de._rank = mine

        de._streaming_plan_arrays = rank0
        return lambda: None
    if control == "metrics_reversed":
        real_gather = bootstrap.all_gather

        def reversed_order(x, group, world_size):
            return real_gather(x, group, world_size).flip(0)

        bootstrap.all_gather = reversed_order
        return lambda: setattr(bootstrap, "all_gather", real_gather)
    return lambda: None


def _stack_feeds(feeds):
    """Per-step embedding inputs as the loop takes them: dense inputs
    stacked along a leading step axis, or one stacked MpInputs."""
    from distributed_embeddings_torch.parallel import MpInputs

    if isinstance(feeds[0], MpInputs):
        return MpInputs(packed=torch.stack([f.packed for f in feeds]),
                        hots=feeds[0].hots,
                        local_batch=feeds[0].local_batch)
    return [torch.stack(x) for x in zip(*feeds)]


def case_hybrid(rank, world, spec):
    """The hybrid train step (or, with ``spec["loop"]``, the train loop)
    with step metrics, telemetry and streaming as the spec asks, over
    ``spec["steps"]`` (global inputs, this rank takes its rows or its
    model-parallel block), from ``spec["tables"]`` and a dense weight
    ``spec["w"]``, ``SparseSGD`` + ``SGD`` at ``spec["lr"]``. Returns the
    losses, the metrics of every step, this rank's telemetry and
    streaming states, its slabs, and the host summaries (collectives).
    ``spec["nan_after"]``: then one more step with a NaN batch, reporting
    whether every parameter, optimizer and streaming leaf kept its bits;
    ``spec["eval"]``: then the eval step (read-only streaming) on the
    last inputs, its predictions and whether the streaming state kept
    its bits. ``spec["telemetry_off_twin"]``: also return the same steps
    run without telemetry (losses and state). ``spec["telem_init"]`` /
    ``spec["stream_init"]``: a JAX ``[world, ...]`` state (numpy) to
    start from, this rank's row carried over by the converters."""
    import numpy as np

    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.parallel import (
        SGD, HybridTrainState, SparseSGD, StreamingConfig, init_streaming,
        make_hybrid_eval_step, make_hybrid_train_loop,
        make_hybrid_train_step)
    from distributed_embeddings_torch.parallel import streaming as smod
    from distributed_embeddings_torch.utils.convert import (
        streaming_state_from_jax, telemetry_state_from_jax)

    de = _layer(spec, world)
    _control_rbase(de, rank, spec)
    undo = _hybrid_controls(de, rank, spec)
    tcfg = (tel.TelemetryConfig(*spec["telemetry"])
            if spec.get("telemetry") else None)
    scfg = (StreamingConfig(*spec["dynamic"]) if spec.get("dynamic")
            else None)
    with_metrics = spec.get("with_metrics", False)
    feeds = [_feed(de, s, rank, world) for s in spec["steps"]]
    b = spec["local_batch"]
    batch = torch.zeros(b)

    def fresh():
        params = de.set_weights(spec["tables"], device="cpu")
        opt = SparseSGD()
        dense = Linear(spec["w"])
        return HybridTrainState(
            emb_params=params, emb_opt_state=opt.init(params),
            dense_params=dense,
            dense_opt_state=SGD(spec["lr"]).init(list(dense.parameters())),
            step=torch.zeros((), dtype=torch.int32))

    def run(tcfg):
        state = fresh()
        aux = []
        if tcfg is not None:
            aux.append(
                tel.init_telemetry(de, tcfg, device="cpu")
                if spec.get("telem_init") is None else
                telemetry_state_from_jax(spec["telem_init"], device="cpu",
                                         rank=rank))
        if scfg is not None:
            aux.append(
                init_streaming(de, scfg, device="cpu")
                if spec.get("stream_init") is None else
                streaming_state_from_jax(spec["stream_init"], device="cpu",
                                         rank=rank))
        args = (de, loss_of(spec["loss"]), SGD(spec["lr"]), SparseSGD())
        kw = dict(lr_schedule=spec["lr"], with_metrics=with_metrics,
                  nan_guard=spec.get("nan_guard", False), telemetry=tcfg,
                  dynamic=scfg)
        losses, metrics = [], []
        if spec.get("loop"):
            out = make_hybrid_train_loop(*args, **kw)(
                state, _stack_feeds(feeds),
                torch.zeros((len(feeds), b)), *aux)
            losses = [float(x) for x in out[0]]
            if with_metrics:
                metrics = out[2]
        else:
            step = make_hybrid_train_step(*args, **kw)
            for feed in feeds:
                out = step(state, feed, batch, *aux)
                state = out[1]
                losses.append(float(out[0]))
                if with_metrics:
                    metrics.append(out[2])
        state = out[1]
        aux = list(out[3:] if with_metrics else out[2:])
        return losses, metrics, state, aux, step if not spec.get(
            "loop") else None

    try:
        losses, metrics, state, aux, step = run(tcfg)
    finally:
        undo()
    telem = aux[0] if tcfg is not None else None
    sstate = aux[-1] if scfg is not None else None
    res = {"losses": losses, "metrics": _np_tree(metrics),
           "slabs": {k: v[0].float().numpy().copy()
                     for k, v in state.emb_params.items()},
           "w": state.dense_params.w.detach().numpy().copy()}
    if telem is not None:
        res["telem"] = _np_tree(telem)
        res["hot_rows"] = tel.hot_rows(de, telem)
        res["load_balance"] = tel.load_balance(telem, de=de)
        res["summary"] = tel.summarize_telemetry(de, telem)
        gathered = tel.gather_state(de, telem)
        if rank == 0:
            res["gathered"] = gathered
    if sstate is not None:
        res["stream"] = _np_tree(sstate)
        res["occupancy"] = smod.occupancy(de, sstate)
    if spec.get("telemetry_off_twin"):
        olosses, _, ostate, _, _ = run(None)
        res["off_losses"] = olosses
        res["same_state"] = all(
            torch.equal(a, b) for a, b in zip(
                pytree_leaves(state), pytree_leaves(ostate)))
        res["same_loss_bits"] = [
            np.float32(x).tobytes() for x in losses] == [
            np.float32(x).tobytes() for x in olosses]
    if spec.get("nan_after"):
        before = [t.clone() for t in pytree_leaves((state, sstate))]
        tsteps = None if telem is None else telem["steps"].clone()
        out = step(state, feeds[-1], torch.full((b,), float("nan")),
                   *aux)
        res["nan_loss"] = float(out[0])
        res["nan_unchanged"] = all(
            torch.equal(a, b) for a, b in zip(
                before, pytree_leaves((out[1], sstate)))
            if a.dtype != torch.int32 or a.dim() != 0)
        res["nan_step"] = int(out[1].step)
        if with_metrics:
            res["nan_metrics"] = _np_tree(out[2])
        if telem is not None:
            res["nan_telem_steps"] = int(telem["steps"]) - int(tsteps)
    if spec.get("eval"):
        before = [t.clone() for t in pytree_leaves(sstate)]
        ev = make_hybrid_eval_step(
            de, lambda m, outs, bt: torch.stack(
                [o.float().reshape(o.shape[0], -1).sum(1) for o in outs], 1),
            dynamic=scfg)
        res["pred"] = ev(state, feeds[-1], batch, sstate).numpy()
        res["eval_unchanged"] = all(torch.equal(a, b) for a, b in zip(
            before, pytree_leaves(sstate)))
    return res


def pytree_leaves(tree):
    """The tensor leaves of a state (a module's parameters included)."""
    from torch.utils import _pytree as pytree

    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out += [p.detach() for p in leaf.parameters()]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.detach())
    return out


class PipeDense(torch.nn.Module):
    """The pipelined A/B matrix's dense part (``tests/test_pipeline.py``'s
    ``{"w": [cols, 1], "v": [13, 1]}``)."""

    def __init__(self, w, v):
        super().__init__()
        import numpy as np

        self.w = torch.nn.Parameter(torch.from_numpy(np.array(w, np.float32)))
        self.v = torch.nn.Parameter(torch.from_numpy(np.array(v, np.float32)))


def pipe_loss(m, outs, batch):
    """``tests/test_pipeline.py``'s ``_loss_fn``: ``mean((concat(outs) @
    w + n @ v - y) ** 2)``."""
    n, y = batch
    x = torch.cat([e.reshape(e.shape[0], -1) for e in outs], 1)
    return ((x @ m.w + n @ m.v - y) ** 2).mean()


def _pipe_control(de, control, K):
    """The pipelined runs' controls; returns a function that undoes the
    patch. Each fails its bound but ``"stream_reversed"``, which keeps
    every bit (K16's claims do not depend on the stream's order).

    * ``"stream_reversed"``: the admission stage takes the microbatches'
      streaming streams in reversed order;
    * ``"stream_dropped"``: the admission stage takes the last
      microbatch's streaming streams only;
    * ``"no_inv_k"``: the sparse apply scaled by ``1/world``, not
      ``1/(world K)``;
    * ``"serialized_order"``: every exchange of the pipelined step waited
      for as soon as it starts (nothing in flight)."""
    from distributed_embeddings_torch.parallel import apply

    if control is None:
        return lambda: None
    if control == "stream_reversed":
        real = de.streaming_stage
        de.streaming_stage = lambda streams, *a: real(streams[::-1], *a)
        return lambda: None
    if control == "stream_dropped":
        real = de.streaming_stage
        de.streaming_stage = lambda streams, *a: real(streams[-1:], *a)
        return lambda: None
    if control == "no_inv_k":
        real_apply = apply.apply_width_streams

        def scaled(*a, scale, **kw):
            return real_apply(*a, scale=scale * K, **kw)

        apply.apply_width_streams = scaled
        return lambda: setattr(apply, "apply_width_streams", real_apply)
    if control == "serialized_order":
        real_begin, real_cot = de._forward_begin, apply.cotangent_exchange
        de._forward_begin = (lambda *a, in_flight=False, **kw:
                             real_begin(*a, in_flight=False, **kw))
        apply.cotangent_exchange = (lambda *a, in_flight=False, **kw:
                                    real_cot(*a, in_flight=False, **kw))
        return lambda: setattr(apply, "cotangent_exchange", real_cot)
    raise ValueError(f"unknown control {control!r}")


def pipeline_run(spec, K, rank=0, world=1, control=None):
    """One run of the pipelined A/B matrix (``tests/test_pipeline.py``'s
    ``_run``) on the port: the layer with ``pipelined_schedule(K)`` (K = 1:
    ``schedule=None``), ``spec["steps"]`` guarded steps of
    :func:`pipe_loss` from ``spec["tables"]`` and the dense weights, this
    rank's rows of ``spec["inputs"]`` and ``(n, y)``. Returns the losses,
    the tables (rank 0's copy), this rank's telemetry and streaming
    states and the last step's metrics (numpy), and the phase log of the
    last step."""
    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.parallel import (
        SGD, DistributedEmbedding, HybridTrainState, SparseAdagrad,
        SparseAdam, SparseSGD, StreamingConfig, bootstrap, init_streaming,
        make_hybrid_train_step)
    from distributed_embeddings_torch.parallel.schedule import (
        pipelined_schedule)
    from distributed_embeddings_torch.utils import obs

    streaming = spec["streaming"]
    de = DistributedEmbedding(
        spec["configs"], world_size=world, row_slice=spec.get("row_slice"),
        schedule=(None if K == 1
                  else pipelined_schedule(K, streaming=streaming)))
    params = de.set_weights(spec["tables"], device="cpu")
    opt = {"sgd": SparseSGD, "adagrad": SparseAdagrad,
           "adam": SparseAdam}[spec["opt"]]()
    dense = PipeDense(spec["w"], spec["v"])
    tx = SGD(spec["dense_lr"])
    state = HybridTrainState(params, opt.init(params), dense,
                             tx.init(list(dense.parameters())),
                             torch.zeros((), dtype=torch.int32))
    tcfg = tel.TelemetryConfig() if spec["telemetry"] else None
    scfg = StreamingConfig(admit_min_count=1) if streaming else None
    aux = []
    if tcfg is not None:
        aux.append(tel.init_telemetry(de, tcfg, device="cpu"))
    if scfg is not None:
        aux.append(init_streaming(de, scfg, device="cpu"))
    cats = _inputs(spec["inputs"], rank, world)
    n, y = bootstrap.shard_batch(
        (torch.from_numpy(spec["n"].copy()),
         torch.from_numpy(spec["y"].copy())), rank, world)
    step = make_hybrid_train_step(
        de, pipe_loss, tx, opt, lr_schedule=spec["lr"],
        with_metrics=spec["metrics"], nan_guard=True, telemetry=tcfg,
        dynamic=scfg)
    undo = _pipe_control(de, control, K)
    losses, metrics = [], None
    try:
        for _ in range(spec["steps"]):
            with obs.phase_log() as names:
                out = step(state, cats, (n, y), *aux)
            state = out[1]
            losses.append(float(out[0]))
            rest = list(out[2:])
            if spec["metrics"]:
                metrics = rest.pop(0)
            aux = rest
    finally:
        undo()
    return {"losses": losses,
            "tables": de.get_weights(state.emb_params, all_ranks=False),
            "aux": [_np_tree(a) for a in aux],
            "metrics": None if metrics is None else _np_tree(metrics),
            "phases": list(names)}


def case_pipeline(rank, world, spec):
    """The pipelined A/B matrix at world ``world``: the serialized run,
    the pipelined K = 2 run, then one pipelined run per
    ``spec["controls"]`` (:func:`_pipe_control`)."""
    out = {"serialized": pipeline_run(spec, 1, rank, world),
           "pipelined": pipeline_run(spec, 2, rank, world)}
    for control in spec.get("controls", ()):
        out[control] = pipeline_run(spec, 2, rank, world, control)
    return out


# ------------------------------------------------ checkpoints (world > 1)


def ckpt_optimizers(name, sched):
    """The port's (sparse optimizer, dense optimizer, sparse lr) of a
    checkpoint spec's ``opt``: ``"sgd"`` (SparseSGD + SGD under the
    schedule ``sched``), ``"adagrad"`` (SparseAdagrad + Adagrad 0.1) or
    ``"adam"`` (SparseAdam + Adam 1e-3)."""
    from distributed_embeddings_torch.models.schedules import (
        warmup_poly_decay_schedule)
    from distributed_embeddings_torch.parallel import (
        SGD, Adagrad, Adam, SparseAdagrad, SparseAdam, SparseSGD)

    if name == "sgd":
        lr = warmup_poly_decay_schedule(*sched)
        return SparseSGD(), SGD(lr), lr
    if name == "adagrad":
        return SparseAdagrad(), Adagrad(0.1), 0.05
    return SparseAdam(), Adam(1e-3), 0.01


def state_bits(de, state, rank):
    """This rank's whole train state as numpy: its slabs and slab-shaped
    optimizer leaves (bf16 as their int16 bits), every other optimizer
    leaf, the dense parameters and optimizer state, the step; and on rank
    0 the logical tables (``get_weights``, a collective)."""
    from torch.utils import _pytree

    def bits(t):
        t = t.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().copy()

    out = {"step": int(state.step),
           "emb": {k: bits(v) for k, v in sorted(state.emb_params.items())},
           "opt": [bits(t) for t in _pytree.tree_leaves(
               state.emb_opt_state)],
           "dense": [bits(p) for p in state.dense_params.parameters()],
           "dense_opt": [bits(t) for t in _pytree.tree_leaves(
               state.dense_opt_state)]}
    tables = de.get_weights(state.emb_params, all_ranks=False)
    out["tables"] = tables if rank == 0 else None
    return out


def case_ckpt(rank, world, spec):
    """Checkpoint operations at world ``world`` on a DLRM layer, in the
    order ``spec["ops"]`` lists them (each ``(op, *args)``), on a
    context this rank keeps; returns what the ops recorded by name.

    * ``("restore", path, name, kwargs)``: ``restore_train_state`` into a
      fresh dense module; an exception is recorded (type and message)
      under ``name`` instead of the state.
    * ``("save", path, kwargs)``: ``save_train_state``.
    * ``("save_chief", path, is_chief_by_rank, name)``:
      ``save_train_state`` with this rank's ``is_chief``; an exception is
      recorded (type and message) under ``name``, else ``"saved"``.
    * ``("steps", n, name)``: the next ``n`` of ``spec["batches"]`` from
      the current position; the losses under ``name``.
    * ``("seek", i)``: the batch position.
    * ``("snap", name)``: :func:`state_bits`.
    * ``("corrupt", path)``: rank 0 flips a byte mid-file in the first
      table file; a barrier.
    * ``("events", name)``: the kinds of the events ``obs`` recorded.
    * ``("init",)``: a fresh state (``init_hybrid_state``, seeded).
    * ``("stream_from_jax", tree)`` / ``("telem_from_jax", tree)``: this
      rank's row of a JAX ``[world, ...]`` streaming / telemetry state.
    * ``("encode", name)``: ``encode_state`` (a collective).
    * ``("decode", encoded, name)`` / ``("load_aux", path, name)``:
      ``decode_state`` of an encoding / of a checkpoint's aux file into a
      fresh state (it becomes the carried one); the numpy state and the
      warnings logged.
    * ``("save_aux", path, kwargs)``: ``save_train_state`` with the
      streaming state's encoding.
    * ``("telem_save", path)`` / ``("telem_restore", path, name)``: the
      telemetry state file (the restore into a fresh state, as numpy).

    ``spec["streaming"]`` (``{table: {"capacity", "buckets"}}``),
    ``spec["scfg"]`` and ``spec["tcfg"]`` give the streaming tables and
    the two configs; ``spec["device"]`` where the restores and steps run
    (default the CPU; ``init`` draws on the CPU), ``spec["dtype"]`` the
    tables' dtype of ``init``.
    """
    import logging

    from distributed_embeddings_torch.analysis import telemetry as tel
    from distributed_embeddings_torch.models import (DLRMConfig, DLRMDense,
                                                     bce_with_logits)
    from distributed_embeddings_torch.parallel import (
        StreamingConfig, bootstrap, init_hybrid_state, init_streaming,
        make_hybrid_train_step)
    from distributed_embeddings_torch.parallel import streaming as smod
    from distributed_embeddings_torch.utils import checkpoint as ckpt
    from distributed_embeddings_torch.utils import obs
    from distributed_embeddings_torch.utils.convert import (
        streaming_state_from_jax, streaming_state_to_numpy,
        telemetry_state_from_jax, telemetry_state_to_numpy)

    cfg = DLRMConfig(**spec["model"])
    configs = cfg.embedding_configs()
    for tid, sc in spec.get("streaming", {}).items():
        configs[tid]["streaming"] = sc
    de = _layer(dict(spec, configs=configs), world)
    emb_opt, tx, lr = ckpt_optimizers(spec["opt"], spec.get("sched"))

    def loss_fn(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    step = make_hybrid_train_step(de, loss_fn, tx, emb_opt, lr_schedule=lr)
    scfg = (StreamingConfig(*spec["scfg"]) if spec.get("scfg") else None)
    tcfg = (tel.TelemetryConfig(*spec["tcfg"]) if spec.get("tcfg")
            else None)
    out, state, pos, ss, telem = {}, None, 0, None, None
    dev = spec.get("device", "cpu")
    if dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    obs.drain_events()
    warned = _WarningLog()
    logging.getLogger("distributed_embeddings_torch").addHandler(warned)
    for op, *args in spec["ops"]:
        if op == "init":
            dense = DLRMDense(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(9))
            state = init_hybrid_state(
                de, emb_opt, dense, tx, device="cpu",
                dtype=getattr(torch, spec.get("dtype", "float32")),
                generator=torch.Generator().manual_seed(3))
        elif op == "stream_from_jax":
            ss = streaming_state_from_jax(args[0], device="cpu", rank=rank)
        elif op == "encode":
            out[args[0]] = smod.encode_state(de, ss)
        elif op == "decode":
            enc, name = args
            warned.records.clear()
            ss = smod.decode_state(de, init_streaming(de, scfg, device="cpu"),
                                   enc)
            out[name] = (streaming_state_to_numpy(ss), list(warned.records))
        elif op == "save_aux":
            path, kw = args
            ckpt.save_train_state(path, de, state, aux_states={
                "streaming": smod.encode_state(de, ss)}, **kw)
        elif op == "load_aux":
            path, name = args
            warned.records.clear()
            ss = smod.decode_state(de, init_streaming(de, scfg, device="cpu"),
                                   ckpt.load_aux_state(path, "streaming"))
            out[name] = (streaming_state_to_numpy(ss), list(warned.records))
        elif op == "telem_from_jax":
            telem = telemetry_state_from_jax(args[0], device="cpu",
                                             rank=rank)
        elif op == "telem_save":
            tel.save_telemetry_state(args[0], telem, de)
        elif op == "telem_restore":
            path, name = args
            got = tel.restore_telemetry_state(
                path, tel.init_telemetry(de, tcfg, device="cpu"), de)
            out[name] = telemetry_state_to_numpy(got)
        elif op == "restore":
            path, name, kw = args
            dense = DLRMDense(cfg, device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(9))
            try:
                state = ckpt.restore_train_state(path, de, emb_opt, dense,
                                                 tx, device=dev, **kw)
            except Exception as e:  # noqa: BLE001 - the result
                out[name] = (type(e).__name__, str(e))
        elif op == "save":
            path, kw = args
            ckpt.save_train_state(path, de, state, **kw)
        elif op == "save_chief":
            path, chiefs, name = args
            try:
                ckpt.save_train_state(path, de, state,
                                      is_chief=chiefs[rank])
                out[name] = "saved"
            except Exception as e:  # noqa: BLE001 - the result
                out[name] = (type(e).__name__, str(e))
        elif op == "seek":
            pos = args[0]
        elif op == "steps":
            n, name = args
            losses = []
            for cats, num, lab in spec["batches"][pos:pos + n]:
                feed = [c.to(dev) for c in _feed(de, list(cats), rank,
                                                 world)]
                num, lab = bootstrap.shard_batch(
                    (torch.from_numpy(num.copy()),
                     torch.from_numpy(lab.copy())), rank, world)
                loss, state = step(state, feed, (num.to(dev), lab.to(dev)))
                losses.append(float(loss))
            pos += n
            out[name] = losses
        elif op == "snap":
            out[args[0]] = state_bits(de, state, rank)
        elif op == "corrupt":
            if rank == 0:
                target = os.path.join(args[0], "tables", "table_000.npy")
                with open(target, "r+b") as f:
                    f.seek(os.path.getsize(target) // 2)
                    byte = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([byte[0] ^ 0xFF]))
            bootstrap.barrier(None)
        elif op == "events":
            out[args[0]] = [e["event"] for e in obs.drain_events()]
        else:
            raise ValueError(f"unknown checkpoint op {op!r}")
    return out


def case_example(rank, world, spec):
    """The port's DLRM example (``examples/dlrm_main.py``) on this rank
    of the group: for each ``(name, argv)`` of ``spec["runs"]``, ``main``
    with the group's flags and ``--checkpoint_out <dir>/rank<r>/<name>``
    (so what each rank writes lands in its own directory), under
    ``spec["env"]``. Returns per run what the rank printed, its losses,
    the AUC, and :func:`state_bits` of the final state."""
    import contextlib
    import io

    from distributed_embeddings_torch.examples import dlrm_main

    env = spec.get("env", {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        for name, argv in spec["runs"]:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = dlrm_main.main(list(argv) + [
                    "--world_size", str(world), "--rank", str(rank),
                    "--backend", "gloo", "--device", "cpu",
                    "--checkpoint_out",
                    os.path.join(spec["dir"], f"rank{rank}", name)])
            out[name] = {"stdout": buf.getvalue(), "losses": res.losses,
                         "auc": res.auc, "steps_run": res.steps_run,
                         "snap": state_bits(res.de, res.state, rank)}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def case_joined_flags(rank, world, spec):
    """The example's ``main`` in this rank's joined group with the flags
    of ``spec["claims"]`` (each ``(name, world_size, rank shift)``: it
    claims rank ``(rank + shift) % world_size`` of ``world_size``);
    records the ``ValueError`` it raises, or ``"ran"``."""
    from distributed_embeddings_torch.examples import dlrm_main

    out = {}
    for name, w, shift in spec["claims"]:
        try:
            dlrm_main.main(list(spec["argv"]) + [
                "--world_size", str(w), "--rank", str((rank + shift) % w),
                "--backend", "gloo", "--device", "cpu"])
            out[name] = "ran"
        except ValueError as e:
            out[name] = str(e)
    return out


def case_convergence(rank, world, spec):
    """``train_dlrm_convergence`` at world ``world`` (SparseAdam + Adam)
    from JAX's initial tables and dense parameters (``spec["tables"]``,
    ``spec["dense_tree"]``); its per-step losses, the three AUCs and this
    rank's own predictions of the last eval (before their gather)."""
    import numpy as np

    from distributed_embeddings_torch.models import (
        LearnableClicks, train_dlrm_convergence, warmup_poly_decay_schedule)
    from distributed_embeddings_torch.utils.convert import (
        hybrid_state_from_jax)

    task = LearnableClicks(spec["sizes"], num_numerical=4, seed=123,
                           scale=1.2)

    def init_state(de, dense, emb_opt, tx):
        return hybrid_state_from_jax(de, dense, spec["tables"],
                                     spec["dense_tree"], 0, device="cpu",
                                     emb_optimizer=emb_opt, dense_tx=tx)

    from distributed_embeddings_torch.parallel import bootstrap

    local = []
    real = bootstrap.to_host

    def kept(x, group=None):
        local[:] = [x.detach().float().cpu().numpy().copy()]
        return real(x, group)

    bootstrap.to_host = kept
    losses = []
    try:
        aucs = train_dlrm_convergence(
            task, world_size=world, steps=spec["steps"],
            batch=spec["batch"], embedding_dim=spec["dim"],
            lr_schedule=warmup_poly_decay_schedule(*spec["sched"]),
            eval_n=spec["eval_n"], seed=0, device="cpu",
            init_state=init_state,
            on_step=lambda i, loss, st: losses.append(float(loss)))
    finally:
        bootstrap.to_host = real
    return {"losses": np.array(losses), "aucs": list(aucs),
            "preds0": local[0].reshape(-1)}


class _WarningLog(logging.Handler):
    """The messages of the warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def case_lock_turns(rank, world, spec):
    """``set_weights(use_lock=True)`` at world ``world``: each rank
    appends its rank to ``spec["log"]`` inside its build; returns the
    slabs with and without the lock."""
    de = _layer(spec, world)
    plain = de.set_weights(spec["tables"], device="cpu")
    real = de._slice_plan

    def logged():
        with open(spec["log"], "a") as f:
            f.write(f"{rank}\n")
        return real()

    de._slice_plan = logged
    locked = de.set_weights(spec["tables"], device="cpu", use_lock=True)
    de._slice_plan = real
    return {"equal": all(torch.equal(plain[k], locked[k]) for k in plain)}


CASES = {"forward": case_forward, "train": case_train, "dlrm": case_dlrm,
         "mp_loop": case_mp_loop, "glue": case_glue, "hybrid": case_hybrid,
         "pipeline": case_pipeline, "ckpt": case_ckpt,
         "lock_turns": case_lock_turns, "example": case_example,
         "joined_flags": case_joined_flags, "convergence": case_convergence}


def serve(rank, world, store, inq, outq):
    """A rank: join the gloo group, then run cases until ``None``."""
    torch.set_num_threads(1)
    from distributed_embeddings_torch.parallel import bootstrap

    bootstrap.initialize("gloo", f"file://{store}", world, rank,
                         timeout_s=CASE_TIMEOUT_S)
    while True:
        msg = inq.get()
        if msg is None:
            break
        name, spec = msg
        try:
            outq.put((rank, True, CASES[name](rank, world, spec)))
        except Exception:  # noqa: BLE001 - reported to the parent
            outq.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


def join_unreachable(path, q):
    """A rank 0 of 2 whose peer never comes: its join must give up;
    sends the exception's type name (or ``"joined"``)."""
    from distributed_embeddings_torch.parallel import bootstrap

    try:
        bootstrap.initialize("gloo", f"file://{path}", 2, 0, timeout_s=1,
                             retries=1)
        q.put("joined")
    except Exception as e:  # noqa: BLE001 - the type is the result
        q.put(type(e).__name__)


# ----------------------------------------------------------- parent side


class RankGroup:
    """``world`` rank processes of one gloo group, serving cases."""

    def __init__(self, world, tmpdir):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        store = os.path.join(str(tmpdir), "store")
        self.procs = [ctx.Process(target=serve,
                                  args=(r, world, store, self.inqs[r],
                                        self.outq), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = None

    def submit(self, name, spec):
        """Start case ``name`` on every rank; :meth:`collect` waits for
        it (the parent can compute its reference meanwhile)."""
        if self.broken:
            raise RuntimeError(f"the rank group is broken: {self.broken}")
        self.pending = name
        for q in self.inqs:
            q.put((name, spec))

    def collect(self):
        """Every rank's result of the submitted case, in rank order."""
        import time

        name, got = self.pending, {}
        t0 = time.monotonic()
        while len(got) < self.world:
            try:
                rank, ok, res = self.outq.get(timeout=2)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self.procs)
                        if p.exitcode is not None and r not in got]
                late = time.monotonic() - t0 > CASE_TIMEOUT_S
                if dead or late:
                    self.broken = f"case {name!r}: ranks {sorted(got)} " \
                                  f"answered, (rank, exit code) {dead}"
                    raise RuntimeError(self.broken) from None
                continue
            got[rank] = (ok, res)
        errs = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items())
                if not ok]
        if errs:
            raise RuntimeError(f"case {name!r} failed\n" + "\n".join(errs))
        return [got[r][1] for r in range(self.world)]

    def run(self, name, spec):
        """Every rank's result of case ``name``, in rank order."""
        self.submit(name, spec)
        return self.collect()

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


__all__ = ["CASES", "RankGroup"]
