"""Apply layer of the hybrid step: the manual sparse backward and the
per-width optimizer scatters (counterpart of
``distributed_embeddings_tpu/parallel/apply.py``).

Everything after the dense backward: the output cotangents go into the
plan's column layout, each column slice of a sliced table's cotangent
to its own columns (:func:`~.exchange.pack_grad_blocks`, K20: the JAX
package's inversion of the column-slice collapse and its packing in one
launch), back to the tables' ranks (:func:`~.exchange.exchange_grads`;
a passthrough at world 1), the per-group id streams are rebuilt from
the forward's residual, and each width slab gets ONE optimizer scatter
(:func:`apply_width_streams`) scaled by ``1/world``. No dense table
gradient is ever built. The pipelined step runs the two halves apart
(:func:`cotangent_exchange` with the exchange left in flight, then
:func:`cotangent_streams_finish`) and merges its microbatches' streams
into the same one scatter per slab.

Dense groups (kind ``"d"``) build their stream with torch ops; ragged
groups (``"r"``/``"rw"``) on K10 (the row offsets from the residual's
lengths) and K9 (:func:`~..ops.sparse_grad.ragged_grad`, the per-position
ids and cotangent rows). A row-sliced slot's ids are range-local (less
its row base): an id outside its slice drops to the sentinel, and its
cotangent is the input's whole cotangent (each slice's output summed
into it).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from ..ops.embedding_lookup import lengths_to_splits
from ..ops.sparse_grad import ragged_grad
from ..utils import obs
from . import bootstrap
from . import exchange as exchange_mod
from . import schedule
from .lookup import _wkey, region_views


def apply_width_streams(de, params, opt_state,
                        per_width: Dict[str, List], optimizer, lr,
                        scale, enable=None):
    """Concatenate each width's ``(ids, update rows)`` stream and run ONE
    optimizer scatter per width slab, in place.

    The JAX package lane-expands the stream to its packed physical rows
    here (``ops/packed_slab.py:expand_update_rows``) and, for the
    stateful-moment optimizers, builds a lane touch-mask
    (``ops/packed_slab.py:lane_one_hot``, JAX ``parallel/apply.py:51``
    and ``:70-78``) so that the packed neighbours of a touched row keep
    their momentum or moments. The port's slabs, and any slab-shaped
    optimizer state (``SparseAdagrad``'s accumulators, ``SparseMomentum``'s
    trace, ``SparseAdam``'s moments), are logical ``[rows_cap, w]``:
    there is no lane expansion and no mask (a row is touched exactly
    when its id is in the dedup's segment set), and the logical stream
    goes to the optimizer as it is, with that width's state (a tensor
    or a tuple, updated in place).

    ``enable`` (a 0-d bool tensor): when False every id is routed to the
    dropped-row sentinel, so the slabs and any slab-shaped optimizer
    state stay bitwise unchanged, without a slab-wide select and without
    reading the verdict on the host."""
    new_params = dict(params)
    new_state = dict(opt_state) if isinstance(opt_state, dict) else opt_state
    for k in sorted(per_width):
        tris = per_width[k]
        w = tris[0][2]
        ids = torch.cat([t[0].reshape(-1) for t in tris]) if len(tris) > 1 \
            else tris[0][0].reshape(-1)
        if enable is not None:
            ids = torch.where(enable, ids, de.rows_cap[w])
        vals = torch.cat([t[1].reshape(-1, w) for t in tris]) \
            if len(tris) > 1 else tris[0][1].reshape(-1, w)
        if scale != 1.0:
            # a Python scale is rounded to the values' dtype, as in JAX
            vals = vals * torch.tensor(scale, dtype=vals.dtype,
                                       device=vals.device)
        st = new_state[k] if isinstance(new_state, dict) else new_state
        with obs.scope(f"sparse_apply_{k}"):
            slab, st = optimizer.apply_rows(new_params[k], st,
                                            ids.contiguous(),
                                            vals.contiguous(), lr)
        new_params[k] = slab
        if isinstance(new_state, dict):
            new_state[k] = st
    return new_params, new_state


def sparse_apply_gradients(de, params, opt_state, residuals, out_grads,
                           optimizer, lr, scale=None, enable=None):
    """Manual sparse backward + in-place optimizer update (the body of
    :meth:`~.dist_embedding.DistributedEmbedding.sparse_apply_gradients`;
    see that method's docstring for the argument contract)."""
    params = de.local_view(params)
    if isinstance(opt_state, dict):
        opt_state = de.local_view(opt_state)
    if scale is None:
        scale = 1.0 / de.world_size
    fallback = next(iter(params.values())).dtype
    per_width = cotangent_width_streams(de, residuals, out_grads,
                                        fallback_dtype=fallback)
    return apply_width_streams(de, params, opt_state, per_width,
                               optimizer, lr, scale, enable=enable)


class Cotangents(NamedTuple):
    """One microbatch's cotangents on their way back to the tables'
    ranks: the plan, the forward's received id block and batch, the
    exchange (an :class:`~.bootstrap.InFlight`) and its phase name."""

    plan: object
    ids_recv: torch.Tensor
    b: int
    pending: bootstrap.InFlight
    phase: str


def cotangent_exchange(de, residuals, out_grads, fallback_dtype=None,
                       tag: str = "", in_flight: bool = False
                       ) -> Cotangents:
    """The first half of :func:`cotangent_width_streams`: put the output
    cotangents in the plan's column layout (K20) and exchange them, under
    the ``grad_all_to_all{tag}`` scope. ``in_flight`` leaves the
    all-to-all in flight (the pipelined step); else it completes here
    (:func:`~.exchange.exchange_grads`)."""
    _, ids_recv, encs, b = residuals
    plan = de._get_plan(list(encs), b)
    out_dtype = out_grads[0].dtype if out_grads else fallback_dtype
    phase = schedule.PHASE_GRAD_EXCHANGE + tag
    with obs.scope(phase):
        packed = exchange_mod.pack_grad_blocks(de, plan, out_grads, b,
                                               out_dtype)
    if in_flight:
        pending = exchange_mod.exchange_grads_start(de, packed)
    else:
        pending = bootstrap.InFlight(
            exchange_mod.exchange_grads(de, packed, tag))
    return Cotangents(plan, ids_recv, b, pending, phase)


def cotangent_streams_finish(de, cot: Cotangents):
    """The second half of :func:`cotangent_width_streams`: wait for the
    exchange, then rebuild the per-width streams
    (:func:`received_width_streams`; K9 and K10 on ragged groups)."""
    mp_grad = exchange_mod.wait(cot.pending, cot.phase)
    return received_width_streams(de, cot.plan, cot.ids_recv, mp_grad,
                                  cot.b)


def cotangent_width_streams(de, residuals, out_grads, fallback_dtype=None,
                            tag: str = ""):
    """The sparse backward MINUS the optimizer scatter: put the output
    cotangents in the plan's column layout and rebuild the per-width
    ``{"w<width>": [(ids, update rows, width), ...]}`` streams from the
    forward residual (:func:`cotangent_exchange`, then
    :func:`cotangent_streams_finish`).

    Per dense group the stream is b-major: ids ``[world, b, n, hot]``
    (table-local id + the slot's slab row offset), update rows
    ``[world, b, n, hot, w]`` (the slot cotangent, over ``hot`` for
    ``mean`` slots of a multi-hot group, broadcast over the hot ids).
    Per ragged group it is slot-major, one entry per value position:
    ids ``[world, n, cap]`` and rows ``[world, n, cap, w]`` (the row's
    cotangent times the position's weight, over the row's length on
    ``mean`` slots), from K9. Ids outside their table, every id of a
    padding slot and every position outside the rows become the
    dropped-row sentinel ``rows_cap[w]``: a bad id trains nothing."""
    return cotangent_streams_finish(de, cotangent_exchange(
        de, residuals, out_grads, fallback_dtype=fallback_dtype, tag=tag))


def received_width_streams(de, plan, ids_recv, mp_grad, b: int):
    """The per-width streams of :func:`cotangent_width_streams` from this
    rank's received cotangents ``mp_grad [world, b, s_max]`` and its
    received id block."""
    world = de.world_size
    per_width: Dict[str, List] = {}
    for gi, g in enumerate(plan.groups):
        rows, roff, _, _ = de._plan_meta(plan, gi, mp_grad.device)
        sent = de.rows_cap[g.width]  # dropped-row sentinel (logical)
        region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
        gsl = mp_grad[:, :, g.col:g.col + g.n * g.width].reshape(
            world, b, g.n, g.width)
        if g.kind != "d":
            per_width.setdefault(_wkey(g.width), []).append(
                _ragged_stream(de, plan, gi, g, b, region, gsl, rows, roff,
                               sent))
            continue
        valid, mean = de._plan_bwd_meta(plan, gi, mp_grad.device)
        # b-major stream: the update rows are then exactly the
        # [world, b, n, w] cotangent layout, a free view; only the small
        # id tensor transposes
        ids4 = region.reshape(world, g.n, b, g.hot).transpose(1, 2)
        rbase = de._plan_rbase(plan, gi, mp_grad.device)
        if rbase is not None:  # row-sliced slots: range-local ids
            ids4 = ids4 - rbase.to(ids4.dtype)[None, None, :, None]
        ok = (ids4 >= 0) & (ids4 < rows[None, None, :, None])
        if valid is not None:
            ok = ok & valid[None, None, :, None]
        # int32 ids stay int32 while the sentinel fits (the JAX stream's
        # dtype); the kernel reads half the bytes
        idt = ids4.dtype if sent < 2 ** 31 else torch.int64
        ids = torch.where(ok, ids4 + roff.to(idt)[None, None, :, None],
                          sent)
        gb = gsl
        if g.hot > 1 and mean is not None:
            gb = (gsl / g.hot if bool(plan.mean[gi].all()) else
                  torch.where(mean[None, None, :, None], gsl / g.hot, gsl))
        vals = gb[:, :, :, None, :].expand(world, b, g.n, g.hot, g.width)
        per_width.setdefault(_wkey(g.width), []).append(
            (ids, vals, g.width))
    return per_width


def _ragged_stream(de, plan, gi, g, b, region, gsl, rows, roff, sent):
    """One ragged group's ``(ids [world, n, cap], rows [world, n, cap, w],
    w)`` stream: K10 rebuilds the row offsets from the residual's
    lengths (dead slots get none), K9 expands the ``[world, b, n, w]``
    cotangent, read in place, to every value position."""
    world = de.world_size
    mean, valid = de._plan_ragged_meta(plan, gi, gsl.device, reps=world)
    if world > 1:
        rows, roff, _, _ = de._plan_meta(plan, gi, gsl.device, reps=world)
    values, lengths, wbits = region_views(g, b, region)
    splits = lengths_to_splits(lengths, valid)
    # int32 ids stay int32 while the sentinel fits (the JAX stream's dtype)
    idt = values.dtype if sent < 2 ** 31 else torch.int64
    # [world * n, b, w] (source, slot) blocks: a strided view at world 1
    g3 = (gsl[0].transpose(0, 1) if world == 1 else
          gsl.permute(0, 2, 1, 3).reshape(world * g.n, b, g.width))
    ids, vals = ragged_grad(
        g3, splits, values=values, rows=rows, roff=roff, sentinel=sent,
        ids_dtype=idt, mean=mean, weights=wbits,
        rbase=de._plan_rbase(plan, gi, gsl.device, reps=world))
    return (ids.reshape(world, g.n, g.hot),
            vals.reshape(world, g.n, g.hot, g.width), g.width)
