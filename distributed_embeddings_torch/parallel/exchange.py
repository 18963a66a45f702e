"""Exchange layer of the hybrid step: the block layouts and the three
all-to-alls (counterpart of
``distributed_embeddings_tpu/parallel/exchange.py``).

The id blocks are laid out as the plan's rank-uniform group regions
(``parallel/plan.py``): each instance's ids at its (rank, group, slot)
cell, dead cells zero-filled, one block per destination rank; the
lookups, the received outputs and the output cotangents move between
the plan's ``[world, b, s_max]`` column layout and the per-input
tensors. Every one of these layouts is a batch of 2-D copies built once
per plan (:class:`~..ops.exchange_pack.CopyPlan`) and run by one launch
of K19 (:func:`~..ops.exchange_pack.pack_ids`, the id blocks) or K20
(:func:`~..ops.exchange_pack.pack_columns`, the float columns).

The collectives run over the layer's process group
(:mod:`.bootstrap`): the dp->mp id exchange (:func:`exchange_ids`), the
mp->dp output exchange (:func:`exchange_outputs`) and the reverse
cotangent exchange (:func:`exchange_grads`). Each is a start that leaves
the all-to-all in flight (``*_start``, an :class:`~.bootstrap.InFlight`)
followed by its :func:`wait`: the serialized step waits at once, the
pipelined step later. At world 1 each is a passthrough and no
collective runs.

:func:`assemble_cells` (the JAX package's concatenation of cells) stays
as the reference layout: :func:`build_send_blocks_plain` and
:func:`pack_grad_blocks_plain` are the blocks it gives, which the tests
and the card checks hold the copy plans to.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..ops.exchange_pack import CopyPlan, pack_columns, pack_ids
from ..utils import obs
from . import bootstrap
from . import schedule

# Marks exchange-layout cells covered by a multi-cell content array placed
# at an earlier slot (no-combiner multi-hot features span `hotness` slots).
_SPANNED = object()


def _cells(de, plan):
    """``cells[dest][group][slot]``: the index of the instance whose
    content starts there, :data:`_SPANNED` for the later cells of a
    multi-slot instance, ``None`` for a dead cell."""
    cells = [[[None] * g.n for g in plan.groups]
             for _ in range(de.world_size)]
    for j, inst in enumerate(plan.instances):
        row = cells[inst.rank][inst.group]
        row[inst.slot0] = j
        for k in range(1, inst.num_slots):
            row[inst.slot0 + k] = _SPANNED
    return cells


def _cached(de, key, build):
    """``build()`` once per plan (the layer's plan-keyed cache)."""
    v = de._meta_cache.get(key)
    if v is None:
        v = de._meta_cache[key] = build()
    return v


# ---------------------------------------------------------- reference layout


def assemble_cells(de, plan, fill, dead_shape, full_shape, dtype,
                   axis: int, device) -> torch.Tensor:
    """Place each instance's content at its (rank, group, slot0) cell —
    content spans all ``num_slots`` cells of a multi-slot instance —
    fill dead cells with zeros, concatenate in group/slot order per
    destination rank, and stack over ranks (the JAX package's assembly,
    kept as the reference of the copy plans).

    Args:
      fill: ``fill(inst) -> tensor``, the instance's content in layout form.
      dead_shape: ``dead_shape(group) -> shape`` of one dead cell.
      full_shape: shape of an all-dead destination row (no-groups edge).
      dtype, device: of the content (zeros match them).
      axis: concat axis of the per-destination parts.
    """
    cells = _cells(de, plan)
    zeros_cache: Dict[tuple, torch.Tensor] = {}

    def dead(shape):
        z = zeros_cache.get(shape)
        if z is None:
            z = torch.zeros(shape, dtype=dtype, device=device)
            zeros_cache[shape] = z
        return z

    blocks = []
    for dest in range(de.world_size):
        parts = []
        for gi, g in enumerate(plan.groups):
            for k in range(g.n):
                c = cells[dest][gi][k]
                if c is _SPANNED:
                    continue
                parts.append(dead(dead_shape(g)) if c is None
                             else fill(plan.instances[c]))
        blocks.append(torch.cat(parts, dim=axis) if parts
                      else dead(full_shape))
    return torch.stack(blocks)


def build_send_blocks_plain(de, plan, entries, comm_dtype, device
                            ) -> torch.Tensor:
    """The id blocks ``[world, l_max]`` by :func:`assemble_cells`."""

    def fill(inst):
        e = entries[inst.input_id]
        if isinstance(e, tuple):  # ("r"|"rw", values, lengths[, wbits])
            return torch.cat([p.reshape(-1) for p in e[1:]])
        if inst.transposed:  # slot-major: [b, ns*h] -> [ns, b, h] flat
            h = plan.groups[inst.group].hot
            return e.reshape(e.shape[0], inst.num_slots, h
                             ).transpose(0, 1).reshape(-1)
        return e.reshape(-1)

    return assemble_cells(
        de, plan, fill, dead_shape=lambda g: (g.blen,),
        full_shape=(plan.l_max,), dtype=comm_dtype, axis=0, device=device)


def pack_grad_blocks_plain(de, plan, out_grads, b: int, out_dtype
                           ) -> torch.Tensor:
    """The cotangent blocks ``[world, b, s_max]`` by
    :func:`assemble_cells`, from the input-order cotangents (each split
    into its column slices first, as the JAX package does)."""
    smap, _ = slice_map(de, plan)
    grads = {}
    for j, inst in enumerate(plan.instances):
        i, pos = smap[j]
        g = out_grads[i].reshape(b, -1)
        grads[inst] = g[:, pos:pos + plan.out_width(inst)]
    device = out_grads[0].device if out_grads else None
    return assemble_cells(
        de, plan, fill=lambda inst: grads[inst].to(out_dtype),
        dead_shape=lambda g: (b, g.width), full_shape=(b, plan.s_max),
        dtype=out_dtype, axis=1, device=device)


# -------------------------------------------------------------- copy plans


def slice_map(de, plan):
    """``(smap, widths)``: per worker-order instance ``j``, ``smap[j] =
    (input, first column)`` of its slice in that input's output, and per
    input the output width (the sum of its column slices; a row-sliced
    table's slices each span the whole width, from column 0). The slices
    of one input take consecutive worker entries in rank order, the JAX
    package's in-place collapse (``strategy.create_sliced_configs``)."""

    def build():
        rev = de.strategy.rev_global_input_ids
        row_sliced = de.strategy.row_sliced_tables
        smap: List = [None] * len(plan.instances)
        widths = []
        e = 0
        for i, tid in enumerate(de.strategy.input_table_map):
            pos, rows_split = 0, tid in row_sliced
            for s in range(de.slices_per_table[tid]):
                j = rev[e + s]
                w = plan.out_width(plan.instances[j])
                smap[j] = (i, 0 if rows_split else pos)
                pos = w if rows_split else pos + w
            widths.append(pos)
            e += de.slices_per_table[tid]
        return smap, widths

    return _cached(de, ("slice_map", id(plan)), build)


def _zero_rows(world, rows, cols):
    """A copy that zero-fills ``world * rows`` rows of ``cols``."""
    return (-1, 0, 0, 0, 0, cols, world * rows, cols)


def _ids_copy_plan(de, plan, entries) -> CopyPlan:
    """K19's copies: sources are the entries' tensors in input order (a
    dense entry one, a ragged one its values, lengths and weight bits)."""
    first, k = [], 0
    for e in entries:
        first.append(k)
        k += len(e) - 1 if isinstance(e, tuple) else 1
    world, b = de.world_size, plan.b
    if not plan.groups:
        return CopyPlan([_zero_rows(world, 1, plan.l_max)])
    copies = []
    for dest, row in enumerate(_cells(de, plan)):
        for gi, g in enumerate(plan.groups):
            for s, c in enumerate(row[gi]):
                off = dest * plan.l_max + g.goff + s * g.blen
                if c is _SPANNED:
                    continue
                if c is None:
                    copies.append((-1, 0, 0, 0, off, g.blen, 1, g.blen))
                    continue
                inst = plan.instances[c]
                e, src = entries[inst.input_id], first[inst.input_id]
                if isinstance(e, tuple):  # values, lengths[, weight bits]
                    for p, t in enumerate(e[1:]):
                        n = t.numel()
                        copies.append((src + p, 0, n, 0, off, n, 1, n))
                        off += n
                elif inst.transposed:  # [b, ns*h] -> slot-major [ns, b, h]
                    h, ns = g.hot, inst.num_slots
                    for t in range(ns):
                        copies.append((src, t * h, ns * h, 0,
                                       off + t * g.blen, h, b, h))
                else:
                    n = e.numel()
                    copies.append((src, 0, n, 0, off, n, 1, n))
    return CopyPlan(copies)


def _grad_copy_plan(de, plan, b: int) -> CopyPlan:
    """K20's cotangent copies: input ``i``'s ``[b, W_i]`` cotangent (read
    by rows, so it may be a column slice of a wider tensor), each of its
    column slices into its instance's columns of ``[world, b, s_max]``
    (a row-sliced table's whole cotangent into each of its slices': the
    JAX package's ``expanded.extend([g] * k)``); dead columns zero."""
    world, s_max = de.world_size, plan.s_max
    if not plan.groups:
        return CopyPlan([_zero_rows(world, b, s_max)])
    smap, widths = slice_map(de, plan)
    copies = []
    for j, inst in enumerate(plan.instances):
        i, pos = smap[j]
        g = plan.groups[inst.group]
        copies.append((i, pos, widths[i], 0,
                       inst.rank * b * s_max + g.col + inst.slot0 * g.width,
                       s_max, b, plan.out_width(inst)))
    for dest, row in enumerate(_cells(de, plan)):
        for gi, g in enumerate(plan.groups):
            for s, c in enumerate(row[gi]):
                if c is None:
                    copies.append((-1, 0, 0, 0, dest * b * s_max + g.col
                                   + s * g.width, s_max, b, g.width))
    return CopyPlan(copies, src_width=widths)


def lookup_copy_plan(de, plan) -> CopyPlan:
    """K20's lookup copies: group ``gi``'s ``[world * n, b, w]`` lookup,
    slot ``s`` of source rank ``r`` into columns ``g.col + s * w`` of row
    ``r`` of ``[world, b, s_max]``; this rank's dead slots zero."""

    def build():
        world, b, s_max = de.world_size, plan.b, plan.s_max
        if not plan.groups:
            return CopyPlan([_zero_rows(world, b, s_max)])
        copies = []
        for gi, g in enumerate(plan.groups):
            live = plan.valid[gi][de.rank] > 0
            for r in range(world):
                for s in range(g.n):
                    dst = r * b * s_max + g.col + s * g.width
                    copies.append(
                        (gi, (r * g.n + s) * b * g.width, g.width, 0, dst,
                         s_max, b, g.width) if live[s]
                        else (-1, 0, 0, 0, dst, s_max, b, g.width))
        return CopyPlan(copies)

    return _cached(de, ("lookup_copy", id(plan), de.rank), build)


def _unpack_copy_plan(de, plan):
    """K20's unpack: each instance's columns of source rank
    ``inst.rank`` into its input's output, the column slices of a sliced
    table side by side; a row-sliced table's slices SUMMED into its
    output, in slice order (one summing descriptor an input, the JAX
    package's ``total = total + part``). The outputs are consecutive
    ``[b, W_i]`` pieces of one buffer; returns ``(CopyPlan, [(offset,
    W_i)])``."""

    def build():
        b, s_max = plan.b, plan.s_max
        smap, widths = slice_map(de, plan)
        offs, o = [], 0
        for w in widths:
            offs.append(o)
            o += b * w
        row_sliced = de.strategy.row_sliced_tables
        copies, parts = [], {}
        # expanded order: inputs ascending, each input's slices in slice
        # order (the order the JAX package sums row slices in)
        for j in de.strategy.rev_global_input_ids:
            inst = plan.instances[j]
            i, pos = smap[j]
            g = plan.groups[inst.group]
            src_off = inst.rank * b * s_max + g.col + inst.slot0 * g.width
            if de.strategy.input_table_map[i] in row_sliced:
                parts.setdefault(i, []).append((0, src_off, s_max))
                continue
            copies.append((0, src_off, s_max, 0, offs[i] + pos, widths[i],
                           b, plan.out_width(inst)))
        sums = [(0, offs[i], widths[i], b, widths[i], p)
                for i, p in sorted(parts.items())]
        return CopyPlan(copies, sums=sums), list(zip(offs, widths))

    return _cached(de, ("unpack_copy", id(plan)), build)


# ------------------------------------------------------------- the blocks


def build_send_blocks(de, plan, entries, comm_dtype, device
                      ) -> torch.Tensor:
    """The id blocks ``[world, l_max]`` in the plan's group-region layout
    (K19). Dead slots send zeros; a multi-slot feature (no-combiner
    multi-hot, or N-D dense) sends its ids slot-major so each slot's ids
    stay contiguous; a ragged feature sends its values, then its row
    lengths, then (``"rw"``) its weight bits."""
    cplan = _cached(de, ("ids_copy", id(plan)),
                    lambda: _ids_copy_plan(de, plan, entries))
    srcs = [t.contiguous() for e in entries
            for t in (e[1:] if isinstance(e, tuple) else (e,))]
    out = torch.empty((de.world_size, plan.l_max), dtype=comm_dtype,
                      device=device)
    return pack_ids(cplan, srcs, out)


def pack_grad_blocks(de, plan, out_grads, b: int, out_dtype
                     ) -> torch.Tensor:
    """Pack the input-order output cotangents (``b * W_i`` elements each:
    ``[b, W_i]``, or ``[b, h, w]`` without a combiner) into the ``[world,
    b, s_max]`` column layout (K20): every column slice of a sliced
    table's cotangent goes to its instance's columns, dead columns are
    zero."""
    _, widths = slice_map(de, plan)
    srcs = []
    for i, (g, w) in enumerate(zip(out_grads, widths)):
        if g.numel() != b * w:
            raise ValueError(f"cotangent {i} of shape {tuple(g.shape)} "
                             f"does not match its output [{b}, {w}]")
        if g.dtype != out_dtype:
            g = g.to(out_dtype)
        if g.dim() != 2:
            g = g.reshape(b, w)
        # a column slice of a wider cotangent (autograd's gradient of a
        # stack) is read in place; only a strided column needs a copy
        srcs.append(g if g.stride(1) == 1 or w == 1 else g.contiguous())
    cplan = _cached(de, ("grad_copy", id(plan)),
                    lambda: _grad_copy_plan(de, plan, b))
    out = torch.empty((de.world_size, b, plan.s_max), dtype=out_dtype,
                      device=out_grads[0].device)
    pack_columns(cplan, srcs, [out])
    return out


def pack_lookup_rows(de, plan, reds, dtype, device) -> torch.Tensor:
    """The groups' ``[world, n, b, w]`` lookups as the ``[world, b,
    s_max]`` rows the output exchange sends, in ``dtype`` (K20, casting
    on the way); the columns of this rank's dead slots are zero."""
    out = torch.empty((de.world_size, plan.b, plan.s_max), dtype=dtype,
                      device=device)
    pack_columns(lookup_copy_plan(de, plan), [r.reshape(-1) for r in reds],
                 [out])
    return out


def unpack_outputs(de, plan, dp_recv) -> List[torch.Tensor]:
    """The received ``[world, b, s_max]`` rows as one ``[b, W_i]`` output
    per input, in input order (K20): each is a piece of one buffer."""
    cplan, pieces = _unpack_copy_plan(de, plan)
    buf = torch.empty(sum(plan.b * w for _, w in pieces),
                      dtype=dp_recv.dtype, device=dp_recv.device)
    pack_columns(cplan, [dp_recv.contiguous()], [buf])
    return [buf[o:o + plan.b * w].view(plan.b, w) for o, w in pieces]


# ------------------------------------------------------------ collectives


def wait(pending: bootstrap.InFlight, phase: str) -> torch.Tensor:
    """Wait for an exchange in flight, under its ``<phase>_wait`` scope
    (``phase`` the exchange's scope name, microbatch tag included)."""
    with obs.scope(f"{phase}_wait"):
        return pending.wait()


def exchange_ids_start(de, plan, entries, comm_dtype, device, tag: str = ""
                       ) -> bootstrap.InFlight:
    """Start the dp->mp id exchange: assemble the send blocks (K19) and
    leave the all-to-all in flight, under the ``id_all_to_all{tag}``
    scope. ``.wait()`` gives ``recv``: ``recv[r]`` is source rank ``r``'s
    block for this rank."""
    with obs.scope(schedule.PHASE_ID_EXCHANGE + tag):
        send = build_send_blocks(de, plan, entries, comm_dtype, device)
        return bootstrap.all_to_all_start(send, de.process_group,
                                          de.world_size)


def exchange_ids(de, plan, entries, comm_dtype, device, tag: str = ""
                 ) -> torch.Tensor:
    """The dp->mp id exchange: :func:`exchange_ids_start`, then its
    wait."""
    return wait(exchange_ids_start(de, plan, entries, comm_dtype, device,
                                   tag), schedule.PHASE_ID_EXCHANGE + tag)


def exchange_outputs_start(de, mp_out: torch.Tensor, tag: str = ""
                           ) -> bootstrap.InFlight:
    """Start the mp->dp activation exchange (``out_all_to_all{tag}``):
    ``.wait()`` gives ``dp_recv``, ``dp_recv[r]`` this rank's batch as
    computed by source rank ``r``."""
    with obs.scope(schedule.PHASE_OUT_EXCHANGE + tag):
        return bootstrap.all_to_all_start(mp_out, de.process_group,
                                          de.world_size)


def exchange_outputs(de, mp_out: torch.Tensor, tag: str = ""
                     ) -> torch.Tensor:
    """The mp->dp activation exchange: :func:`exchange_outputs_start`,
    then its wait."""
    return wait(exchange_outputs_start(de, mp_out, tag),
                schedule.PHASE_OUT_EXCHANGE + tag)


def exchange_grads_start(de, packed: torch.Tensor) -> bootstrap.InFlight:
    """Start the reverse cotangent exchange (what autodiff of the forward
    exchange would insert) on the packed ``[world, b, s_max]`` blocks.
    World 1 is a passthrough."""
    return bootstrap.all_to_all_start(packed, de.process_group,
                                      de.world_size)


def exchange_grads(de, packed: torch.Tensor, tag: str = "") -> torch.Tensor:
    """The reverse cotangent exchange: :func:`exchange_grads_start`, then
    its wait."""
    return wait(exchange_grads_start(de, packed),
                schedule.PHASE_GRAD_EXCHANGE + tag)


__all__: List[str] = [
    "assemble_cells", "build_send_blocks", "build_send_blocks_plain",
    "exchange_grads", "exchange_grads_start", "exchange_ids",
    "exchange_ids_start", "exchange_outputs", "exchange_outputs_start",
    "lookup_copy_plan", "pack_grad_blocks", "pack_grad_blocks_plain",
    "pack_lookup_rows",
    "slice_map", "unpack_outputs", "wait"]
