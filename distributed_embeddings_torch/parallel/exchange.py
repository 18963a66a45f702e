"""Exchange-block assembly (counterpart of the layout half of
``distributed_embeddings_tpu/parallel/exchange.py``).

The id blocks are laid out as the plan's rank-uniform group regions
(``parallel/plan.py``): each instance's ids at its (rank, group, slot)
cell, dead cells zero-filled, concatenated per destination rank; the
output cotangents pack the same way into the plan's column layout. At
world 1 each block IS the next stage's input (the exchange is a
passthrough), which is all the port runs so far; the all-to-alls and a
fused packing kernel are ROADMAP A7 / B4.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# Marks exchange-layout cells covered by a multi-cell content array placed
# at an earlier slot (no-combiner multi-hot features span `hotness` slots).
_SPANNED = object()


def assemble_cells(de, plan, fill, dead_shape, full_shape, dtype,
                   axis: int, device) -> torch.Tensor:
    """Place each instance's content at its (rank, group, slot0) cell —
    content spans all ``num_slots`` cells of a multi-slot instance —
    fill dead cells with zeros, concatenate in group/slot order per
    destination rank, and stack over ranks.

    Args:
      fill: ``fill(inst) -> tensor``, the instance's content in layout form.
      dead_shape: ``dead_shape(group) -> shape`` of one dead cell.
      full_shape: shape of an all-dead destination row (no-groups edge).
      dtype, device: of the content (zeros match them).
      axis: concat axis of the per-destination parts.
    """
    cells = [[[None] * g.n for g in plan.groups]
             for _ in range(de.world_size)]
    for inst in plan.instances:
        row = cells[inst.rank][inst.group]
        row[inst.slot0] = fill(inst)
        for k in range(1, inst.num_slots):
            row[inst.slot0 + k] = _SPANNED
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
                parts.append(dead(dead_shape(g)) if c is None else c)
        blocks.append(torch.cat(parts, dim=axis) if parts
                      else dead(full_shape))
    # one rank's block needs no second copy
    return blocks[0][None] if len(blocks) == 1 else torch.stack(blocks)


def build_send_blocks(de, plan, entries, comm_dtype, device
                      ) -> torch.Tensor:
    """Assemble the id blocks ``[world, l_max]`` in the plan's
    group-region layout. Dead slots send zeros; a multi-slot feature
    (no-combiner multi-hot, or N-D dense) sends its ids slot-major so
    each slot's ids stay contiguous; a ragged feature sends its values,
    then its row lengths, then (``"rw"``) its weight bits."""

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


def pack_grad_blocks(de, plan, grads_by_worker, b: int,
                     out_dtype) -> torch.Tensor:
    """Pack the output cotangents ``[world, b, s_max]`` in the plan's
    column layout (the reverse of the forward unpack): each worker-order
    instance's grad ``[b, num_slots * w]`` spans its columns, dead
    columns are zero."""
    device = next(iter(grads_by_worker.values())).device
    return assemble_cells(
        de, plan, fill=lambda inst: grads_by_worker[inst].to(out_dtype),
        dead_shape=lambda g: (b, g.width), full_shape=(b, plan.s_max),
        dtype=out_dtype, axis=1, device=device)


__all__: List[str] = ["assemble_cells", "build_send_blocks",
                      "pack_grad_blocks"]
