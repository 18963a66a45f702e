"""Lookup layer of the forward: plan-driven gathers and combiners
(counterpart of ``distributed_embeddings_tpu/parallel/lookup.py``).

Each (width, kind) group of the exchange plan is one kernel launch over
one slab and one id region, with the plan's per-slot ``rows``/``roff``/
divisor/mask as small device arrays:

* dense groups (kind ``"d"``, ``[world * n, b, hot]`` ids) on the gather
  kernel
  K1 (:func:`~..ops.embedding_lookup.gather_combine`);
* ragged groups (``"r"``: ``cap`` values then ``b`` lengths per slot;
  ``"rw"``: then ``cap`` weight bits) on K10, which turns the lengths
  into CSR offsets (:func:`~..ops.embedding_lookup.lengths_to_splits`),
  and the CSR gather-combine K8
  (:func:`~..ops.embedding_lookup.ragged_combine`), both reading the
  region in place.

A row-sliced slot (``row_slice=``) holds its table's rows ``[rbase,
rbase + rows)``: both kernels take the group's per-slot row bases and
subtract them from the ids before the clip, and the slot masks every id
outside its range to a zero read (a multiply by 0, as the JAX lookup
does), so the slices' outputs sum to the table's.

The JAX package decodes a ragged region into per-position arrays
(``csr_seg``, ``ragged_decode``, ``region_weights``,
``ragged_scatter_idx``) and scatters them; here K10 and K8 read the
region in place, and the tests hold them to those helpers.

At world > 1 the region holds one block per source rank, so each group
is one launch over ``world * n`` slots, with this rank's per-slot plan
row repeated per source; :func:`plan_lookup` lays the groups' lookups
out as the ``[world, b, s_max]`` rows the output exchange sends (K20).
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.embedding_lookup import (gather_combine, lengths_to_splits,
                                    ragged_combine)
from ..utils import obs
from . import exchange as exchange_mod


def _wkey(width: int) -> str:
    return f"w{width}"


def region_views(g, b: int, region: torch.Tensor):
    """``(values [m, cap], lengths [m, b], weights [m, cap] or None)``:
    strided views into a ragged group region ``[world, n * blen]``
    (``m = world * n``), no copy."""
    r2 = region.reshape(-1, g.blen)
    values = r2[:, :g.hot]
    lengths = r2[:, g.hot:g.hot + b]
    wbits = r2[:, g.hot + b:] if g.kind == "rw" else None
    return values, lengths, wbits


def plan_lookup(de, plan, params, ids_recv, tag: str = "") -> torch.Tensor:
    """All this rank's lookups in exchange-row layout ``[world, b,
    s_max]`` in ``compute_dtype`` (the cast before the output exchange,
    reference ``dist_model_parallel.py:300``): one launch per group, then
    ONE K20 launch that places every (source rank, slot) block at its
    columns, casting on the way; the columns of this rank's dead slots
    are zero. ``tag``: the microbatch tag of the groups' scopes."""
    reds = [lookup_group(de, plan, gi, g, params[_wkey(g.width)], ids_recv,
                         plan.b, out_dtype=params[_wkey(g.width)].dtype,
                         tag=tag)
            for gi, g in enumerate(plan.groups)]
    slab = next(iter(params.values()))
    return exchange_mod.pack_lookup_rows(
        de, plan, reds, de.compute_dtype or slab.dtype, slab.device)


def plan_lookup_groups(de, plan, params, ids_recv, tag: str = ""
                       ) -> List[torch.Tensor]:
    """Per-group combined lookups in slot-major ``[world, n, b, width]``
    layout, cast to the layer's ``compute_dtype``."""
    sections = []
    for gi, g in enumerate(plan.groups):
        red = lookup_group(de, plan, gi, g, params[_wkey(g.width)],
                           ids_recv, plan.b, tag=tag)
        dt = de.compute_dtype
        sections.append(red.to(dt) if dt is not None else red)
    return sections


def lookup_group(de, plan, gi: int, g, slab, ids_recv, b: int,
                 out_dtype=None, tag: str = "") -> torch.Tensor:
    """One exchange group's combined lookup ``[world, n, b, width]``,
    under the ``lookup_w{w}_{kind}{tag}`` scope. ``slab`` is this rank's
    ``[rows_cap, w]``; a ragged group's output is in ``out_dtype``
    (default the compute dtype, else the slab's), a dense group's in the
    slab's."""
    with obs.scope(f"lookup_w{g.width}_{g.kind}{tag}"):
        return _lookup_group(de, plan, gi, g, slab, ids_recv, b, out_dtype)


def _lookup_group(de, plan, gi, g, slab, ids_recv, b, out_dtype):
    world = de.world_size
    rows, roff, div, mask = de._plan_meta(plan, gi, slab.device, reps=world)
    rbase = de._plan_rbase(plan, gi, slab.device, reps=world)
    region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
    if g.kind == "d":
        ids = region.reshape(world * g.n, b, g.hot).contiguous()
        red = gather_combine(slab, ids, rows, roff, div, mask, rbase=rbase)
    else:
        mean, valid = de._plan_ragged_meta(plan, gi, slab.device,
                                           reps=world)
        values, lengths, wbits = region_views(g, b, region)
        splits = lengths_to_splits(lengths, valid)
        red = ragged_combine(slab, values, splits, rows, roff, mean=mean,
                             mask=mask, weights=wbits,
                             out_dtype=(out_dtype or de.compute_dtype
                                        or slab.dtype), rbase=rbase)
    return red.reshape(world, g.n, b, g.width)
