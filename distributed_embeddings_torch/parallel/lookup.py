"""Lookup layer of the forward: plan-driven gathers and combiners
(counterpart of ``distributed_embeddings_tpu/parallel/lookup.py``).

Each (width, kind) group of the exchange plan is one kernel launch over
one slab and one id region, with the plan's per-slot ``rows``/``roff``/
divisor/mask as small device arrays:

* dense groups (kind ``"d"``, ``[n, b, hot]`` ids) on the gather kernel
  K1 (:func:`~..ops.embedding_lookup.gather_combine`);
* ragged groups (``"r"``: ``cap`` values then ``b`` lengths per slot;
  ``"rw"``: then ``cap`` weight bits) on K10, which turns the lengths
  into CSR offsets (:func:`~..ops.embedding_lookup.lengths_to_splits`),
  and the CSR gather-combine K8
  (:func:`~..ops.embedding_lookup.ragged_combine`), both reading the
  region in place. Row-sliced slots (ROADMAP A9) raise.

The JAX package decodes a ragged region into per-position arrays
(``csr_seg``, ``ragged_decode``, ``region_weights``,
``ragged_scatter_idx``) and scatters them; here K10 and K8 read the
region in place, and the tests hold them to those helpers.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.embedding_lookup import (gather_combine, lengths_to_splits,
                                    ragged_combine)


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


def plan_lookup_groups(de, plan, params, ids_recv) -> List[torch.Tensor]:
    """Per-group combined lookups in slot-major ``[world, n, b, width]``
    layout, cast to the layer's ``compute_dtype``."""
    sections = []
    for gi, g in enumerate(plan.groups):
        red = lookup_group(de, plan, gi, g, params[_wkey(g.width)],
                           ids_recv, plan.b)
        dt = de.compute_dtype
        sections.append(red.to(dt) if dt is not None else red)
    return sections


def lookup_group(de, plan, gi: int, g, slab, ids_recv,
                 b: int) -> torch.Tensor:
    """One exchange group's combined lookup ``[world, n, b, width]``.
    ``slab`` is this rank's ``[rows_cap, w]``."""
    if plan.rsliced[gi].any():
        raise NotImplementedError(
            "the lookup of row-sliced slots is not ported yet: ROADMAP A9")
    world = de.world_size
    rows, roff, div, mask = de._plan_meta(plan, gi, slab.device)
    region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
    if g.kind == "d":
        ids = region.reshape(world * g.n, b, g.hot).contiguous()
        red = gather_combine(slab, ids, rows, roff, div, mask)
    else:
        mean, valid = de._plan_ragged_meta(plan, gi, slab.device)
        values, lengths, wbits = region_views(g, b, region)
        splits = lengths_to_splits(lengths, valid)
        red = ragged_combine(slab, values, splits, rows, roff, mean=mean,
                             mask=mask, weights=wbits,
                             out_dtype=de.compute_dtype or slab.dtype)
    return red.reshape(world, g.n, b, g.width)
