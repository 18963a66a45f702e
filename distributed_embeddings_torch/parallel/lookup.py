"""Lookup layer of the forward: plan-driven gathers and combiners
(counterpart of ``distributed_embeddings_tpu/parallel/lookup.py``).

Each (width, kind) group of the exchange plan is one launch of the
gather kernel (K1): one slab, one ``[n, b, hot]`` id region, and the
plan's per-slot ``rows``/``roff``/divisor/mask as small device arrays.
Dense groups (kind ``"d"``) are ported; ragged groups (``"r"``/``"rw"``)
are ROADMAP queue B5 and raise.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.embedding_lookup import gather_combine


def _wkey(width: int) -> str:
    return f"w{width}"


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
    """One exchange group's combined lookup ``[world, n, b, width]`` on
    the gather kernel. ``slab`` is this rank's ``[rows_cap, w]``."""
    if g.kind != "d":
        raise NotImplementedError(
            f"lookup group kind {g.kind!r} (ragged) is not ported yet: "
            "ROADMAP queue B5")
    world = de.world_size
    rows, roff, div, mask = de._plan_meta(plan, gi, slab.device)
    region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
    ids = region.reshape(world * g.n, b, g.hot).contiguous()
    red = gather_combine(slab, ids, rows, roff, div, mask)
    return red.reshape(world, g.n, b, g.width)
