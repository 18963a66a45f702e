"""Static exchange plans for the rank-uniform executor.

The reference executes per-rank heterogeneity as per-rank *programs*: each
Horovod process builds only its local layers and runs its own Python loop
over them (``dist_model_parallel.py:261-311``). The first TPU port of that
idea expressed the same thing as ``lax.switch`` over rank-specialized
branches — but SPMD compiles every branch on every device, so HLO grew as
O(world x tables) and colossal-scale models (2002 tables,
``config_v3.py:107-121``) became a compile-time cliff.

This module makes per-rank heterogeneity *data* instead of *program*. The
id-exchange block and the output-exchange row are laid out as a sequence of
**group regions at static offsets that are identical on every rank**:

* a *dense group* ``(width w, hotness h)`` holds ``n`` slots, each slot one
  combiner lookup: ``b*h`` ids in the block, ``w`` output columns;
* a *ragged group* ``(width w, capacity c)`` holds ``n`` slots, each slot one
  static-capacity CSR feature: ``c`` values + ``b`` lengths in the block,
  ``w`` output columns;
* ``n`` is the max slot count over ranks — ranks with fewer tables of that
  shape pad with dead slots (zero ids in, never-read columns out).

What *differs* per rank — which table a slot reads (row count, slab row
offset), its combiner, whether the slot is live — is carried in small
``[world, n]`` plan tensors indexed by ``lax.axis_index`` at run time. One
compiled program serves every mesh position: per group, ONE reshape of the
block region, ONE slab gather, ONE reduction — O(#groups) heavy HLO ops
total, independent of world size and table count.

A multi-hot feature *without* a combiner ([batch, h] ids -> [batch, h*w]
activations) is expressed as ``h`` consecutive hotness-1 slots; its ids
travel column-major ([h, b]) so each slot's ids stay contiguous.

Plans depend on the per-input encodings and the local batch size, both known
only at trace time, so :class:`~.dist_embedding.DistributedEmbedding` builds
them lazily and caches by ``(encodings, batch)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One rank-uniform region of the exchange layout."""

    kind: str    # "d" dense | "r" ragged | "rw" ragged with per-id weights
    width: int   # per-slot output width (the column-slice width for slices)
    hot: int     # dense: ids per batch row per slot; ragged: value capacity
    n: int       # slots (max over ranks; shorter ranks are padded)
    blen: int    # ints one slot occupies per source block
    goff: int    # region start within the [l_max] id block
    col: int     # region start within the [s_max] output row


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """One routed input on one rank (worker-order entry).

    ``num_slots > 1`` for no-combiner multi-hot features (one slot per hot
    position, ids sent column-major) and for N-D dense combiner inputs
    (``[b, d1, ..., h]``: one hotness-``h`` slot per lead position — the
    reference flattens such inputs through its exchange the same way,
    ``dist_model_parallel.py:273-288``)."""

    input_id: int
    rank: int
    group: int
    slot0: int
    num_slots: int

    @property
    def transposed(self) -> bool:
        return self.num_slots > 1


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Complete static layout + per-rank plan tensors for one input signature.

    Plan arrays are all ``[world, n_g]`` numpy, one per group:

    * ``rows``  — table row count a slot reads (1 for dead slots);
    * ``roff``  — slot's table row offset inside its width slab;
    * ``valid`` — 1.0 for live slots, 0.0 for padding (backward routes dead
      slots' ids to the dropped sentinel);
    * ``mean``  — 1.0 where the slot's combiner is ``'mean'`` (forward
      divides the reduced sum, backward divides the cotangent);
    * ``rbase`` — slot's first global row for row-sliced tables (subtracted
      from incoming ids; out-of-slice ids read zero forward and drop
      backward). 0 everywhere else;
    * ``rsliced`` — 1.0 exactly for row-sliced slots (``rbase`` can't mark
      them: a table's FIRST row slice has base 0). Gates the forward
      zero-read mask per slot so unsliced tables sharing the group keep the
      documented clip-to-last-row read.
    """

    b: int
    groups: Tuple[GroupSpec, ...]
    instances: Tuple[InstanceSpec, ...]
    l_max: int
    s_max: int
    rows: Tuple[np.ndarray, ...]
    roff: Tuple[np.ndarray, ...]
    valid: Tuple[np.ndarray, ...]
    mean: Tuple[np.ndarray, ...]
    rbase: Tuple[np.ndarray, ...]
    rsliced: Tuple[np.ndarray, ...]

    def out_width(self, inst: InstanceSpec) -> int:
        return self.groups[inst.group].width * inst.num_slots


def build_plan(strategy, row_offsets_list: Sequence[Sequence[int]],
               encs: Sequence[tuple], b: int) -> ExchangePlan:
    """Build the exchange plan for one input signature.

    Args:
      strategy: a planned :class:`~.strategy.DistEmbeddingStrategy`.
      row_offsets_list: per-rank per-local-table logical slab row offsets.
      encs: per global input: dense ``("d", hotness[, num_slots])`` (the
        third element — N-D lead positions — defaults to 1) or ragged
        ``("r", capacity)`` / ``("rw", capacity)`` (per-id weights ride
        the block as bitcast floats past the lengths).
      b: per-shard batch size.
    """
    world = strategy.world_size
    # pass 1: per-rank slot lists per group key, in worker order
    key_slots: Dict[tuple, List[list]] = {}
    inst_raw = []  # (input_id, rank, key, slot0, num_slots)
    for r in range(world):
        for j, i in enumerate(strategy.input_ids_list[r]):
            m = strategy.local_map_list[r][j]
            cfg = strategy.local_configs_list[r][m]
            w = int(cfg["output_dim"])
            # row offsets stay < 2^31 in practice: physical slab rows are
            # HBM-bounded and roff <= phys_rows * pack_factor
            rows = int(cfg["input_dim"])
            roff = int(row_offsets_list[r][m])
            comb = cfg.get("combiner")
            rbase = int(cfg.get("_row_base", 0))
            rsl = 1.0 if "_row_base" in cfg else 0.0
            enc = encs[i]
            kind, param = enc[0], int(enc[1])
            nslots = int(enc[2]) if len(enc) > 2 else 1
            if kind == "d":
                if comb:
                    # N-D inputs: one hotness-`param` slot per lead position
                    key = ("d", w, param)
                    entries = [(rows, roff, 1.0,
                                1.0 if comb == "mean" else 0.0, rbase, rsl)
                               ] * nslots
                else:
                    key = ("d", w, 1)
                    entries = [(rows, roff, 1.0, 0.0, rbase, rsl)
                               ] * (param * nslots)
            else:
                if comb is None:
                    # without this, a combiner-less table would silently get
                    # the mean-flag 0.0, i.e. 'sum' semantics (ADVICE r3)
                    raise ValueError(
                        f"Input {i} is Ragged but table "
                        f"{strategy.input_table_map[i]} has no combiner; "
                        "ragged features require combiner='sum' or 'mean'")
                key = (kind, w, param)  # "r" | "rw" (per-id weights ride
                # the block as bitcast floats, so weighted features group
                # separately — their slots are one capacity longer)
                entries = [(rows, roff, 1.0,
                            1.0 if comb == "mean" else 0.0, rbase, rsl)]
            slots = key_slots.setdefault(key, [[] for _ in range(world)])
            inst_raw.append((i, r, key, len(slots[r]), len(entries)))
            slots[r].extend(entries)

    # pass 2: deterministic group order, cumulative offsets, plan tensors
    keys = sorted(key_slots)
    gidx = {k: g for g, k in enumerate(keys)}
    groups = []
    rows_l, roff_l, valid_l, mean_l, rbase_l, rsl_l = [], [], [], [], [], []
    goff = col = 0
    for k in keys:
        slots = key_slots[k]
        kind, w, hp = k
        n = max(len(s) for s in slots)
        blen = {"d": b * hp, "r": hp + b, "rw": 2 * hp + b}[kind]
        groups.append(GroupSpec(kind, w, hp, n, blen, goff, col))
        goff += n * blen
        col += n * w
        rows_a = np.ones((world, n), np.int32)
        roff_a = np.zeros((world, n), np.int32)
        val_a = np.zeros((world, n), np.float32)
        mn_a = np.zeros((world, n), np.float32)
        rb_a = np.zeros((world, n), np.int32)
        rs_a = np.zeros((world, n), np.float32)
        for r in range(world):
            for kk, (tr, to, tv, tm, trb, trs) in enumerate(slots[r]):
                rows_a[r, kk], roff_a[r, kk] = tr, to
                val_a[r, kk], mn_a[r, kk] = tv, tm
                rb_a[r, kk], rs_a[r, kk] = trb, trs
        rows_l.append(rows_a)
        roff_l.append(roff_a)
        valid_l.append(val_a)
        mean_l.append(mn_a)
        rbase_l.append(rb_a)
        rsl_l.append(rs_a)

    instances = tuple(
        InstanceSpec(i, r, gidx[k], s0, ns) for i, r, k, s0, ns in inst_raw)
    return ExchangePlan(
        b=b, groups=tuple(groups), instances=instances,
        l_max=max(goff, 1), s_max=max(col, 1),
        rows=tuple(rows_l), roff=tuple(roff_l),
        valid=tuple(valid_l), mean=tuple(mean_l), rbase=tuple(rbase_l),
        rsliced=tuple(rsl_l))
