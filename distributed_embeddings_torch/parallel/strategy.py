"""Table-placement planner (counterpart of
``distributed_embeddings_tpu/parallel/strategy.py``, ported verbatim:
the planning algorithms are plain Python and device-agnostic).

Planned artifacts (names kept aligned with the JAX package and the
reference for parity checks):

* ``table_ids_list[r]``      — global (sliced) table ids owned by rank ``r``
* ``local_configs_list[r]``  — configs of the tables rank ``r`` owns
* ``input_ids_list[r]``      — global input indices routed to rank ``r``
* ``local_map_list[r]``      — local input → local table map on rank ``r``
* ``widths_list_flat``       — output widths in (rank-major) worker order
* ``rev_global_input_ids``   — permutation restoring caller input order
* ``sliced_out_ranges``      — output ranges to re-concat after column slicing

Not carried: ``predicted_cost``, which prices a plan through the JAX
package's ``analysis/plan_audit.py`` (ROADMAP A12).
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional, Sequence


Config = Dict[str, Any]

_STRATEGIES = ("basic", "memory_balanced", "memory_optimized",
               "comm_balanced", "telemetry_balanced")


def _table_elements(config: Config) -> int:
    return int(config["input_dim"]) * int(config["output_dim"])


def maybe_slice_table_column(orig_config: Config,
                             column_slice_threshold: Optional[int],
                             world_size: int) -> List[Config]:
    """Split a table width-wise into the smallest power-of-2 number of slices
    that brings each slice under ``column_slice_threshold`` elements, capped at
    ``min(world_size, output_dim)``; width remainder spread over the first
    slices (reference ``dist_model_parallel.py:100-131``)."""
    if column_slice_threshold is None:
        return [dict(orig_config)]
    elements = _table_elements(orig_config)
    num_slices = 1
    while elements > column_slice_threshold * num_slices:
        num_slices *= 2
    if num_slices == 1:
        return [dict(orig_config)]
    num_slices = min(num_slices, world_size, int(orig_config["output_dim"]))
    base, rem = divmod(int(orig_config["output_dim"]), num_slices)
    slices = []
    for i in range(num_slices):
        cfg = dict(orig_config)
        cfg["output_dim"] = base + (1 if i < rem else 0)
        slices.append(cfg)
    return slices


def maybe_slice_table_row(orig_config: Config,
                          row_slice_threshold: Optional[int],
                          world_size: int) -> List[Config]:
    """Split a table row-wise (vocab ranges) into the smallest power-of-2
    number of slices that brings each slice under ``row_slice_threshold``
    elements, capped at ``min(world_size, input_dim)``; row remainder spread
    over the first slices. Each slice carries its first global row in
    ``_row_base`` (consumed by the exchange plan and checkpoint paths).

    The reference declares-but-never-implements this mode
    (``dist_model_parallel.py:225,233-234``); semantics here mirror
    :func:`maybe_slice_table_column` with rows in place of columns. Unlike
    column slices (every slice serves every id, outputs concatenate), a row
    slice serves only ids inside its range — out-of-range ids read as zero
    rows — and slice outputs SUM.
    """
    if row_slice_threshold is None:
        return [dict(orig_config)]
    elements = _table_elements(orig_config)
    num_slices = 1
    while elements > row_slice_threshold * num_slices:
        num_slices *= 2
    if num_slices == 1:
        return [dict(orig_config)]
    num_slices = min(num_slices, world_size, int(orig_config["input_dim"]))
    base, rem = divmod(int(orig_config["input_dim"]), num_slices)
    slices, row_base = [], 0
    for i in range(num_slices):
        cfg = dict(orig_config)
        cfg["input_dim"] = base + (1 if i < rem else 0)
        cfg["_row_base"] = row_base
        row_base += cfg["input_dim"]
        slices.append(cfg)
    return slices


def apply_strategy(mode: str, world_size: int,
                   sliced_configs: List[List[Config]],
                   input_table_map: Optional[Sequence[int]] = None,
                   input_hotness: Optional[Sequence[int]] = None,
                   table_loads: Optional[Sequence[float]] = None
                   ) -> List[List[int]]:
    """Assign sliced tables to ranks; returns per-rank lists of global table ids
    (reference ``dist_model_parallel.py:160-196``).

    * ``basic``: round-robin in id order.
    * ``memory_balanced``: size-sorted snake deal — keeps per-rank table counts
      even while balancing bytes.
    * ``memory_optimized``: greedy largest-first onto the least-loaded rank —
      best byte balance, table counts may skew.
    * ``comm_balanced``: balances the *exchange*, not just bytes. The
      executor's output all-to-all pads each (width, hotness) slot group to
      the max per-rank slot count (``parallel/plan.py``), so skewed per-group
      counts turn into padded exchange bytes (measured 40%+ waste under
      ``memory_optimized`` on the tiny/small zoo, ``docs/perf_tpu.md``).
      Each table's group footprint — one slot in group ``(width, h)`` per
      input of hotness ``h`` it serves (hotness from ``input_hotness`` when
      given, else assumed 1) — is placed greedily, largest footprint first,
      on the rank that minimally grows the total padded exchange width
      ``sum_g w_g * max_r n_{g,r}``, tie-broken by byte load. Directly
      minimizes the executor's padding objective while keeping bytes close.
    * ``telemetry_balanced``: balances MEASURED per-table traffic
      (``table_loads``, e.g. from
      :func:`...analysis.telemetry.table_loads_from_summary`) instead of
      bytes — the feedback half of the telemetry observatory (ROADMAP
      item 2b). Slices are placed greedily, heaviest measured load first,
      on the least-loaded rank (ties broken by byte load, then rank id).
      A table's load spreads evenly over its slices — exact for column
      slices' bytes-per-id and the uniform-range approximation for row
      slices (per-range traffic is not in the summary). Cold tables
      (load 0) fall back to pure byte balancing via the tie-break.
    """
    flat_ids: List[int] = []
    flat_sizes: List[int] = []
    flat_widths: List[int] = []
    for tid, slices in enumerate(sliced_configs):
        for cfg in slices:
            flat_ids.append(tid)
            flat_sizes.append(_table_elements(cfg))
            flat_widths.append(int(cfg["output_dim"]))

    if mode == "basic":
        return [flat_ids[r::world_size] for r in range(world_size)]

    if mode == "memory_balanced":
        order = [tid for _, tid in
                 sorted(zip(flat_sizes, flat_ids), reverse=True)]
        period = 2 * world_size
        return [order[r::period] + order[period - 1 - r::period]
                for r in range(world_size)]

    if mode == "memory_optimized":
        by_size = sorted(zip(flat_sizes, flat_ids))
        bins: List[List[Any]] = [[0, []] for _ in range(world_size)]
        while by_size:
            size, tid = by_size.pop()
            bins[0][0] += size
            bins[0][1].append(tid)
            bins.sort()
        return [b[1] for b in bins]

    if mode == "comm_balanced":
        itm = (list(input_table_map) if input_table_map is not None
               else list(range(len(sliced_configs))))
        hot = (list(input_hotness) if input_hotness is not None
               else [1] * len(itm))
        # hotness multiset per source table; every slice of it inherits
        table_hots: Dict[int, Counter] = defaultdict(Counter)
        for i, tid in enumerate(itm):
            table_hots[tid][int(hot[i])] += 1
        # slice footprint: slots contributed per (width, hotness) group.
        # NOTE (ADVICE r3): slice widths are modeled by flat position, but
        # DistEmbeddingStrategy hands a table's slices to ranks FIFO in rank
        # order, so when the width remainder spreads base+1 columns over the
        # first slices, the slice a rank receives can be one column narrower/
        # wider than the one this objective counted. Bounded by one column
        # per (table, rank) pair — noise next to the padding term — so the
        # modeling error is accepted rather than threading slice identity
        # through the assignment.
        items = []
        for pos, (tid, size, w) in enumerate(
                zip(flat_ids, flat_sizes, flat_widths)):
            groups = {(w, h): c for h, c in table_hots[tid].items()}
            fp = w * sum(table_hots[tid].values())  # output columns it adds
            items.append((fp, size, pos, tid, groups))
        items.sort(key=lambda t: (-t[0], -t[1], t[2]))  # LPT on columns
        n: Dict[tuple, List[int]] = defaultdict(lambda: [0] * world_size)
        loads = [0] * world_size
        out: List[List[tuple]] = [[] for _ in range(world_size)]
        for fp, size, pos, tid, groups in items:
            best, best_key = None, None
            for r in range(world_size):
                # marginal growth of the padded exchange width
                delta = 0
                for (w, h), c in groups.items():
                    cur_max = max(n[(w, h)])
                    delta += w * max(0, n[(w, h)][r] + c - cur_max)
                key = (delta, loads[r], r)
                if best_key is None or key < best_key:
                    best, best_key = r, key
            out[best].append((pos, tid))
            loads[best] += size
            for (w, h), c in groups.items():
                n[(w, h)][best] += c
        return [[tid for _, tid in sorted(rank)] for rank in out]

    if mode == "telemetry_balanced":
        if table_loads is None:
            raise ValueError(
                "telemetry_balanced needs table_loads= (per-global-table "
                "measured traffic, e.g. analysis.telemetry."
                "table_loads_from_summary of a flushed telemetry summary)")
        if len(table_loads) != len(sliced_configs):
            raise ValueError(
                f"table_loads has {len(table_loads)} entries but there are "
                f"{len(sliced_configs)} tables (it is per-table)")
        per_slice_load = [float(table_loads[tid]) / len(sliced_configs[tid])
                          for tid in flat_ids]
        # LPT on measured load; stable position index keeps ties
        # deterministic across processes (every rank must plan identically)
        order = sorted(range(len(flat_ids)),
                       key=lambda i: (-per_slice_load[i], -flat_sizes[i], i))
        loads = [0.0] * world_size
        sizes = [0] * world_size
        out = [[] for _ in range(world_size)]
        for i in order:
            r = min(range(world_size),
                    key=lambda r: (loads[r], sizes[r], r))
            out[r].append((i, flat_ids[i]))
            loads[r] += per_slice_load[i]
            sizes[r] += flat_sizes[i]
        return [[tid for _, tid in sorted(rank)] for rank in out]

    raise ValueError(f"Unsupported strategy {mode}")


# ------------------------------------------------------- plan fingerprints


#: plan_spec keys that determine the physical layout of checkpointed state.
#: Two plans whose material keys match restore identically regardless of
#: the strategy LABEL that produced them (e.g. a basic and a
#: memory_balanced plan that happen to agree).
_MATERIAL_PLAN_KEYS = ("world_size", "table_ids_list", "local_tables")


def _canon(x):
    """JSON-normalize (tuples -> lists, numpy ints -> ints) so specs read
    back from a ``meta.json`` compare equal to freshly computed ones."""
    return json.loads(json.dumps(x))


def plans_equal(a: Optional[Dict[str, Any]],
                b: Optional[Dict[str, Any]]) -> bool:
    """Material equality of two :meth:`DistEmbeddingStrategy.plan_spec`
    dicts: same world size, same rank->tables assignment, same per-rank
    slice geometry. The strategy *name* and thresholds are advisory (they
    describe how the plan was derived, not what it is)."""
    if a is None or b is None:
        return False
    return all(_canon(a.get(k)) == _canon(b.get(k))
               for k in _MATERIAL_PLAN_KEYS)


def plan_diff(old: Optional[Dict[str, Any]], new: Dict[str, Any],
              param_bytes: int = 4) -> Dict[str, Any]:
    """Structured diff of two plan specs — what the re-shard dry run
    prints and what the degradation log records on an elastic resume.

    Returns world sizes, strategy labels, per-rank byte loads under both
    plans (``param_bytes`` per table element; pass 2 for bf16 tables),
    per-rank deltas over the common ranks, and the tables whose owning
    rank set changed. ``old`` may be ``None`` (pre-plan-manifest
    checkpoint): the old half is then reported as unknown."""
    def rank_bytes(spec):
        if spec is None or "per_rank_elements" not in spec:
            return None
        return [int(e) * param_bytes for e in spec["per_rank_elements"]]

    def owners(spec):
        if spec is None:
            return {}
        own: Dict[int, List[int]] = {}
        for r, tids in enumerate(spec.get("table_ids_list", [])):
            for tid in tids:
                own.setdefault(int(tid), []).append(r)
        return own

    old_b, new_b = rank_bytes(old), rank_bytes(new)
    deltas = None
    if old_b is not None and new_b is not None:
        deltas = [new_b[r] - old_b[r]
                  for r in range(min(len(old_b), len(new_b)))]
    old_own, new_own = owners(old), owners(new)
    moved = sorted(t for t in new_own
                   if old_own and old_own.get(t) != new_own[t])
    return {
        "equal": plans_equal(old, new),
        "world_size": [old.get("world_size") if old else None,
                       new.get("world_size")],
        "strategy": [old.get("strategy") if old else None,
                     new.get("strategy")],
        "per_rank_bytes_old": old_b,
        "per_rank_bytes_new": new_b,
        "per_rank_byte_deltas": deltas,
        "moved_tables": moved,
    }


class DistEmbeddingStrategy:
    """Global placement plan: slicing, rank assignment, and routing index maps.

    Args:
      configs: per-table config dicts (must carry ``input_dim``/``output_dim``;
        other keys — initializer, combiner, dtype — pass through to the local
        table configs). Accepts :class:`...layers.Embedding` modules too.
      world_size: number of model-parallel positions on the mesh axis.
      strategy: one of ``basic | memory_balanced | memory_optimized``.
      input_table_map: ``input[i]`` looks up ``table[input_table_map[i]]``;
        ``None`` means the identity (shared tables = repeated ids).
      column_slice_threshold: max elements per table slice (power-of-2 split).
      input_hotness: optional per-input hotness hint used only by the
        ``comm_balanced`` strategy to model the executor's (width, hotness)
        exchange groups exactly; placement stays valid without it.
      table_loads: per-global-table measured traffic weights, required by
        (and only used by) the ``telemetry_balanced`` strategy — feed it
        :func:`...analysis.telemetry.table_loads_from_summary` of a
        flushed telemetry summary.
    """

    def __init__(self,
                 configs: Sequence[Any],
                 world_size: int,
                 strategy: str = "basic",
                 input_table_map: Optional[Sequence[int]] = None,
                 column_slice_threshold: Optional[int] = None,
                 input_hotness: Optional[Sequence[int]] = None,
                 row_slice_threshold: Optional[int] = None,
                 table_loads: Optional[Sequence[float]] = None):
        if strategy not in _STRATEGIES:
            raise ValueError(f"Unsupported shard strategy {strategy}")
        self.strategy = strategy
        self.world_size = world_size
        self.column_slice_threshold = column_slice_threshold
        self.row_slice_threshold = row_slice_threshold
        self.table_loads = (None if table_loads is None
                            else [float(x) for x in table_loads])
        self.global_configs = [
            c.get_config() if hasattr(c, "get_config") else dict(c)
            for c in configs]
        if input_table_map is None:
            input_table_map = list(range(len(self.global_configs)))
        if len(input_table_map) and max(input_table_map) >= len(self.global_configs):
            raise ValueError("input_table_map refers to a nonexistent table")
        self.input_table_map = list(input_table_map)
        if (input_hotness is not None
                and len(input_hotness) != len(self.input_table_map)):
            raise ValueError(
                f"input_hotness has {len(input_hotness)} entries but there "
                f"are {len(self.input_table_map)} inputs (it is per-input, "
                "not per-table)")
        if (self.table_loads is not None
                and len(self.table_loads) != len(self.global_configs)):
            raise ValueError(
                f"table_loads has {len(self.table_loads)} entries but "
                f"there are {len(self.global_configs)} tables")

        if world_size == 1:
            self.local_configs = self.global_configs
            self.local_input_table_map = self.input_table_map
            self.input_ids_list = [list(range(len(self.input_table_map)))]
            self.table_ids_list = [list(range(len(self.global_configs)))]
            self.local_configs_list = [self.global_configs]
            self.local_map_list = [self.local_input_table_map]
            self.widths_list_flat = [
                int(self.global_configs[t]["output_dim"])
                for t in self.input_table_map]
            self.rev_global_input_ids = list(range(len(self.input_table_map)))
            self.sliced_out_ranges = []
            self.row_sliced_out_ranges = []
            self.row_sliced_tables = set()
            return

        (sliced_configs, self.sliced_out_ranges,
         self.row_sliced_out_ranges, self.row_sliced_tables) = \
            self.create_sliced_configs(
                world_size, column_slice_threshold, self.input_table_map,
                row_slice_threshold)
        self.table_ids_list = apply_strategy(strategy, world_size,
                                             sliced_configs,
                                             self.input_table_map,
                                             input_hotness,
                                             table_loads=self.table_loads)

        # Build the global routing view, consuming each table's slices in rank
        # order (reference dist_model_parallel.py:70-98).
        remaining = [list(slices) for slices in sliced_configs]
        self.input_ids_list: List[List[int]] = []
        self.local_map_list: List[List[int]] = []
        self.local_configs_list: List[List[Config]] = []
        self.widths_list_flat: List[int] = []
        for rank_table_ids in self.table_ids_list:
            rank_configs: List[Config] = []
            rank_input_ids: List[int] = []
            rank_input_map: List[int] = []
            for m, table_idx in enumerate(rank_table_ids):
                cfg = remaining[table_idx].pop(0)
                rank_configs.append(cfg)
                for k, mapped in enumerate(self.input_table_map):
                    if mapped == table_idx:
                        self.widths_list_flat.append(int(cfg["output_dim"]))
                        rank_input_ids.append(k)
                        rank_input_map.append(m)
            self.local_configs_list.append(rank_configs)
            self.input_ids_list.append(rank_input_ids)
            self.local_map_list.append(rank_input_map)

        worker_order_input_ids = [
            i for rank_ids in self.input_ids_list for i in rank_ids]
        self.rev_global_input_ids = [
            pos for _, pos in sorted(
                zip(worker_order_input_ids, range(len(worker_order_input_ids))))]

    def create_sliced_configs(self, world_size: int,
                              column_slice_threshold: Optional[int],
                              input_table_map: Sequence[int],
                              row_slice_threshold: Optional[int] = None):
        """Slice each oversized table and record, in *input order*, the
        output ranges to reassemble: column slices concatenate (reference
        ``dist_model_parallel.py:133-157``), row slices sum.

        Column slicing takes precedence; a table it split is not row-sliced
        (the two thresholds express the same capacity constraint, and a
        doubly-sliced table would need a 2-D slice grid the exchange layout
        has no use for).

        Range bookkeeping invariant: ranges are expressed as
        ``[input_id, input_id + num_slices]`` and consumed in increasing input
        order with in-place collapse — after collapsing all earlier ranges each
        input's expanded output block starts exactly at its input id. The
        forward must therefore process column and row ranges together in
        ascending input order.
        """
        sliced_configs = []
        row_sliced_tables = set()
        for tid, cfg in enumerate(self.global_configs):
            col = maybe_slice_table_column(cfg, column_slice_threshold,
                                           world_size)
            if len(col) > 1:
                sliced_configs.append(col)
                continue
            row = maybe_slice_table_row(cfg, row_slice_threshold, world_size)
            if len(row) > 1:
                row_sliced_tables.add(tid)
            sliced_configs.append(row)
        sliced_out_ranges = []
        row_sliced_out_ranges = []
        for input_id, table_id in enumerate(input_table_map):
            if len(sliced_configs[table_id]) > 1:
                rng = [input_id, input_id + len(sliced_configs[table_id])]
                if table_id in row_sliced_tables:
                    row_sliced_out_ranges.append(rng)
                else:
                    sliced_out_ranges.append(rng)
        return (sliced_configs, sliced_out_ranges, row_sliced_out_ranges,
                row_sliced_tables)

    # ----- derived views used by the executor -----

    def local_table_sizes(self, rank: int) -> int:
        return sum(_table_elements(c) for c in self.local_configs_list[rank])

    def plan_spec(self) -> Dict[str, Any]:
        """JSON-able fingerprint of this plan — recorded in every
        checkpoint's ``meta.json`` so restore can tell "same layout" from
        "needs a re-shard" (:func:`plans_equal`) and the re-shard tooling
        can diff placements (:func:`plan_diff`).

        ``local_tables[r]`` lists, per local table ``m``,
        ``[table_id, rows, width, row_base, col_start]`` — the same slice
        geometry the checkpoint codec routes by (column slices consumed
        in rank order, row slices carrying their first global row)."""
        col_pos = {tid: 0 for tid in range(len(self.global_configs))}
        local_tables: List[List[List[int]]] = []
        for r, cfgs in enumerate(self.local_configs_list):
            rank_entries = []
            for m, cfg in enumerate(cfgs):
                tid = self.table_ids_list[r][m]
                w = int(cfg["output_dim"])
                if tid in self.row_sliced_tables:
                    rank_entries.append(
                        [tid, int(cfg["input_dim"]), w,
                         int(cfg.get("_row_base", 0)), 0])
                else:
                    rank_entries.append(
                        [tid, int(cfg["input_dim"]), w, 0, col_pos[tid]])
                    col_pos[tid] += w
            local_tables.append(rank_entries)
        return {
            "world_size": int(self.world_size),
            "strategy": self.strategy,
            "column_slice_threshold": self.column_slice_threshold,
            "row_slice_threshold": self.row_slice_threshold,
            "table_ids_list": [list(map(int, t))
                               for t in self.table_ids_list],
            "local_tables": local_tables,
            "per_rank_elements": [self.local_table_sizes(r)
                                  for r in range(self.world_size)],
        }

    @property
    def num_inputs(self) -> int:
        return len(self.input_table_map)

    def describe(self, param_bytes: int = 4) -> str:
        """Human-readable placement summary. ``param_bytes``: bytes per
        table element (pass 2 for bf16 tables — the benched headline
        variant; the planner itself is dtype-agnostic, VERDICT r4 Weak
        #7)."""
        lines = [f"DistEmbeddingStrategy(strategy={self.strategy}, "
                 f"world_size={self.world_size})"]
        for r, (tids, cfgs) in enumerate(
                zip(self.table_ids_list, self.local_configs_list)):
            bytes_ = sum(_table_elements(c) for c in cfgs) * param_bytes
            lines.append(f"  rank {r}: tables {tids} ({bytes_ / 2**20:.1f} MiB)")
        return "\n".join(lines)
