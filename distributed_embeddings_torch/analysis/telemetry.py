"""Access telemetry: per-width hot-row sketches and per-rank load
accounting, carried through the train step (counterpart of
``distributed_embeddings_tpu/analysis/telemetry.py``).

The state is a plain dict of tensors with JAX's keys and dtypes, every
leaf with a leading axis of 1: JAX's ``[world]`` axis at world 1, and at
world > 1 this rank's row of it (each rank holds its own, as it holds
its own slabs): ``steps`` (int32 ``[1, 1]``), ``ids_total`` (float32
``[1, 1]``) and per width slab ``"w<width>"``: ``cms`` (the count-min
sketch, int32 ``[1, depth, buckets]``), ``topk_ids``/``topk_est`` (int32
``[1, topk]``, the carried hot rows and their estimates) and ``ids``
(float32 ``[1, 1]``, the width's cumulative live ids). At world > 1
:func:`gather_state` (a collective) gives every rank JAX's ``[world,
...]`` leaves on the host, and the host summaries (:func:`hot_rows`,
:func:`load_balance`, :func:`summarize_telemetry`) read through it. The
emission point is
:meth:`~..parallel.dist_embedding.DistributedEmbedding.update_telemetry`,
the threading ``make_hybrid_train_step(telemetry=...)``.

The step updates the state IN PLACE (the JAX step donates it): the
sketch update, the candidate pool and the top-k merge run on the
hand-written kernels K13-K15 (``ops/sketch.py``), replayed for a width
from one launch record (``ops/sketch.py:fold_ids``), and on their plain
versions for CPU tensors. A count-min sketch only over-estimates, so a
row reported cold is cold; ids are logical slab rows, mapped back to
``(table, row)`` on the host by :func:`hot_rows`.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import packed_slab as ps
from ..ops.sketch import TOPK_EMPTY, buckets_of_plain
# the kernel wrappers, under names of their own (a module global each, so
# a caller can route them to their plain versions)
from ..ops.sketch import cms_query as sketch_query
from ..ops.sketch import cms_update as sketch_update
from ..ops.sketch import fold_ids as sketch_fold
from ..utils import envvars
from ..utils.device import resolve_device


class TelemetryConfig(NamedTuple):
    """Static telemetry geometry (hashable; fixed when a step is built)."""

    depth: int = 4        #: count-min sketch rows (independent hashes)
    buckets: int = 2048   #: count-min sketch columns per row
    topk: int = 32        #: hot-row slots carried per width slab
    candidates: int = 128  #: per-step unique-id candidates merged into top-k


def telemetry_enabled() -> bool:
    """Whether ``DETPU_TELEMETRY`` asks for access telemetry."""
    return envvars.enabled("DETPU_TELEMETRY")


def config_from_env() -> TelemetryConfig:
    """The env-configured geometry (``DETPU_TELEMETRY_SKETCH_DEPTH`` /
    ``_SKETCH_WIDTH`` / ``_TOPK`` / ``_CANDIDATES``; 0 candidates means
    ``4 * topk``)."""
    topk = max(1, envvars.get_int("DETPU_TELEMETRY_TOPK"))
    cand = envvars.get_int("DETPU_TELEMETRY_CANDIDATES")
    return TelemetryConfig(
        depth=max(1, envvars.get_int("DETPU_TELEMETRY_SKETCH_DEPTH")),
        buckets=max(2, envvars.get_int("DETPU_TELEMETRY_SKETCH_WIDTH")),
        topk=topk,
        candidates=cand if cand > 0 else 4 * topk)


def resolve_config(telemetry) -> Optional[TelemetryConfig]:
    """A step builder's ``telemetry=`` argument: ``None``/``False`` is
    off, ``True`` the env-configured geometry, a :class:`TelemetryConfig`
    passes through; anything else raises ``TypeError``. Telemetry is an
    explicit opt-in (it changes the step's call arity), never an env
    default."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return config_from_env()
    if isinstance(telemetry, TelemetryConfig):
        return telemetry
    raise TypeError(
        f"telemetry= takes None | bool | TelemetryConfig, got "
        f"{type(telemetry).__name__}")


# ------------------------------------------------------------------- state


def _wkey(width: int) -> str:
    return f"w{width}"


def init_telemetry(de, config: Optional[TelemetryConfig] = None,
                   device="cuda") -> Dict[str, Any]:
    """Fresh telemetry state for ``de`` on ``device`` (the card unless the
    caller asks for the CPU; raises without one): every leaf carries a
    leading axis of 1 (at world > 1, this rank's row)."""
    config = config or config_from_env()
    dev = resolve_device(device)

    def stacked(shape, dtype, fill=0):
        return torch.full((1,) + shape, fill, dtype=dtype, device=dev)

    state: Dict[str, Any] = {
        "steps": stacked((1,), torch.int32),
        "ids_total": stacked((1,), torch.float32),
    }
    for w in de.widths:
        state[_wkey(w)] = {
            "cms": stacked((config.depth, config.buckets), torch.int32),
            "topk_ids": stacked((config.topk,), torch.int32, TOPK_EMPTY),
            "topk_est": stacked((config.topk,), torch.int32),
            "ids": stacked((1,), torch.float32),
        }
    return state


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def local_state(state):
    """Strip the leading world axis (views): the telemetry twin of
    ``DistributedEmbedding.local_view``."""
    return _map(lambda v: v[0], state)


def stacked_state(state):
    """Re-add the leading world axis (views)."""
    return _map(lambda v: v[None], state)


# -------------------------------------------------------------- sketch math


def _buckets_of(ids: torch.Tensor, depth: int, buckets: int) -> torch.Tensor:
    """``[depth, n]`` sketch columns (int32) of ``ids [n]``."""
    return buckets_of_plain(ids, depth, buckets).to(torch.int32)


def cms_update(cms: torch.Tensor, ids: torch.Tensor,
               live: torch.Tensor) -> torch.Tensor:
    """Add ``live [n]`` into ``cms [depth, buckets]`` at each depth's
    column of ``ids [n]`` (masked positions add 0), in place (K13).
    Returns ``cms``."""
    sketch_update(cms, ids.to(torch.int32).reshape(-1).contiguous(),
                  live.reshape(-1).contiguous())
    return cms


def cms_query(cms: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Count-min estimate ``[n]`` of ``ids [n]``: the minimum over depth
    rows (never undercounts; collisions only inflate). K14's query."""
    return sketch_query(cms, ids.to(torch.int32).reshape(-1).contiguous())


def _record(wstate: Dict[str, torch.Tensor], ids: torch.Tensor,
            live: torch.Tensor, config: TelemetryConfig,
            total: Optional[torch.Tensor] = None, first: bool = True
            ) -> Dict[str, torch.Tensor]:
    """:func:`record_ids` through the width's fold record (K13, K14's
    pool and K15 in one replay, found by the layouts of the width's state
    and stream and by ``config``); the step's live count (the exact
    count rounded once to float32) is set into ``total`` (``first``) or
    added to it."""
    ids = ids.to(torch.int32).reshape(-1).contiguous()
    live = live.reshape(-1).contiguous()
    sketch_fold(wstate, ids, live, config.candidates, total, first)
    return wstate


def record_ids(wstate: Dict[str, torch.Tensor], ids: torch.Tensor,
               live: torch.Tensor, config: TelemetryConfig
               ) -> Dict[str, torch.Tensor]:
    """Fold one step's id stream for one width slab into its telemetry
    state, in place: the sketch update (K13), then a top-k merge of the
    step's distinct live ids, scored by the updated sketch (K14), against
    the carried candidates (K15).

    ``ids [n]`` are logical slab rows (garbage where ``live [n]`` is
    False). Returns ``wstate`` (its tensors updated)."""
    return _record(wstate, ids, live, config)


# ------------------------------------------------------ state persistence


def _leaves(tree) -> List[torch.Tensor]:
    """Leaves in JAX's flatten order (dict keys sorted), so a port
    ``.npz`` and a JAX ``.npz`` hold the same leaf at each index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(template, leaves: List):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def save_telemetry_state(path: str, state, de=None) -> None:
    """Persist the raw carried state (atomic tmp + fsync + rename
    ``.npz``, leaves ``leaf_<i>`` in JAX's flatten order) so a resumed run
    continues the accumulation. At world > 1 (``de`` given) every rank
    must call: the state is gathered (:func:`gather_state`) and rank 0
    writes JAX's ``[world, ...]`` leaves; the ranks meet at a barrier
    after the write."""
    multi = de is not None and de.world_size > 1
    if multi:
        leaves = _leaves(gather_state(de, state))
        if de.rank != 0:
            leaves = None
    else:
        leaves = [v.detach().cpu().numpy() for v in _leaves(state)]
    if leaves is not None:
        arrays = {f"leaf_{i}": v for i, v in enumerate(leaves)}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    if multi:
        from ..parallel import bootstrap

        bootstrap.barrier(de.process_group)


def restore_telemetry_state(path: str, fresh_state, de=None):
    """Rebuild a carried state from :func:`save_telemetry_state` output
    (the port's or the JAX package's), on the devices of ``fresh_state``
    (an :func:`init_telemetry` result for the same model and config). At
    world > 1 (``de`` given) the file holds ``[world, ...]`` leaves and
    this rank takes its row; no collective. On any mismatch (config
    drift, another world size, a torn file) the fresh state is returned:
    telemetry never blocks a resume."""
    world = de.world_size if de is not None else 1
    rank = de.rank if world > 1 else 0
    try:
        with np.load(path) as loaded:
            leaves = _leaves(fresh_state)
            if len(loaded.files) != len(leaves):
                raise ValueError(
                    f"{len(loaded.files)} saved leaves != {len(leaves)} "
                    "expected (telemetry config drift?)")
            out = []
            for i, leaf in enumerate(leaves):
                arr = loaded[f"leaf_{i}"]
                want = torch.empty(0, dtype=leaf.dtype).numpy().dtype
                shape = (world,) + tuple(leaf.shape[1:])
                if tuple(arr.shape) != shape or arr.dtype != want:
                    raise ValueError(
                        f"leaf {i}: saved {arr.shape}/{arr.dtype} != "
                        f"expected {shape}/{want}")
                out.append(torch.from_numpy(arr[rank:rank + 1].copy())
                           .to(leaf.device))
            return _unflatten(fresh_state, out)
    except Exception:  # noqa: BLE001 - never block a resume
        logging.getLogger(__name__).exception(
            "telemetry state restore from %s failed; starting fresh", path)
        return fresh_state


# ------------------------------------------------------------ host analysis


def _fetch(state) -> Dict[str, Any]:
    """Host numpy copy of a telemetry state (tensors or arrays)."""
    return _map(lambda v: v.detach().cpu().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v), state)


def gather_state(de, state) -> Dict[str, Any]:
    """Every rank's telemetry (or streaming) state as host numpy
    ``[world, ...]`` leaves in rank order (JAX's state), on every rank: a
    collective at world > 1 (every rank of ``de``'s group must call), one
    gather of the leaves' bytes. World 1: the host copy."""
    if de.world_size == 1:
        return _fetch(state)
    from ..parallel import bootstrap

    bootstrap.group_rank(de.process_group, de.world_size)  # in a group
    return _unflatten(state, bootstrap.gather_leaves(_leaves(state),
                                                     de.process_group))


def _host_state(de, state) -> Dict[str, Any]:
    """A state on the host with every rank's rows: gathered when ``de``
    runs at world > 1 and the state is this rank's tensors, else the
    host copy (a gathered state passes through)."""
    if de is not None and de.world_size > 1 and any(
            isinstance(v, torch.Tensor) for v in _leaves(state)):
        return gather_state(de, state)
    return _fetch(state)


def _slab_row_to_table(de, rank: int, width: int,
                       row: int) -> Optional[Tuple[int, int]]:
    """Map a logical slab row back to ``(global_table_id, table_row)``
    through the slab layout (``row_offsets_list`` + per-rank local
    configs), or ``None`` for an alignment padding row."""
    cfgs = de.strategy.local_configs_list[rank]
    for m, cfg in enumerate(cfgs):
        if int(cfg["output_dim"]) != width:
            continue
        roff = de.row_offsets_list[rank][m]
        span = ps.align_rows(int(cfg["input_dim"]), width)
        if roff <= row < roff + span:
            local = row - roff
            if local >= int(cfg["input_dim"]):
                return None  # alignment padding row (nothing live reads it)
            return (de.strategy.table_ids_list[rank][m],
                    local + int(cfg.get("_row_base", 0)))
    return None


def hot_rows(de, state, topk: Optional[int] = None
             ) -> Dict[int, List[Tuple[int, int]]]:
    """Per-global-table hot rows ``{table_id: [(row, est_count), ...]}``
    (descending estimate, then row), decoded from every rank's carried
    top-k; a ``(table, row)`` seen on several ranks keeps the largest
    estimate. At world > 1 a rank's own state is gathered first
    (:func:`gather_state`: every rank must call)."""
    host = _host_state(de, state)
    per_table: Dict[int, Dict[int, int]] = {}
    for w in de.widths:
        ws = host[_wkey(w)]
        for r in range(de.world_size):
            for row, est in zip(ws["topk_ids"][r], ws["topk_est"][r]):
                if row < 0 or est <= 0:
                    continue
                hit = _slab_row_to_table(de, r, w, int(row))
                if hit is None:
                    continue
                tid, trow = hit
                tab = per_table.setdefault(tid, {})
                tab[trow] = max(tab.get(trow, 0), int(est))
    out: Dict[int, List[Tuple[int, int]]] = {}
    for tid, rows in per_table.items():
        ranked = sorted(rows.items(), key=lambda kv: (-kv[1], kv[0]))
        out[tid] = ranked[:topk] if topk else ranked
    return out


def load_balance(state, de=None) -> Dict[str, Any]:
    """Per-rank cumulative routed-id load and the imbalance ratio
    (max/mean; 1.0 is balanced). At world > 1 pass ``de`` (a rank's own
    state is then gathered: every rank must call) or a
    :func:`gather_state` result."""
    host = _host_state(de, state)
    loads = np.asarray(host["ids_total"]).reshape(-1).astype(float)
    mean = float(loads.mean()) if loads.size else 0.0
    return {
        "per_rank_ids": [float(x) for x in loads],
        "imbalance_ratio": (float(loads.max() / mean) if mean > 0
                            else 1.0),
        "steps": int(np.asarray(host["steps"]).reshape(-1)[0]),
    }


def zipf_alpha(counts: List[int]) -> Optional[float]:
    """Least-squares Zipf exponent of a descending count ranking (the
    negated slope of ``log(count)`` on ``log(rank)``); ``None`` below 3
    usable points."""
    c = np.asarray([x for x in counts if x > 0], dtype=float)
    if c.size < 3:
        return None
    x = np.log(np.arange(1, c.size + 1, dtype=float))
    y = np.log(c)
    slope = np.polyfit(x, y, 1)[0]
    return float(-slope)


def table_loads_from_summary(summary: Dict[str, Any],
                             num_tables: int) -> List[float]:
    """Per-global-table traffic weights from a :func:`summarize_telemetry`
    dict: the sum of each table's surfaced hot-row estimates (0 for a
    table that surfaced none)."""
    loads = [0.0] * num_tables
    for t in summary.get("tables", []):
        tid = int(t.get("table_id", -1))
        if 0 <= tid < num_tables:
            loads[tid] = float(sum(int(c) for _, c in t.get("top_rows", [])))
    return loads


def summarize_telemetry(de, state, topk: Optional[int] = None
                        ) -> Dict[str, Any]:
    """JSON-able run summary: per-table hot rows with a Zipf exponent
    estimate, per-rank loads and the imbalance ratio, per-width id
    totals, the step count. At world > 1 a rank's own state is gathered
    first (every rank must call)."""
    host = _host_state(de, state)
    hot = hot_rows(de, host, topk=topk)
    tables = []
    for tid in sorted(hot):
        ranked = hot[tid]
        tables.append({
            "table_id": int(tid),
            "rows": int(de.strategy.global_configs[tid]["input_dim"]),
            "width": int(de.strategy.global_configs[tid]["output_dim"]),
            "top_rows": [[int(r), int(c)] for r, c in ranked],
            "zipf_alpha": zipf_alpha([c for _, c in ranked]),
        })
    per_width = {
        _wkey(w): [float(x) for x in
                   np.asarray(host[_wkey(w)]["ids"]).reshape(-1)]
        for w in de.widths}
    return dict(load_balance(host), tables=tables,
                per_width_ids=per_width)
