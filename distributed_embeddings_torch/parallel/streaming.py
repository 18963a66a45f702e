"""Streaming vocabularies: frequency-gated admission and approximate-LFU
eviction for capacity-bounded dynamic tables (counterpart of
``distributed_embeddings_tpu/parallel/streaming.py``).

A table whose config carries ``"streaming": {"capacity": C, "buckets":
B}`` (with ``input_dim == C + B``) serves external ids from an unbounded
id space out of its ``C + B`` slab rows:

* **tracked**: every live id folds into a count-min sketch and, until
  admitted, reads and trains its shared hash bucket (row ``C + bucket``);
* **admitted**: once its estimate reaches ``admit_min_count`` it claims
  its direct-mapped slot (``hash(id) % C``), whose slab row (and
  optimizer state) is reset at the claim step; from its next occurrence
  it reads the slot;
* **evicted**: a claim on an occupied slot succeeds only when the
  estimate reaches the occupant's recorded frequency plus
  ``evict_margin``; the evicted id falls back to its bucket.

The state is a plain dict of tensors with JAX's keys and dtypes, every
leaf with a leading axis of 1 (JAX's ``[world]`` axis at world 1; at
world > 1 this rank's row of it, as each rank holds its own slabs):
``steps`` (int32 ``[1, 1]``), the cumulative ``admitted``/``evicted``/
``bucket_ids``/``hit_ids`` (float32 ``[1, 1]``) and, per width slab
holding a streaming table, ``"w<width>"``: ``slot_fp`` (31-bit
fingerprint per logical slab row, :data:`SLOT_FREE` when free),
``slot_freq`` (the occupant's estimate) and ``cms`` (the admission
sketch, ``[1, depth, buckets]``), int32. A rank that holds no streaming
slot of a width keeps that width's state untouched; its ``steps`` still
advance with the guard's verdict, as JAX's do.

:func:`remap_width` runs on the hand-written kernel K16 (with K13 for
the sketch fold) and :func:`commit` on K17 (``ops/streaming.py``); the
emission point is
:meth:`~.dist_embedding.DistributedEmbedding.forward_with_residuals`
(``streaming=``), the threading ``make_hybrid_train_step(dynamic=)``.
The remap folds this step's ids into a STAGED copy of the sketch and
only reads the slot map; the commit, after the optimizer scatter and
under the guard's verdict, is the only writer of the carried state, so a
guard-skipped step leaves slot map, sketch, counters, slabs and moments
bitwise unchanged. :func:`encode_state`, :func:`decode_state` and
:func:`occupancy` are host functions (numpy); at world > 1
:func:`encode_state` and :func:`occupancy` gather every rank's state
first (a collective), and :func:`decode_state` fills only this rank's
row.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..ops import streaming as sops
from ..ops.streaming import SLOT_FREE
# the kernel wrappers, under module globals of their own (a caller can
# route them to their plain versions)
from ..ops.streaming import commit_rows, remap_stage
from ..utils import envvars
from ..utils.device import resolve_device

#: the cumulative counters, in the order of the kernels' counts
COUNTERS = sops.COUNT_NAMES


class StreamingConfig(NamedTuple):
    """Static admission/eviction policy (hashable; fixed when a step is
    built)."""

    admit_min_count: int = 2   #: sketch estimate gating slot admission
    evict_margin: int = 1      #: incoming est must beat occupant freq by this
    depth: int = 4             #: admission-sketch rows (independent hashes)
    buckets: int = 4096        #: admission-sketch columns per row


def config_from_env() -> StreamingConfig:
    """The env-configured policy (``DETPU_ADMIT_MIN_COUNT`` /
    ``DETPU_EVICT_MARGIN`` / ``DETPU_ADMIT_SKETCH_DEPTH`` /
    ``DETPU_ADMIT_SKETCH_WIDTH``)."""
    return StreamingConfig(
        admit_min_count=max(1, envvars.get_int("DETPU_ADMIT_MIN_COUNT")),
        evict_margin=max(0, envvars.get_int("DETPU_EVICT_MARGIN")),
        depth=max(1, envvars.get_int("DETPU_ADMIT_SKETCH_DEPTH")),
        buckets=max(2, envvars.get_int("DETPU_ADMIT_SKETCH_WIDTH")))


def resolve_config(dynamic) -> Optional[StreamingConfig]:
    """A step builder's ``dynamic=`` argument: ``None``/``False`` is off,
    ``True`` the env-configured policy, a :class:`StreamingConfig` passes
    through; anything else raises ``TypeError``. An explicit opt-in (it
    changes the step's call arity), never an env default."""
    if dynamic is None or dynamic is False:
        return None
    if dynamic is True:
        return config_from_env()
    if isinstance(dynamic, StreamingConfig):
        return dynamic
    raise TypeError(
        f"dynamic= takes None | bool | StreamingConfig, got "
        f"{type(dynamic).__name__}")


# ------------------------------------------------------------------- state


def _wkey(width: int) -> str:
    return f"w{width}"


def streaming_widths(de) -> List[int]:
    """Widths whose slab holds at least one streaming table."""
    return sorted({int(de.strategy.global_configs[tid]["output_dim"])
                   for tid in de.streaming_tables})


def init_streaming(de, config: Optional[StreamingConfig] = None,
                   device="cuda") -> Dict[str, Any]:
    """Fresh streaming state for ``de`` on ``device`` (the card unless
    the caller asks for the CPU; raises without one): every leaf carries
    a leading axis of 1 (at world > 1, this rank's row). Raises
    ``ValueError`` when no table declares a ``"streaming"`` entry."""
    if not de.streaming_tables:
        raise ValueError(
            "init_streaming: no table declares a 'streaming' config "
            "entry — nothing to carry")
    config = config or config_from_env()
    dev = resolve_device(device)

    def stacked(shape, dtype, fill=0):
        return torch.full((1,) + shape, fill, dtype=dtype, device=dev)

    state: Dict[str, Any] = {"steps": stacked((1,), torch.int32)}
    for name in COUNTERS:
        state[name] = stacked((1,), torch.float32)
    for w in streaming_widths(de):
        rows = de.rows_cap[w]
        state[_wkey(w)] = {
            "slot_fp": stacked((rows,), torch.int32, SLOT_FREE),
            "slot_freq": stacked((rows,), torch.int32),
            "cms": stacked((config.depth, config.buckets), torch.int32),
        }
    return state


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def local_state(state):
    """Strip the leading world axis (views): the streaming twin of
    ``DistributedEmbedding.local_view``."""
    return _map(lambda _, v: v[0], state)


def stacked_state(state):
    """Re-add the leading world axis (views)."""
    return _map(lambda _, v: v[None], state)


def fresh_like(state):
    """A pristine state of the same structure, shapes, dtypes and devices
    as ``state`` (slot maps free, everything else zero)."""
    return _map(lambda p, v: torch.full_like(
        v, SLOT_FREE if p[-1] == "slot_fp" else 0), state)


# ------------------------------------------------------------- hash helpers


def sketch_key(ext: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 count-min key of external ids (the 31-bit
    fingerprint, salted by the table id): the admission sketch's key, so
    tests can query the sketch the way the step does."""
    return sops.fingerprint_plain(ext, tid)


# --------------------------------------------------------- the core update


class WidthStream(NamedTuple):
    """One width slab's flattened id stream for one step: every leaf
    ``[n]`` over the positions of that width's streaming-table slots."""

    ext: torch.Tensor       #: raw external ids (int32 or int64)
    live: torch.Tensor      #: bool — position holds a real id on a live slot
    cap: torch.Tensor       #: per-position slot capacity of the owning table
    nbuckets: torch.Tensor  #: per-position shared-bucket count
    tid: torch.Tensor       #: per-position global table id (the hash salt)
    roff: torch.Tensor      #: per-position table row offset in the slab


def remap_width(wstate: Dict[str, torch.Tensor], stream: WidthStream,
                rows_cap: int, config: StreamingConfig,
                update: bool = True):
    """Serve one width slab's external-id stream out of the slot map and
    (``update=True``) stage this step's admission/eviction transitions
    (K16, and K13 for the sketch fold).

    ``wstate`` is the width's local state (``slot_fp``/``slot_freq``
    ``[rows_cap]``, ``cms [depth, buckets]``), only read. Returns
    ``(local_rows, pending)``: ``local_rows [n]`` (int32) is the
    table-local row each position reads (its slot on a map hit, else its
    shared bucket; positions that are not live keep their raw value's
    low word), and ``pending`` is ``None`` for a read-only remap, else
    ``(staged_cms, remap)``: the sketch with this step's fold (a copy)
    and the :class:`~..ops.streaming.Remap` :func:`commit` applies.
    Freshly admitted ids are still served from their bucket this step;
    from their next occurrence they hit the slot map."""
    if rows_cap != wstate["slot_fp"].numel():
        raise ValueError(f"rows_cap {rows_cap} != slot map "
                         f"{wstate['slot_fp'].numel()}")
    staged = wstate["cms"].clone() if update else None
    r = remap_stage(stream.ext.reshape(-1), stream.live.reshape(-1),
                    *(getattr(stream, f).reshape(-1).to(torch.int32)
                      for f in ("cap", "nbuckets", "tid", "roff")),
                    wstate["slot_fp"], wstate["slot_freq"], staged,
                    config.admit_min_count, config.evict_margin,
                    update=update)
    if not update:
        return r.local_rows, None
    return r.local_rows, (staged, r)


def staged_wstate(wstate, pending, rows_cap: int):
    """JAX's ``new_wstate`` of one width (copies): the slot map and
    sketch as :func:`commit` would leave them on an enabled step. For
    tests and checks; the step commits in place."""
    staged, r = pending
    new_fp = wstate["slot_fp"].clone()
    new_freq = wstate["slot_freq"].clone()
    sel = r.scrub_rows < rows_cap
    new_fp[r.scrub_rows[sel].long()] = r.fp[sel]
    new_freq[r.scrub_rows[sel].long()] = r.est[sel]
    hsel = r.hit_rows < rows_cap
    new_freq.scatter_reduce_(0, r.hit_rows[hsel].long(), r.est[hsel], "amax")
    return {"slot_fp": new_fp, "slot_freq": new_freq, "cms": staged.clone()}


def step_stats(pending) -> Dict[str, torch.Tensor]:
    """The per-step counts of one width's pending remap as JAX's
    ``stats`` (``[1]`` float32 each)."""
    counts = pending[1].counts.to(torch.float32)
    return {name: counts[k:k + 1] for k, name in enumerate(COUNTERS)}


def commit(de, params: Dict[str, torch.Tensor], pending, state,
           enable=None, opt_state=None, optimizer=None):
    """Apply one step's staged transitions IN PLACE (K17, one launch per
    width): called after the optimizer scatter, under the guard's
    verdict ``enable`` (a 0-d bool tensor on the state's device, never
    read on the host; ``None`` commits), so a skipped step leaves the
    slot map, sketch, counters and slabs bitwise unchanged.

    * claimed slab rows become ``x + (-x)`` (+0 for a finite ``x``);
    * with ``opt_state``/``optimizer``, every slab-shaped optimizer state
      leaf of the width is reset on them to ``optimizer.fresh_row_fill``
      (zero, then add: the row is bitwise the fresh-init value); other
      leaves (Adam's step count) are untouched;
    * the slot map takes the claims, then the hits' estimates (a max);
      the staged sketch replaces the carried one;
    * the cumulative counters advance by the gated per-step counts, and
      ``steps`` by the verdict.

    ``params``/``opt_state``: the local (``[rows, w]``) slabs and their
    optimizer state; ``state``: the local streaming state. Returns the
    gated per-step totals, ``{name: [1] float32}`` (JAX's
    ``step_stats``)."""
    fill = float(getattr(optimizer, "fresh_row_fill", 0.0))
    widths = sorted(pending)
    dev = state["steps"].device
    totals = torch.zeros(4, dtype=torch.float32, device=dev)
    if not widths:  # a rank with no streaming slot: only the step count
        state["steps"].add_(1 if enable is None else enable.to(torch.int32))
    counters = [state[name] for name in COUNTERS]
    for i, w in enumerate(widths):
        staged, r = pending[w]
        k = _wkey(w)
        slab = params[k]
        leaves = []
        if opt_state is not None:
            leaves = [(t, fill) for t in pytree.tree_leaves(opt_state[k])
                      if isinstance(t, torch.Tensor)
                      and tuple(t.shape) == tuple(slab.shape)]
        ws = state[k]
        commit_rows(slab, leaves, r, ws["slot_fp"], ws["slot_freq"],
                    ws["cms"], staged, totals, counters, state["steps"],
                    enable=enable, finalize=i == len(widths) - 1)
    return {name: totals[j:j + 1] for j, name in enumerate(COUNTERS)}


# ------------------------------------------------------ state persistence


def _host(state):
    return _map(lambda _, v: v.detach().cpu().numpy().copy()
                if isinstance(v, torch.Tensor) else np.array(v), state)


def _table_home(de, tid: int) -> Tuple[int, int, int]:
    """``(rank, slab row offset, width)`` of an (unsliced) streaming
    table."""
    for r, tids in enumerate(de.strategy.table_ids_list):
        for m, t in enumerate(tids):
            if t == tid:
                return (r, de.row_offsets_list[r][m],
                        int(de.strategy.local_configs_list[r][m]
                            ["output_dim"]))
    raise ValueError(f"streaming table {tid} placed on no rank")


def encode_state(de, state) -> Dict[str, np.ndarray]:
    """Host-side, plan-agnostic encoding of a carried streaming state
    (JAX's keys and shapes): per streaming table its slot fingerprints
    and frequencies as ``[capacity]`` arrays read on the table's home
    rank, each width's sketch and the per-rank counters as ``[world,
    ...]`` arrays, and the world size. At world > 1 every rank must call
    (``analysis.telemetry.gather_state``, a collective) and every rank
    gets the whole encoding. :func:`decode_state` inverts it under any
    plan whose logical tables match."""
    from ..analysis import telemetry as tel

    host = (tel.gather_state(de, state) if de.world_size > 1
            else _host(state))
    out: Dict[str, np.ndarray] = {
        "world": np.asarray([de.world_size], np.int32),
    }
    for name in ("steps",) + COUNTERS:
        out[f"c_{name}"] = np.asarray(host[name])
    for tid, (cap, _) in sorted(de.streaming_tables.items()):
        r, roff, w = _table_home(de, tid)
        ws = host[_wkey(w)]
        out[f"t{tid}_fp"] = np.asarray(ws["slot_fp"][r, roff:roff + cap])
        out[f"t{tid}_freq"] = np.asarray(
            ws["slot_freq"][r, roff:roff + cap])
    for w in streaming_widths(de):
        out[f"w{w}_cms"] = np.asarray(host[_wkey(w)]["cms"])
    return out


def decode_state(de, template, encoded: Optional[Dict[str, np.ndarray]]):
    """Rebuild a carried streaming state from :func:`encode_state` output
    under ``de``'s plan, with ``template`` (an :func:`init_streaming`
    result for the same config: this rank's ``[1, ...]`` state) giving
    structure, dtypes and device; no collective. This rank's row of
    JAX's decoded ``[world, ...]`` state: the slot maps of the streaming
    tables homed on this rank, and the counters and sketches saved at
    this world size (another world size or sketch geometry resets them,
    with a warning: a warm-up degradation; the slot maps carry over
    intact). ``None``/empty input, or an input that does not fit (a
    capacity drift), gives a pristine :func:`fresh_like` state: streaming
    state never blocks a restore (cold slot maps only send ids back to
    their buckets)."""
    log = logging.getLogger(__name__)
    world, rank = de.world_size, de.rank
    fresh = _host(fresh_like(template))
    state = _host(fresh_like(template))

    def row_of(src, tgt):
        """This rank's row of a saved ``[world, ...]`` leaf, or ``None``
        when the leaf was saved at another world size or geometry."""
        src = np.asarray(src)
        if src.shape != (world,) + tgt.shape[1:]:
            return None
        return src[rank:rank + 1].astype(tgt.dtype)

    if encoded:
        try:
            same_world = (int(np.asarray(encoded["world"]).reshape(-1)[0])
                          == world)
            for tid, (cap, _) in sorted(de.streaming_tables.items()):
                r, roff, w = _table_home(de, tid)
                for field, key in (("slot_fp", f"t{tid}_fp"),
                                   ("slot_freq", f"t{tid}_freq")):
                    src = np.asarray(encoded[key])
                    if src.shape != (cap,):
                        raise ValueError(
                            f"{key}: saved shape {src.shape} != ({cap},) — "
                            "streaming capacity drift")
                    if r == rank:
                        state[_wkey(w)][field][0, roff:roff + cap] = src
            for name in ("steps",) + COUNTERS:
                src = encoded.get(f"c_{name}")
                if src is not None and same_world:
                    row = row_of(src, state[name])
                    if row is not None:
                        state[name] = row
            for w in streaming_widths(de):
                src = encoded.get(f"w{w}_cms")
                tgt = state[_wkey(w)]["cms"]
                row = (row_of(src, tgt) if src is not None and same_world
                       else None)
                if row is not None:
                    state[_wkey(w)]["cms"] = row
                elif src is not None:
                    log.warning(
                        "streaming decode: admission sketch w%d re-shards "
                        "from world/geometry %s to %s — resetting (warm-up "
                        "degradation; slot maps carried over intact)", w,
                        np.asarray(src).shape,
                        (world,) + tgt.shape[1:])
        except Exception:  # noqa: BLE001 - never block a restore
            log.exception("streaming state decode failed; starting fresh")
            state = fresh

    def place(path, t):
        v = state
        for p in path:
            v = v[p]
        return torch.from_numpy(np.ascontiguousarray(v)).to(t.device)

    return _map(place, template)


# --------------------------------------------------------- host analysis


def occupancy(de, state) -> Dict[str, Any]:
    """Host summary of a streaming state: per-table slot occupancy (read
    on the rank that holds the table, :func:`_table_home`) and the
    cumulative admission / eviction / bucket / hit counters summed over
    the ranks. At world > 1 a rank's own state is gathered first
    (``analysis.telemetry.gather_state``: every rank must call)."""
    from ..analysis import telemetry as tel

    host = tel._host_state(de, state)
    tables = []
    for tid, (cap, nb) in sorted(de.streaming_tables.items()):
        r, roff, w = _table_home(de, tid)
        fp = np.asarray(host[_wkey(w)]["slot_fp"][r, roff:roff + cap])
        tables.append({
            "table_id": int(tid), "capacity": int(cap),
            "buckets": int(nb),
            "occupied": int((fp != SLOT_FREE).sum()),
            "occupancy_frac": float((fp != SLOT_FREE).mean()),
        })

    def c(name):
        return float(np.asarray(host[name]).sum())

    return {
        "steps": int(np.asarray(host["steps"]).reshape(-1).max()),
        "admitted": c("admitted"), "evicted": c("evicted"),
        "bucket_ids": c("bucket_ids"), "hit_ids": c("hit_ids"),
        "tables": tables,
    }
