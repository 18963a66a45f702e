"""Model-parallel embedding layer (counterpart of
``distributed_embeddings_tpu/parallel/dist_embedding.py``).

The constructor's placement plan and slab-offset bookkeeping, ``init``,
input normalization, the cached exchange plans, the forward
(``__call__`` / ``forward_with_residuals``) and ``get_table`` /
``get_weights`` / ``set_weights`` (chunked, with the ``src_dtype`` and
``use_lock`` of the checkpoint codec). Tables of one width stack
row-major into one LOGICAL slab per width, each table starting at the
same row offset as in the JAX package (its lane-packing alignment is
kept, see ``ops/packed_slab.py``), so both packages build identical
exchange plans. Every (width, hotness) group of the plan is ONE launch of
the gather kernel (``parallel/lookup.py``).

At world 1 the slabs are ``{"w128": [1, rows_cap, 128]}`` and the
exchanges are passthroughs. At ``world_size > 1`` every rank is a
process of a ``torch.distributed`` group (``process_group=``, see
``parallel/bootstrap.py``) and holds only ITS slab ``[1, rows_cap, w]``;
the forward takes this rank's rows of the batch (data-parallel input)
and exchanges ids, or, with ``dp_input=False``, this rank's block of a
:class:`MpInputs` batch (model-parallel input: the ids of its tables
over the global batch, packed on the host by
:meth:`~DistributedEmbedding.pack_mp_inputs`; no id exchange runs),
looks up its tables, exchanges the outputs back and unpacks them
(``parallel/exchange.py``, kernels K19/K20), the column slices of a
sliced table side by side and the row slices of a row-sliced table
(``row_slice=``) summed.

Inputs are dense id tensors, :class:`~..ops.embedding_lookup.Ragged`
CSR batches (tables with a combiner; optional per-id weights ride the
id block as float32 bits) and :class:`~..ops.embedding_lookup.SparseIds`
COO batches (converted to CSR by ``row_to_split``, K10). The sparse
backward (``sparse_apply_gradients``, ``parallel/apply.py``) covers all
of them.

``update_telemetry`` folds a forward's routed ids into the carried access
telemetry (``analysis/telemetry.py``, kernels K13-K15). Tables with a
``"streaming"`` entry serve an unbounded external id space through a
carried slot map (``forward_with_residuals(streaming=)``,
``parallel/streaming.py``, kernels K16-K17). ``step_metrics`` tallies a
forward's exchange and overflow metrics. At world > 1 each of them runs
on the id block this rank received, with this rank's plan rows and
state.

The layer carries the step schedule the trainer runs (``schedule=``,
``parallel/schedule.py``): the serialized step, or the K-microbatch
pipelined step, which runs the forward in its three parts with the
exchanges in flight, serves streaming ids read-only a microbatch
(``streaming=(config, state, "serve")``) and stages the admissions once
(:meth:`~DistributedEmbedding.streaming_stage`).

Not yet ported, raising ``NotImplementedError`` with its ROADMAP item:
the ``'raise'`` invalid-id policy (A12).

Ids must lie in ``[0, input_dim)``; out-of-range ids CLIP in the
forward (a negative id reads row 0, one past the table its last row),
as in the JAX package. A row slice reads a ZERO row for every id outside
its range (the slices' outputs sum), so a row-sliced table reads zero
for an id outside the table.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..analysis import telemetry as tel
from ..layers.embedding import default_embeddings_init
from ..ops import packed_slab as ps
from ..ops.embedding_lookup import Ragged, SparseIds, row_to_split
from ..utils import obs
from ..utils.convert import host_tensor
from ..utils.device import resolve_device
from . import apply as apply_mod
from . import bootstrap
from . import exchange as exchange_mod
from . import lookup as lookup_mod
from . import plan as plan_mod
from . import schedule as schedule_mod
from .strategy import DistEmbeddingStrategy

EmbedParams = Dict[str, torch.Tensor]

#: host rows per copy in set_weights / get_weights: 128M elements, the
#: JAX package's checkpoint chunk
CHECKPOINT_CHUNK_ELEMS = 128 * 1024 * 1024


def _wkey(width: int) -> str:
    return f"w{width}"


@dataclasses.dataclass
class MpInputs:
    """A model-parallel input batch (``dp_input=False``), the JAX
    package's ``MpInputs``.

    * ``packed``: the id blocks ``[world_dest, world_src, l_max]`` (every
      rank's, as :meth:`DistributedEmbedding.pack_mp_inputs` builds them
      on the host), ``[world_src, l_max]`` (this rank's block: what its
      id exchange would have received) or ``[1, world_src, l_max]`` (the
      same, as a one-rank shard); numpy or a tensor. Row ``[r, s]`` holds
      source shard ``s``'s local batch of ids for every input rank ``r``
      owns, in the plan's group-region layout.
    * ``hots``: per global input its encoding: an int (dense hotness),
      ``("r"|"rw", capacity)`` or ``("d", hot, num_slots)``.
    * ``local_batch``: the per-shard batch ``b``.
    """

    packed: Any
    hots: tuple
    local_batch: int


def slab_layout(strategy: DistEmbeddingStrategy
                ) -> Tuple[List[int], List[List[int]], Dict[int, int]]:
    """``(widths, row_offsets_list, rows_cap)`` of the width-grouped
    slabs, computed exactly as the JAX package does: per rank, tables of
    one width stack row-major at aligned logical offsets
    (``row_offsets_list[rank][m]``), and each width's slab holds the
    largest rank's rows (``rows_cap[w]``)."""
    widths = sorted({int(c["output_dim"])
                     for cfgs in strategy.local_configs_list for c in cfgs})
    row_offsets_list: List[List[int]] = []
    per_rank_rows = []
    for cfgs in strategy.local_configs_list:
        used = {w: 0 for w in widths}
        offsets = []
        for c in cfgs:
            w = int(c["output_dim"])
            offsets.append(used[w])
            used[w] += ps.align_rows(int(c["input_dim"]), w)
        row_offsets_list.append(offsets)
        per_rank_rows.append(used)
    rows_cap = {w: ps.align_rows(max(max(max(r[w] for r in per_rank_rows),
                                         1), ps.pack_factor(w)), w)
                for w in widths}
    return widths, row_offsets_list, rows_cap


def _is_void(a) -> bool:
    """Whether ``a`` is a numpy array of an opaque void dtype (what
    ``np.load`` gives for a bfloat16 ``.npy``; an ``ml_dtypes`` bfloat16
    array is not one)."""
    return isinstance(a, np.ndarray) and a.dtype.kind == "V" \
        and a.dtype.name.startswith("void")


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a dict / tuple / list tree."""
    return pytree.tree_map(
        lambda v: fn(v) if isinstance(v, torch.Tensor) else v, tree)


class _Forward:
    """One forward between its parts (``DistributedEmbedding.
    _forward_begin`` / ``_forward_lookup`` / ``_forward_finish``): the
    pipelined step holds one a microbatch, with its exchanges in flight
    (:class:`~.bootstrap.InFlight`)."""

    __slots__ = ("local", "streaming", "tag", "in_flight", "plan", "encs",
                 "b", "shapes", "ids", "ids_recv", "pending", "reds", "out")

    def __init__(self, local, streaming, tag, in_flight):
        self.local, self.streaming = local, streaming
        self.tag, self.in_flight = tag, in_flight
        self.plan = self.encs = self.b = self.shapes = None
        self.ids = self.ids_recv = self.pending = self.reds = None
        self.out = None


class DistributedEmbedding:
    """Embedding tables behind one plan-driven lookup.

    Args follow the JAX package's ``DistributedEmbedding``:
      embeddings: table config dicts (``input_dim``, ``output_dim``,
        optional ``combiner`` and ``embeddings_initializer`` — an
        in-place ``init(out, generator)``, see ``layers/embedding.py``).
      world_size: the ranks the tables are sharded over (1: one process
        holds them all).
      process_group: the ``torch.distributed`` group of those ranks (the
        counterpart of the JAX mesh axis); ``None`` is the default group.
        Read only at world > 1, where this process's rank in it decides
        which slab it holds.
      dp_input: data-parallel input (each rank passes its rows of the
        batch); ``False``: model-parallel input (each rank passes an
        :class:`MpInputs` batch, its tables' ids over the global batch,
        and no id exchange runs). World 1 takes a plain input list either
        way.
      row_slice: an int element threshold: a table over it (and not
        column-sliced) splits into power-of-two row ranges, each a slice
        on its own rank (``strategy.maybe_slice_table_row``); a slice
        reads zero for ids outside its range and the slices' outputs sum.
      strategy, column_slice_threshold, input_table_map, input_hotness,
        table_loads: passed to :class:`DistEmbeddingStrategy`.
      compute_dtype: torch dtype the outputs are cast to (``None`` keeps
        the table dtype).
      masked_reads: out-of-range ids read a ZERO row instead of clipping.
      invalid_id_policy: ``'clamp'`` (default) or ``'drop'`` (forces
        ``masked_reads``).
      schedule: the :class:`~.schedule.StepSchedule` the trainer's hybrid
        step runs. ``None`` / ``"serialized"`` (default) is the
        serialized step (streaming layers declare their admission-staging
        overlap); ``"pipelined"``, or an explicit
        :func:`~.schedule.pipelined_schedule`, opts into the K-microbatch
        pipelined step (``DETPU_MICROBATCH`` resolves K for the string
        form): the per-rank batch splits into K chains whose exchanges
        stay in flight under the other microbatches' lookups and dense
        compute, with gradients accumulated so the applied update matches
        the serialized step (K=1 is the serialized step, launch for
        launch; the per-rank batch must divide by K).
    """

    def __init__(self,
                 embeddings: Sequence[Any],
                 world_size: int,
                 strategy: str = "basic",
                 column_slice_threshold: Optional[int] = None,
                 row_slice: Optional[int] = None,
                 input_table_map: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 input_hotness: Optional[Sequence[int]] = None,
                 masked_reads: bool = False,
                 invalid_id_policy: str = "clamp",
                 table_loads: Optional[Sequence[float]] = None,
                 process_group=None,
                 dp_input: bool = True,
                 schedule=None):
        if row_slice is not None and (isinstance(row_slice, bool)
                                      or not isinstance(row_slice, int)):
            # bool subclasses int: row_slice=True would mean threshold 1
            raise TypeError(
                "row_slice takes an int element threshold, got "
                f"{row_slice!r}")
        if invalid_id_policy == "raise":
            raise NotImplementedError(
                "the 'raise' ingestion checks are not ported yet: "
                "ROADMAP A12")
        if invalid_id_policy not in ("clamp", "drop"):
            raise ValueError(
                f"invalid_id_policy must be 'clamp' | 'drop' | 'raise', "
                f"got {invalid_id_policy!r}")
        self.world_size = int(world_size)
        if self.world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.process_group = process_group
        self.dp_input = bool(dp_input)
        self._rank = None if self.world_size > 1 else 0
        self.compute_dtype = compute_dtype
        self.invalid_id_policy = invalid_id_policy
        self.masked_reads = bool(masked_reads) or invalid_id_policy == "drop"
        self.strategy = DistEmbeddingStrategy(
            embeddings, self.world_size, strategy=strategy,
            input_table_map=input_table_map,
            column_slice_threshold=column_slice_threshold,
            input_hotness=input_hotness, row_slice_threshold=row_slice,
            table_loads=table_loads)
        if len(self.strategy.global_configs) < self.world_size:
            raise NotImplementedError(
                "Fewer tables than ranks is not supported (reference "
                "constraint, dist_model_parallel.py:252-253)")
        # slices per global table (column or row slicing)
        self.slices_per_table = [0] * len(self.strategy.global_configs)
        for tids in self.strategy.table_ids_list:
            for tid in tids:
                self.slices_per_table[tid] += 1
        # streaming (dynamic-vocab) tables: {tid: (capacity, buckets)}.
        # The declared input_dim is the slab footprint (capacity slots,
        # then the shared bucket rows); only the id interpretation changes
        # (external ids remap through the carried slot map,
        # parallel/streaming.py). A slot map cannot span slices.
        self.streaming_tables: Dict[int, tuple] = {}
        slices = self.slices_per_table
        for tid, cfg in enumerate(self.strategy.global_configs):
            sc = cfg.get("streaming")
            if not sc:
                continue
            cap, nb = int(sc["capacity"]), int(sc["buckets"])
            if cap <= 0 or nb <= 0:
                raise ValueError(
                    f"table {tid}: streaming capacity/buckets must be "
                    f"positive, got {sc!r}")
            if cap + nb != int(cfg["input_dim"]):
                raise ValueError(
                    f"table {tid}: streaming capacity {cap} + buckets "
                    f"{nb} must equal input_dim {cfg['input_dim']} (the "
                    "slab holds the slots followed by the shared bucket "
                    "rows)")
            if slices[tid] != 1:
                raise NotImplementedError(
                    f"table {tid} is row/column-sliced ({slices[tid]} "
                    "slices): streaming tables must stay unsliced (the "
                    "slot map cannot span slices)")
            self.streaming_tables[tid] = (cap, nb)
        self.widths, self.row_offsets_list, self.rows_cap = \
            slab_layout(self.strategy)
        self._plan_cache: Dict[tuple, plan_mod.ExchangePlan] = {}
        self._meta_cache: Dict[tuple, tuple] = {}
        # the step schedule the trainer runs (parallel/schedule.py): K = 1
        # is the serialized step, K > 1 the pipelined one
        self.schedule = schedule_mod.resolve_schedule(
            schedule, streaming=bool(self.streaming_tables))

    # ------------------------------------------------------------------ params

    @property
    def rank(self) -> int:
        """This process's rank in the layer's group (0 at world 1)."""
        if self._rank is None:
            self._rank = bootstrap.group_rank(self.process_group,
                                              self.world_size)
        return self._rank

    def _tables_of_width(self, width: int):
        """``(config, slab row offset)`` of this rank's tables of one
        width."""
        my = self.rank
        return [(c, self.row_offsets_list[my][m])
                for m, c in enumerate(self.strategy.local_configs_list[my])
                if int(c["output_dim"]) == width]

    def _rank_generator(self, generator, device):
        """At world > 1, this rank's generator: seeded from ``(seed,
        rank)``, ``seed`` the given generator's initial seed (or the
        default one's), so the ranks draw different tables."""
        if self.world_size == 1:
            return generator
        seed = (generator.initial_seed() if generator is not None
                else torch.initial_seed())
        mixed = np.random.SeedSequence([seed, self.rank]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(
            int(mixed) & 0x7fffffffffffffff)

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device="cuda") -> EmbedParams:
        """Build this rank's slabs ``{"w<width>": [1, rows_cap, width]}``.

        Each slab is allocated once (``torch.empty``) and filled IN
        PLACE, table by table, by its initializer (or, when every table
        of the width uses the default, by one uniform fill of the whole
        slab, as the JAX package's fast path does), so no second copy of
        a slab ever exists. Rows between and after tables are zeroed. At
        world > 1 each rank draws from a generator derived from
        ``(seed, rank)`` (:meth:`_rank_generator`)."""
        dev = resolve_device(device)
        generator = self._rank_generator(generator, dev)
        out = {}
        for w in self.widths:
            buf = torch.empty((1, self.rows_cap[w], w), dtype=dtype,
                              device=dev)
            tables = self._tables_of_width(w)
            if all(c.get("embeddings_initializer") is None
                   for c, _ in tables):
                default_embeddings_init(buf, generator)
            else:
                pos = 0
                for c, roff in tables:
                    rows = int(c["input_dim"])
                    buf[0, pos:roff].zero_()
                    init = (c.get("embeddings_initializer")
                            or default_embeddings_init)
                    init(buf[0, roff:roff + rows], generator)
                    pos = roff + rows
                buf[0, pos:].zero_()
            out[_wkey(w)] = buf
        return out

    def _slice_plan(self) -> List[List[tuple]]:
        """Per (rank, local table): ``(table id, slab row offset, rows,
        first column, width, first row)``; a table's column slices are
        consumed in rank order, and a row slice spans every column from
        its first global row (the JAX package's ``_slice_plan``)."""
        col = [0] * len(self.strategy.global_configs)
        row_sliced = self.strategy.row_sliced_tables
        plan = []
        for r, cfgs in enumerate(self.strategy.local_configs_list):
            rank_plan = []
            for m, cfg in enumerate(cfgs):
                tid = self.strategy.table_ids_list[r][m]
                w = int(cfg["output_dim"])
                if tid in row_sliced:
                    rank_plan.append((tid, self.row_offsets_list[r][m],
                                      int(cfg["input_dim"]), 0, w,
                                      int(cfg["_row_base"])))
                    continue
                rank_plan.append((tid, self.row_offsets_list[r][m],
                                  int(cfg["input_dim"]), col[tid], w, 0))
                col[tid] += w
            plan.append(rank_plan)
        return plan

    def _table_tensor(self, params: EmbedParams, tid: int,
                      chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                      all_ranks: bool = True) -> Optional[torch.Tensor]:
        """ONE global table ``[input_dim, output_dim]`` as a CPU tensor
        in the slab's dtype (bfloat16 kept), copied in row chunks of at
        most ``chunk_elems`` elements. At world > 1 every rank must call:
        with ``all_ranks`` each slice's owner broadcasts its chunks over
        the group and every rank returns the table; without, each owner
        sends its chunks to rank 0 alone (``bootstrap.send_to_chief``),
        rank 0 returns the table and the others ``None``, holding at most
        one chunk of their own on the host."""
        cfg = self.strategy.global_configs[tid]
        keep = all_ranks or self.rank == 0
        host = None
        for r, rank_plan in enumerate(self._slice_plan()):
            for t2, roff, rows, c0, w, r0 in rank_plan:
                if t2 != tid:
                    continue
                slab = params[_wkey(w)][0]
                if host is None and keep:
                    host = torch.empty((int(cfg["input_dim"]),
                                        int(cfg["output_dim"])),
                                       dtype=slab.dtype)
                step = max(1, int(chunk_elems) // w)
                for s in range(0, rows, step):
                    n = min(step, rows - s)
                    mine = (slab[roff + s:roff + s + n]
                            if r == self.rank else None)
                    if self.world_size == 1:
                        chunk = mine
                    elif all_ranks:
                        chunk = (mine.clone() if mine is not None
                                 else torch.empty((n, w), dtype=slab.dtype,
                                                  device=slab.device))
                        bootstrap.broadcast_(chunk, r, self.process_group)
                    else:
                        chunk = bootstrap.send_to_chief(
                            mine, r, self.process_group, (n, w), slab.dtype)
                    if keep:
                        host[r0 + s:r0 + s + n, c0:c0 + w].copy_(chunk)
        return host

    def get_table(self, params: EmbedParams, tid: int,
                  chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                  all_ranks: bool = True) -> Optional[np.ndarray]:
        """ONE global table on the host, ``[input_dim, output_dim]``,
        copied in row chunks of at most ``chunk_elems`` elements, so a
        checkpoint writer holds one table, not the model. numpy has no
        bfloat16, so bfloat16 tables come back as float32 (exact).

        At world > 1 every rank must call: with ``all_ranks`` the chunks
        are broadcast over the group (the reference's chunked
        allgather); with ``all_ranks=False`` each owner sends its chunks
        to rank 0 only, which keeps the table, and the others return
        ``None``."""
        t = self._table_tensor(params, tid, chunk_elems, all_ranks=all_ranks)
        if t is None:
            return None
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def get_weights(self, params: EmbedParams,
                    chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                    all_ranks: bool = True) -> Optional[List[np.ndarray]]:
        """The global tables on the host (:meth:`get_table` each; at
        world > 1 with ``all_ranks=False``, ``None`` on ranks other than
        0)."""
        out = [self.get_table(params, tid, chunk_elems=chunk_elems,
                              all_ranks=all_ranks)
               for tid in range(len(self.strategy.global_configs))]
        return out if all_ranks or self.rank == 0 else None

    @staticmethod
    def _uid_lock_path() -> str:
        """Lock file of ``set_weights(use_lock=True)``: one per uid, so
        every concurrent load by this user serializes (the JAX package's
        name, so both packages' loads serialize together)."""
        import tempfile
        return os.path.join(tempfile.gettempdir(),
                            f"detpu_set_weights_{os.getuid()}.lock")

    def set_weights(self, weights: Sequence[Any],
                    dtype: torch.dtype = torch.float32,
                    device="cuda",
                    chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                    use_lock: bool = False,
                    src_dtype=None) -> EmbedParams:
        """Build the slab dict from full global tables (numpy arrays,
        ``ml_dtypes`` bfloat16 arrays, tensors, or ``.npy`` paths, which
        are memory-mapped), copied in row chunks of at most
        ``chunk_elems`` elements so the host never holds more than one
        chunk beyond the sources.

        ``src_dtype``: the dtype ``.npy`` sources were SAVED in. ``np.save``
        of a bfloat16 array writes an opaque ``'<V2'`` descriptor that
        ``np.load`` returns as ``|V2``; such sources are re-viewed as
        bfloat16 bits here (``"bfloat16"`` or ``torch.bfloat16``; the
        checkpoint codec records it in ``meta.json``).

        At world > 1 each rank builds only its own slab ``[1, rows_cap,
        w]``, reading its tables' rows (for a column slice its columns,
        for a row slice its row range) from the full sources.

        ``use_lock=True`` serializes the build across this user's
        processes on one per-uid file lock (the JAX package's lock); at
        world > 1 the ranks also take strict turns in rank order, each
        build between group barriers (every rank joins every barrier), as
        the JAX package's processes do. The lock wraps only the rank's
        own build, never a barrier wait: held across a wait it would
        deadlock two ranks on one host (one holds the lock waiting at
        the barrier, the other waits on the lock)."""
        from ..utils import runtime

        runtime.fault_point("checkpoint_read")
        dev = resolve_device(device)
        loaded = [np.load(w, mmap_mode="r") if isinstance(w, str) else w
                  for w in weights]
        if any(_is_void(a) for a in loaded):
            if src_dtype is None:
                raise ValueError(
                    "sources carry an opaque (void) dtype: np.save of an "
                    "extension dtype like bfloat16 does not round-trip "
                    "through np.load; pass src_dtype= with the dtype they "
                    "were saved in")
            if str(src_dtype).replace("torch.", "") != "bfloat16":
                raise ValueError(f"void sources can only be re-viewed as "
                                 f"bfloat16, got src_dtype={src_dtype!r}")
        if len(loaded) != len(self.strategy.global_configs):
            raise ValueError("set_weights needs one array per global table")
        for tid, (src, cfg) in enumerate(
                zip(loaded, self.strategy.global_configs)):
            want = (int(cfg["input_dim"]), int(cfg["output_dim"]))
            if tuple(src.shape) != want:
                raise ValueError(
                    f"Table {tid}: expected shape {want}, got "
                    f"{tuple(src.shape)}")

        def rows_of(src, s, n, c0, w):
            part = (src[s:s + n] if src.shape[1] == w
                    else src[s:s + n, c0:c0 + w])
            if _is_void(part):
                bits = np.array(part).view(np.int16)  # a writable copy
                return torch.from_numpy(bits).view(torch.bfloat16)
            return host_tensor(part)

        def build():
            out = {}
            mine = self._slice_plan()[self.rank]
            for w in self.widths:
                buf = torch.zeros((1, self.rows_cap[w], w), dtype=dtype,
                                  device=dev)
                step = max(1, int(chunk_elems) // w)
                for tid, roff, rows, c0, tw, r0 in mine:
                    if tw != w:
                        continue
                    src = loaded[tid]
                    for s in range(0, rows, step):
                        n = min(step, rows - s)
                        buf[0, roff + s:roff + s + n].copy_(
                            rows_of(src, r0 + s, n, c0, w).to(dtype))
                out[_wkey(w)] = buf
            return out

        if not use_lock:
            return build()
        import fcntl

        def locked_build():
            with open(self._uid_lock_path(), "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                try:
                    return build()
                finally:
                    fcntl.flock(lock_file, fcntl.LOCK_UN)

        if self.world_size == 1:
            return locked_build()
        me = self.rank
        for _ in range(me):
            bootstrap.barrier(self.process_group)
        out = locked_build()
        for _ in range(me, self.world_size):
            bootstrap.barrier(self.process_group)
        return out

    @staticmethod
    def local_view(params):
        """Drop the leading world axis of every 3-D tensor of a slab dict
        or of its optimizer state (``[1, rows, w]`` -> ``[rows, w]``,
        ``SparseAdam``'s count ``[1, 1, 1]`` -> ``[1, 1]``; views),
        mapping over tuple states; other leaves (an empty state) pass
        through."""
        return _map_tensors(
            lambda v: v[0] if v.dim() == 3 else v, params)

    @staticmethod
    def stacked_view(params):
        """The inverse of :meth:`local_view`: re-add the leading world
        axis of every 2-D tensor (views)."""
        return _map_tensors(
            lambda v: v[None] if v.dim() == 2 else v, params)

    # ----------------------------------------------------------------- forward

    @staticmethod
    def _dense_enc(shape, comb) -> tuple:
        """Static routing descriptor of a dense input: ``("d", hotness,
        num_slots)``. With a combiner the LAST dim is the reduced hotness
        and every lead position beyond the batch becomes its own slot;
        without one, every id is a hotness-1 slot."""
        dims = tuple(int(d) for d in shape[1:])
        if comb:
            h = dims[-1] if dims else 1
            ns = int(np.prod(dims[:-1], dtype=np.int64)) if len(dims) > 1 \
                else 1
            return ("d", h, ns)
        ns = int(np.prod(dims, dtype=np.int64)) if dims else 1
        return ("d", 1, ns)

    @staticmethod
    def _weight_bits(weights, cap: int, comm_dtype, device) -> torch.Tensor:
        """Per-id float weights -> the int payload that rides the id
        block: float32 bits as int32, widened to ``comm_dtype`` (an int64
        block keeps them in its low 32 bits)."""
        w = torch.as_tensor(weights).to(device=device, dtype=torch.float32)
        return w.reshape(cap).view(torch.int32).to(comm_dtype)

    def _normalize_inputs(self, inputs, device):
        """Promote to a common int dtype (int64 if any input, or any
        ragged input's values or row splits, is int64, else int32) on
        ``device``. Dense inputs flatten to ``[batch, -1]``;
        :class:`~..ops.embedding_lookup.Ragged` inputs become ``("r",
        values [cap], lengths [batch])`` records, ``("rw", values,
        lengths, weight_bits [cap])`` with weights; a
        :class:`~..ops.embedding_lookup.SparseIds` input is converted to
        CSR first (``row_to_split``, K10). Returns ``(entries, encs,
        shapes, comm_dtype)``: the entries, the static routing
        descriptors the plan is built from (``("d", hotness,
        num_slots)`` / ``("r"|"rw", capacity)``), and the original dense
        shapes (``None`` for ragged; output ranks follow them)."""
        if len(inputs) != self.strategy.num_inputs:
            raise ValueError(
                f"Expected {self.strategy.num_inputs} inputs, got "
                f"{len(inputs)}")
        inputs = [self._as_ragged(i, device) if isinstance(i, SparseIds)
                  else i if isinstance(i, Ragged) else torch.as_tensor(i)
                  for i in inputs]

        def arrays(inp):
            return ((inp.values, inp.row_splits) if isinstance(inp, Ragged)
                    else (inp,))

        comm_dtype = (torch.int64 if any(
            torch.as_tensor(a).dtype == torch.int64
            for inp in inputs for a in arrays(inp)) else torch.int32)
        out, encs, shapes = [], [], []
        for i, inp in enumerate(inputs):
            tid = self.strategy.input_table_map[i]
            comb = self.strategy.global_configs[tid].get("combiner")
            if isinstance(inp, Ragged):
                if not comb:
                    raise ValueError(
                        f"Ragged input {i} requires its table to have a "
                        "combiner (multi-hot ragged ids are reduced by "
                        "the combining lookup)")
                values = torch.as_tensor(inp.values).to(device=device,
                                                        dtype=comm_dtype)
                splits = torch.as_tensor(inp.row_splits).to(device)
                lengths = (splits[1:] - splits[:-1]).to(comm_dtype)
                cap = int(values.shape[0])
                if inp.weights is not None:
                    out.append(("rw", values, lengths, self._weight_bits(
                        inp.weights, cap, comm_dtype, device)))
                    encs.append(("rw", cap))
                else:
                    out.append(("r", values, lengths))
                    encs.append(("r", cap))
                shapes.append(None)
                continue
            inp = inp.to(device=device, dtype=comm_dtype)
            shapes.append(tuple(inp.shape))
            encs.append(self._dense_enc(inp.shape, comb))
            out.append(inp.reshape(inp.shape[0], -1) if inp.dim() != 1
                       else inp[:, None])
        return out, encs, shapes, comm_dtype

    @staticmethod
    def _enc_of_hot(h) -> tuple:
        """An :class:`MpInputs` ``hots`` entry as a routing descriptor: an
        int is a 2-D dense hotness; tuples pass through (``("r"|"rw",
        cap)`` ragged, ``("d", hot, num_slots)`` N-D dense)."""
        if isinstance(h, (tuple, list)):
            if h[0] == "d":
                return ("d", int(h[1]), int(h[2]) if len(h) > 2 else 1)
            return (h[0], int(h[1]))
        return ("d", int(h), 1)

    def pack_mp_inputs(self, inputs, dtype=None, hots=None,
                       local_batch: Optional[int] = None,
                       as_numpy: bool = False, device="cuda",
                       rank: Optional[int] = None) -> MpInputs:
        """Pack per-feature GLOBAL-batch ids into :class:`MpInputs` on the
        host (numpy), the JAX package's ``pack_mp_inputs``.

        ``inputs[i]`` is ``[global_batch]`` / ``[global_batch, hotness]``
        dense ids or a :class:`~..ops.embedding_lookup.Ragged` over the
        global batch (values ``[cap]``, row splits ``[global_batch + 1]``,
        optional weights), ordered by shard (shard ``s`` owns rows
        ``s * b:(s + 1) * b``); numpy or CPU tensors. An entry may be
        ``None`` (a feature only other processes hold): then ``hots``
        (every input's encoding: an int hotness, ``("r"|"rw", cap)``) is
        required, and ``local_batch`` too when every entry is ``None``. A
        ragged input packs each shard's ids at a per-shard capacity: its
        global capacity, or ``hots[i]``'s; a shard whose ids overflow it
        raises.

        Args:
          dtype: the id dtype (numpy or torch); default int64 if any given
            array is int64, else int32 (the data-parallel promotion).
          as_numpy: return the packed blocks as host numpy.
          device: else the block goes to this device as a tensor.
          rank: pack only that rank's block ``[world_src, l_max]`` (a
            tensor path default: this process's rank at world > 1);
            ``None`` with ``as_numpy`` packs every rank's, ``[world,
            world, l_max]``.
        """
        world = self.world_size

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)

        arrs = []
        for x in inputs:
            if isinstance(x, Ragged):  # its fields as numpy
                arrs.append(Ragged(values=host(x.values),
                                   row_splits=host(x.row_splits),
                                   weights=None if x.weights is None
                                   else host(x.weights)))
            elif x is None:
                arrs.append(None)
            else:
                a = host(x)
                arrs.append(a[:, None] if a.ndim == 1 else a)
        if len(arrs) != self.strategy.num_inputs:
            raise ValueError(
                f"Expected {self.strategy.num_inputs} inputs, got "
                f"{len(arrs)}")

        def glen(a):
            return (a.row_splits.shape[0] - 1 if isinstance(a, Ragged)
                    else a.shape[0])

        some = next((a for a in arrs if a is not None), None)
        if some is None:
            if local_batch is None or hots is None:
                raise ValueError(
                    "pack_mp_inputs with all-None inputs needs explicit "
                    "hots= and local_batch= (the layout must match the "
                    "owning processes')")
            b = int(local_batch)
        else:
            gb = glen(some)
            if gb % world:
                raise ValueError(
                    f"Global batch {gb} not divisible by world size {world}")
            b = gb // world
            if local_batch is not None and int(local_batch) != b:
                raise ValueError(
                    f"local_batch={local_batch} contradicts inputs ({b})")
            for i, a in enumerate(arrs):
                if a is not None and glen(a) != gb:
                    raise ValueError(f"Input {i} batch {glen(a)} != {gb}")

        def is64(a):
            if isinstance(a, Ragged):
                return np.int64 in (a.values.dtype, a.row_splits.dtype)
            return a.dtype == np.int64

        if dtype is None:
            np_dtype = np.dtype(np.int64 if any(
                a is not None and is64(a) for a in arrs) else np.int32)
        else:
            np_dtype = np.dtype(str(dtype).replace("torch.", ""))
        if hots is None and any(a is None for a in arrs):
            raise ValueError(
                "pack_mp_inputs with None entries needs explicit hots= "
                "(the encoding of every input must be globally known)")
        encs = []
        for i, a in enumerate(arrs):
            comb = self.strategy.global_configs[
                self.strategy.input_table_map[i]].get("combiner")
            if hots is not None:
                enc = self._enc_of_hot(hots[i])
            elif isinstance(a, Ragged):
                enc = ("rw" if a.weights is not None else "r",
                       int(a.values.shape[0]))
            else:
                enc = self._dense_enc(a.shape, comb)
            if a is not None:
                if isinstance(a, Ragged) != (enc[0] in ("r", "rw")):
                    raise ValueError(f"Input {i} encoding {enc} does not "
                                     "match the provided value type")
                if isinstance(a, Ragged) and \
                        (a.weights is not None) != (enc[0] == "rw"):
                    raise ValueError(f"Input {i}: weighted ragged needs an "
                                     f"('rw', cap) hots entry, got {enc}")
                if enc[0] == "d":
                    canon = self._dense_enc(a.shape, comb)
                    # without a combiner ("d", h, ns) and ("d", 1, h * ns)
                    # build the same hotness-1 slot layout
                    ok = (enc[1:] == canon[1:] if comb
                          else enc[1] * enc[2] == canon[1] * canon[2])
                    if not ok:
                        raise ValueError(
                            f"Input {i} shape {a.shape} does not match "
                            f"hots[{i}]={hots[i] if hots else enc}")
            encs.append(enc)

        plan = self._get_plan(encs, b)
        if rank is None and not as_numpy and world > 1:
            rank = self.rank
        dests = range(world) if rank is None else [int(rank)]
        packed_np = np.zeros((len(dests), world, plan.l_max), np_dtype)
        for inst in plan.instances:
            a = arrs[inst.input_id]
            if a is None or inst.rank not in dests:
                continue
            row = packed_np[inst.rank if rank is None else 0]
            g = plan.groups[inst.group]
            p0 = g.goff + inst.slot0 * g.blen
            span = inst.num_slots * g.blen
            if g.kind in ("r", "rw"):
                values, splits = a.values, a.row_splits
                cap = g.hot
                for sh in range(world):
                    lo, hi = int(splits[sh * b]), int(splits[(sh + 1) * b])
                    if hi - lo > cap:
                        raise ValueError(
                            f"Input {inst.input_id}: shard {sh} nnz "
                            f"{hi - lo} exceeds per-shard capacity {cap}")
                    blk = np.zeros(g.blen, np_dtype)
                    blk[:hi - lo] = values[lo:hi]
                    blk[cap:cap + b] = np.diff(splits[sh * b:(sh + 1) * b
                                                      + 1])
                    if g.kind == "rw":  # float32 bits ride the block
                        wb = np.zeros(cap, np.float32)
                        wb[:hi - lo] = a.weights[lo:hi]
                        blk[cap + b:] = wb.view(np.int32)
                    row[sh, p0:p0 + span] = blk
            else:
                if inst.transposed:  # slot-major within each shard block
                    flat = (a.reshape(world, b, inst.num_slots, g.hot)
                            .transpose(0, 2, 1, 3).reshape(world, -1))
                else:
                    flat = a.reshape(world, -1)
                row[:, p0:p0 + span] = flat
        hots_out = tuple(
            (enc[1] if enc[2] == 1 else enc) if enc[0] == "d" else enc
            for enc in encs)
        if as_numpy:
            packed = packed_np if rank is None else packed_np[0]
        else:
            packed = torch.from_numpy(packed_np[0] if rank is not None
                                      else packed_np).to(
                resolve_device(device))
        return MpInputs(packed=packed, hots=hots_out, local_batch=b)

    def _mp_block(self, inputs, device):
        """This rank's received id block ``[world, l_max]`` from an
        :class:`MpInputs` batch, and its plan encodings and batch."""
        if not isinstance(inputs, MpInputs):
            raise ValueError(
                "dp_input=False requires an MpInputs batch; build one with "
                "pack_mp_inputs()")
        if len(inputs.hots) != self.strategy.num_inputs:
            raise ValueError(
                f"Expected {self.strategy.num_inputs} hotness entries, got "
                f"{len(inputs.hots)}")
        encs = [self._enc_of_hot(h) for h in inputs.hots]
        b = int(inputs.local_batch)
        plan = self._get_plan(encs, b)
        block = torch.as_tensor(inputs.packed)
        if block.dim() == 3 and block.shape[0] == self.world_size:
            block = block[self.rank]  # every rank's blocks: take this one's
        elif block.dim() == 3 and block.shape[0] == 1:
            block = block[0]
        if tuple(block.shape) != (self.world_size, plan.l_max):
            raise ValueError(
                f"MpInputs packed shape {tuple(block.shape)} does not match "
                f"the plan layout {(self.world_size, plan.l_max)}; repack "
                "with pack_mp_inputs() from this DistributedEmbedding")
        if block.dtype not in (torch.int32, torch.int64):
            block = block.to(torch.int32)
        return block.to(device).contiguous(), encs, b, plan

    @staticmethod
    def _as_ragged(inp: SparseIds, device) -> Ragged:
        """A COO batch as CSR: its row ids -> row splits (``row_to_split``,
        K10 on the card), in the values' dtype."""
        values = torch.as_tensor(inp.values).to(device)
        splits = row_to_split(torch.as_tensor(inp.indices).to(device),
                              inp.dense_shape[0], dtype=values.dtype)
        return Ragged(values=values, row_splits=splits, weights=inp.weights)

    def _get_plan(self, encs, b: int) -> plan_mod.ExchangePlan:
        key = (tuple(encs), int(b))
        p = self._plan_cache.get(key)
        if p is None:
            p = plan_mod.build_plan(self.strategy, self.row_offsets_list,
                                    encs, int(b))
            self._plan_cache[key] = p
        return p

    def _plan_meta(self, plan, gi: int, device, reps: int = 1):
        """Device arrays of one group's per-slot plan rows (this rank's
        row of the ``[world, n]`` plan tensors, the JAX ``_plan_row``),
        cached per plan: ``rows``/``roff`` (int64), the divisor (``hot``
        on mean slots of a multi-hot group, else 1) and the zero-read mask
        (int32, set on the row-sliced slots, or on every slot under
        ``masked_reads``; ``None`` when no slot is set), each repeated
        ``reps`` times (one copy per source rank of a ``[world * n, ...]``
        region)."""
        key = (id(plan), gi, str(device), reps)
        meta = self._meta_cache.get(key)
        if meta is None:
            g, my = plan.groups[gi], self.rank
            mean = plan.mean[gi][my] > 0
            div = np.where(mean & (g.hot > 1), float(g.hot), 1.0)
            masked = (np.ones(g.n, bool) if self.masked_reads
                      else plan.rsliced[gi][my] > 0)
            mask = (torch.as_tensor(np.tile(masked, reps), dtype=torch.int32,
                                    device=device) if masked.any() else None)
            meta = (torch.as_tensor(np.tile(plan.rows[gi][my], reps),
                                    dtype=torch.int64, device=device),
                    torch.as_tensor(np.tile(plan.roff[gi][my], reps),
                                    dtype=torch.int64, device=device),
                    torch.as_tensor(np.tile(div, reps), dtype=torch.float32,
                                    device=device),
                    mask)
            self._meta_cache[key] = meta
        return meta

    def _plan_rbase(self, plan, gi: int, device, reps: int = 1):
        """One group's row bases (this rank's row of ``plan.rbase``,
        int64, repeated ``reps`` times), cached per plan; ``None`` when no
        slot of the group is row-sliced on any rank (the JAX lookup's
        gate)."""
        key = ("rbase", id(plan), gi, str(device), reps)
        if key not in self._meta_cache:
            self._meta_cache[key] = (
                torch.as_tensor(np.tile(plan.rbase[gi][self.rank], reps),
                                dtype=torch.int64, device=device)
                if plan.rsliced[gi].any() else None)
        return self._meta_cache[key]

    def _plan_ragged_meta(self, plan, gi: int, device, reps: int = 1):
        """A ragged group's per-slot flags (this rank's row, repeated
        ``reps`` times), cached per plan: ``mean`` (int32, ``None`` when
        no slot is a mean slot; a ragged row's divisor is its own length,
        not the group's capacity) and ``valid`` (int32, ``None`` when
        every slot is live)."""
        key = ("ragged", id(plan), gi, str(device), reps)
        meta = self._meta_cache.get(key)
        if meta is None:
            my = self.rank
            mean, valid = plan.mean[gi][my] > 0, plan.valid[gi][my] > 0
            meta = (torch.as_tensor(np.tile(mean, reps), dtype=torch.int32,
                                    device=device) if mean.any() else None,
                    None if valid.all() else
                    torch.as_tensor(np.tile(valid, reps), dtype=torch.int32,
                                    device=device))
            self._meta_cache[key] = meta
        return meta

    def _plan_bwd_meta(self, plan, gi: int, device):
        """The backward's per-slot masks of one group (this rank's row),
        cached per plan: ``valid`` (bool, ``None`` when every slot is
        live) and ``mean`` (bool, ``None`` when no slot is a mean slot)."""
        key = ("bwd", id(plan), gi, str(device))
        meta = self._meta_cache.get(key)
        if meta is None:
            my = self.rank
            valid, mean = plan.valid[gi][my] > 0, plan.mean[gi][my] > 0
            meta = (None if valid.all() else
                    torch.as_tensor(valid, device=device),
                    torch.as_tensor(mean, device=device) if mean.any()
                    else None)
            self._meta_cache[key] = meta
        return meta

    def __call__(self, params: EmbedParams, inputs) -> List[torch.Tensor]:
        """Forward pass: one output per input, in input order, with the
        input's rank preserved (no combiner: ``shape[1:] + (w,)``;
        combiner: the lead dims survive the trailing-dim reduction)."""
        return self.forward_with_residuals(params, inputs)[0]

    def forward_with_residuals(self, params: EmbedParams, inputs,
                               streaming=None, phase_tag: str = ""):
        """Forward pass that also returns the routing residuals
        ``("dist", ids_block, encs, b)`` the sparse backward will read
        (``ids_block`` is the ``[world, l_max]`` block this rank RECEIVED:
        source rank ``r``'s ids for this rank's tables).

        ``streaming`` (streaming vocabularies, :mod:`.streaming`):
        ``(config, state)`` (the local state, without its leading axis)
        remaps every streaming-table slot's external ids through the slot
        map right after the id block is built or received, or taken from
        an :class:`MpInputs` batch (a copy: the batch stays as it is;
        hits read their slot,
        everything else its shared bucket) and stages this step's
        admissions; the return grows a third element, the per-width
        ``pending`` dict the trainer hands to :func:`.streaming.commit`.
        ``(config, state, False)`` is the read-only form (eval, serving):
        remap only, a 2-tuple return. ``(config, state, "serve")`` is the
        pipelined step's per-microbatch form: the read-only remap (one
        K16 read-only launch a width, nothing admitted) plus a third
        element, this call's raw per-width
        :class:`~.streaming.WidthStream` dict, which the step
        concatenates over its microbatches for
        :meth:`streaming_stage`. The residuals carry the REMAPPED
        block, so the backward and telemetry see in-range slab rows.

        ``phase_tag`` suffixes every phase scope of this forward (the
        pipelined step's ``_mb{k}`` microbatch instances).

        At world > 1 every rank of the group must call with its own rows
        of the batch: the ids go to their tables' ranks, each rank looks
        up its tables, and the outputs come back as ``[b, W]`` per input
        (the column slices of a sliced table side by side, a row-sliced
        table's slices summed in slice order). A ``dp_input=False`` layer
        takes an :class:`MpInputs` batch instead: its block (this rank's,
        see :class:`MpInputs`) IS the received id block, and the id
        exchange does not run.

        The forward runs in three parts (:meth:`_forward_begin`,
        :meth:`_forward_lookup`, :meth:`_forward_finish`), here back to
        back; the pipelined step runs them apart, with each exchange left
        in flight."""
        return self._forward_finish(self._forward_lookup(
            self._forward_begin(params, inputs, streaming, phase_tag)))

    def _forward_begin(self, params: EmbedParams, inputs, streaming=None,
                       tag: str = "", in_flight: bool = False
                       ) -> "_Forward":
        """The forward's first part: normalize the inputs, plan, build the
        send blocks (K19) and start the id exchange (at world 1 the blocks
        are the received block; with an :class:`MpInputs` batch the block
        is taken as it is). ``in_flight`` leaves the exchange in flight;
        else it completes here."""
        device = next(iter(params.values())).device
        f = _Forward({k: v[0] for k, v in params.items()}, streaming, tag,
                     in_flight)
        if isinstance(inputs, MpInputs) and self.world_size == 1:
            raise ValueError("world_size == 1 takes a plain input list (mp "
                             "and dp input coincide)")
        if self.world_size > 1 and (not self.dp_input
                                    or isinstance(inputs, MpInputs)):
            if self.dp_input:
                raise ValueError("an MpInputs batch needs a dp_input=False "
                                 "layer")
            ids_recv, f.encs, f.b, f.plan = self._mp_block(inputs, device)
            if streaming is not None:  # the remap writes the block
                ids_recv = ids_recv.clone()
            f.ids = bootstrap.InFlight(ids_recv)
            return f
        entries, encs, f.shapes, comm_dtype = self._normalize_inputs(
            inputs, device)

        def batch_of(e):
            return e[2].shape[0] if isinstance(e, tuple) else e.shape[0]

        b = batch_of(entries[0])
        if any(batch_of(e) != b for e in entries):
            raise ValueError("All inputs must share the batch dimension")
        f.encs, f.b = encs, b
        f.plan = plan = self._get_plan(encs, b)
        if self.world_size == 1:
            with obs.scope(schedule_mod.PHASE_ID_EXCHANGE + tag):
                f.ids = bootstrap.InFlight(
                    exchange_mod.build_send_blocks(self, plan, entries,
                                                   comm_dtype, device))
        elif in_flight:
            f.ids = exchange_mod.exchange_ids_start(
                self, plan, entries, comm_dtype, device, tag)
        else:
            f.ids = bootstrap.InFlight(exchange_mod.exchange_ids(
                self, plan, entries, comm_dtype, device, tag))
        return f

    def _forward_lookup(self, f: "_Forward") -> "_Forward":
        """The forward's second part: wait for the received id block, run
        the streaming remap, the lookups and (world > 1) start the output
        exchange."""
        ids_recv = exchange_mod.wait(
            f.ids, schedule_mod.PHASE_ID_EXCHANGE + f.tag)
        f.ids = None
        if f.streaming is not None:
            ids_recv, f.pending = self._streaming_remap(
                f.plan, ids_recv, f.streaming, tag=f.tag)
        f.ids_recv = ids_recv
        if self.world_size == 1:
            f.reds = lookup_mod.plan_lookup_groups(self, f.plan, f.local,
                                                   ids_recv, tag=f.tag)
            return f
        mp_out = lookup_mod.plan_lookup(self, f.plan, f.local, ids_recv,
                                        tag=f.tag)
        f.out = (exchange_mod.exchange_outputs_start(self, mp_out, f.tag)
                 if f.in_flight else bootstrap.InFlight(
                     exchange_mod.exchange_outputs(self, mp_out, f.tag)))
        return f

    def _forward_finish(self, f: "_Forward"):
        """The forward's last part: (world > 1) wait for the outputs and
        unpack them (the column slices of a sliced table side by side,
        row slices summed); the outputs in input order, the residuals and,
        with streaming, the pending dict."""
        plan, b = f.plan, f.b
        if self.world_size > 1:
            dp_recv = exchange_mod.wait(
                f.out, schedule_mod.PHASE_OUT_EXCHANGE + f.tag)
            f.out = None
            result = exchange_mod.unpack_outputs(self, plan, dp_recv)
        else:
            outs = []
            for inst in plan.instances:  # worker order == input order here
                g = plan.groups[inst.group]
                red = f.reds[inst.group]  # [1, n, b, w]
                if inst.num_slots == 1:
                    o = red[0, inst.slot0]
                else:
                    o = red[0, inst.slot0:inst.slot0 + inst.num_slots
                            ].transpose(0, 1).reshape(b, -1)
                shape = f.shapes[inst.input_id]
                if shape is not None and len(shape) >= 2:
                    comb = self.strategy.global_configs[
                        self.strategy.input_table_map[inst.input_id]
                    ].get("combiner")
                    lead = shape[1:] if comb is None else shape[1:-1]
                    if comb is None or lead:
                        o = o.reshape((b,) + tuple(lead) + (g.width,))
                outs.append(o)
            result = [outs[i] for i in self.strategy.rev_global_input_ids]
            f.reds = None
        res = ("dist", f.ids_recv, tuple(f.encs), b)
        return (result, res) if f.pending is None else (result, res,
                                                        f.pending)

    # --------------------------------------------------------- streaming vocab

    def _streaming_plan_arrays(self, plan, gi: int, device):
        """One group's streaming plan arrays on this rank (JAX's per-slot
        ``_streaming_plan_arrays`` row of this rank, expanded to
        positions), cached per plan and rank: ``None`` when the group has
        no streaming slot here, else ``(slots, cap, nbuckets, tid,
        roff)``: the slot indices (int64 ``[k]``), then per position of
        those slots in every sender's block (sender-major, then slot,
        then position, as the region holds them: ``b * hot`` ids a dense
        slot, ``hot`` values a ragged one) its table's capacity, bucket
        count, table id (the hash salt) and slab row offset (int32)."""
        my = self.rank
        key = ("streaming", id(plan), gi, str(device), my)
        if key in self._meta_cache:
            return self._meta_cache[key]
        g = plan.groups[gi]
        per_slot = {}
        for inst in plan.instances:
            tid = self.strategy.input_table_map[inst.input_id]
            info = self.streaming_tables.get(tid)
            if inst.group != gi or inst.rank != my or info is None:
                continue
            for k in range(inst.slot0, inst.slot0 + inst.num_slots):
                per_slot[k] = (info[0], info[1], tid,
                               int(plan.roff[gi][my][k]))
        meta = None
        if per_slot:
            slots = sorted(per_slot)
            per = plan.b * g.hot if g.kind == "d" else g.hot
            cols = np.tile(np.repeat(np.asarray(
                [per_slot[k] for k in slots], np.int32), per, axis=0),
                (self.world_size, 1))
            meta = (torch.as_tensor(slots, dtype=torch.int64, device=device),
                    *(torch.as_tensor(np.ascontiguousarray(cols[:, j]),
                                      device=device) for j in range(4)))
        self._meta_cache[key] = meta
        return meta

    def _streaming_remap(self, plan, ids_recv, streaming, tag: str = ""):
        """Remap every streaming-table slot's external ids in the id block
        ``[world, l_max]`` (one block per sender) through the slot map
        (:func:`.streaming.remap_width`, one call per width over the
        streaming slots of all its groups in plan order, each group's
        positions sender-major, then slot, then position, as JAX orders
        them) and, in update mode, stage the admissions. Only live
        streaming positions are rewritten in place (``ids >= 0``; a
        ragged slot's positions below ``min(total length, capacity)``):
        other slots, dead positions, negative ids, lengths and weights
        stay as they are. A width with no streaming slot on this rank is
        not remapped (its state stays as it is). Returns ``(ids_recv,
        pending)``: ``{width: (staged_cms, remap)}`` in update mode, in
        the ``"serve"`` form (a read-only remap) ``{width: WidthStream}``,
        the raw stream each width was remapped from (feed
        :meth:`streaming_stage`), else ``None``. Each width runs under
        ``streaming_serve_w{w}{tag}`` (serve) or ``streaming_admit_w{w}``
        (the other forms)."""
        from . import streaming as smod

        if not self.streaming_tables:
            raise ValueError(
                "streaming= passed but no table declares a 'streaming' "
                "config entry")
        if len(streaming) == 2:
            (config, sstate), update = streaming, True
        else:
            config, sstate, update = streaming
        if update not in (True, False, "serve"):
            raise ValueError(
                f"streaming form {update!r}: the third element is True "
                "(stage admissions), False (read-only) or 'serve'")
        serve = update == "serve"
        if serve:
            update = False
        dev, b = ids_recv.device, plan.b
        world = ids_recv.shape[0]
        per_width: Dict[int, list] = {}
        sites = []
        for gi, g in enumerate(plan.groups):
            meta = self._streaming_plan_arrays(plan, gi, dev)
            if meta is None:
                continue
            slots, *per_pos = meta
            region = ids_recv[:, g.goff:g.goff + g.n * g.blen].view(
                world, g.n, g.blen)
            sel = region.index_select(1, slots)
            if g.kind == "d":
                vals = sel
                live = torch.ones_like(vals, dtype=torch.bool)
            else:  # values, then the lengths (and the weight bits)
                vals = sel[:, :, :g.hot]
                tot = sel[:, :, g.hot:g.hot + b].sum(dim=2,
                                                     dtype=torch.int32)
                live = (torch.arange(g.hot, dtype=torch.int32, device=dev)
                        [None, None] < tot.clamp(max=g.hot)[:, :, None])
            acc = per_width.setdefault(g.width, [])
            start = sum(p[0].numel() for p in acc)
            acc.append((vals.reshape(-1), live.reshape(-1), *per_pos))
            sites.append((g, region, slots, start, vals, live))
        remapped, pending = {}, {}
        for w, pieces in sorted(per_width.items()):
            stream = smod.WidthStream(*(
                torch.cat([p[j] for p in pieces]) if len(pieces) > 1
                else pieces[0][j] for j in range(6)))
            with obs.scope(f"streaming_serve_w{w}{tag}" if serve
                           else f"streaming_admit_w{w}"):
                remapped[w], pend = smod.remap_width(
                    sstate[_wkey(w)], stream, self.rows_cap[w], config,
                    update=update)
            if serve:
                pending[w] = stream
            elif pend is not None:
                pending[w] = pend
        for g, region, slots, start, vals, live in sites:
            new = remapped[g.width][start:start + vals.numel()].view(
                vals.shape)
            new = torch.where(live & (vals >= 0), new.to(vals.dtype), vals)
            region[:, slots, :vals.shape[2]] = new
        return ids_recv, (pending if update or serve else None)

    def streaming_stage(self, width_streams, config, sstate):
        """The pipelined step's ONE admission-staging pass: concatenate
        each width's raw external-id streams (the ``"serve"`` form's third
        return of :meth:`forward_with_residuals`, one dict a microbatch)
        in microbatch order and run :func:`.streaming.remap_width` in
        update mode over the result (one K16 update a width), under the
        ``streaming_admit_w{w}`` scope: the stream of the serialized
        step, microbatch-major, as the JAX package orders it. ``sstate``
        is the local streaming state. Returns the ``pending`` dict
        :func:`.streaming.commit` takes."""
        from . import streaming as smod

        widths = sorted({w for ws in width_streams for w in ws})
        pending: Dict[int, tuple] = {}
        for w in widths:
            parts = [ws[w] for ws in width_streams if w in ws]
            stream = smod.WidthStream(*(
                torch.cat([getattr(p, f) for p in parts]) if len(parts) > 1
                else getattr(parts[0], f) for f in smod.WidthStream._fields))
            with obs.scope(f"streaming_admit_w{w}"):
                _, pending[w] = smod.remap_width(
                    sstate[_wkey(w)], stream, self.rows_cap[w], config,
                    update=True)
        return pending

    # ----------------------------------------------------------- observability

    def step_metrics(self, residuals, out_dtype=None
                     ) -> Dict[str, torch.Tensor]:
        """Exchange and overflow metrics of one forward from its
        residuals (JAX's ``step_metrics``): a few sums over the id block
        this rank received and tallies of this rank's plan rows, each a
        ``[1]`` tensor on the residuals' device (the trainer adds the
        norms, loss, step and sentinels, and at world > 1 gathers every
        rank's into JAX's ``[world]`` vectors):

        * ``ids_routed`` (int32): live ids this rank received, the dense
          slots' static count plus the ragged totals clamped to capacity;
        * ``id_overflow`` (int32): ragged ids claimed past a slot's
          capacity (ids the lookup dropped);
        * ``invalid_id_count`` (int32): negative or out-of-vocabulary ids
          among the live ones, dead and row-sliced slots skipped;
        * ``id_a2a_bytes``, ``out_a2a_bytes``, ``grad_a2a_bytes``
          (float32): bytes leaving this rank per step in the three
          exchanges (0 at world 1);
        * ``out_pad_frac`` (float32): dead-column fraction of this rank's
          output rows.

        ``out_dtype``: the exchanged activations' dtype (the trainer
        passes the cotangents'); default ``compute_dtype`` or float32."""
        _, ids_recv, encs, b = residuals
        plan = self._get_plan(list(encs), b)
        world, my, dev = self.world_size, self.rank, ids_recv.device
        i32 = torch.int32
        id_bytes = ids_recv.element_size()
        out_bytes = (out_dtype or self.compute_dtype or torch.float32
                     ).itemsize
        dense_live = live_cols = 0
        for inst in plan.instances:
            if inst.rank != my:
                continue
            g = plan.groups[inst.group]
            live_cols += plan.out_width(inst)
            if g.kind == "d":
                dense_live += world * b * inst.num_slots * g.hot
        routed = torch.full((1,), dense_live, dtype=i32, device=dev)
        overflow = torch.zeros((1,), dtype=i32, device=dev)
        invalid = torch.zeros((1,), dtype=i32, device=dev)
        for gi, g in enumerate(plan.groups):
            region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
            rows, _, _, _ = self._plan_meta(plan, gi, dev)
            slot_ok = torch.as_tensor(
                (plan.valid[gi][my] > 0) & (plan.rsliced[gi][my] == 0),
                device=dev)
            if g.kind == "d":
                ids = region.reshape(world, g.n, b, g.hot)
                bad = (((ids < 0) | (ids >= rows[None, :, None, None]))
                       & slot_ok[None, :, None, None])
                invalid += bad.sum(dtype=i32)
                continue
            r3 = region.reshape(world, g.n, g.blen)
            values = r3[:, :, :g.hot]
            tot = r3[:, :, g.hot:g.hot + b].sum(dim=2, dtype=i32)
            clamped = tot.clamp(max=g.hot)
            routed += clamped.sum(dtype=i32)
            overflow += (tot - g.hot).clamp(min=0).sum(dtype=i32)
            live = (torch.arange(g.hot, dtype=i32, device=dev)[None, None]
                    < clamped[:, :, None])
            bad = (((values < 0) | (values >= rows[None, :, None]))
                   & live & slot_ok[None, :, None])
            invalid += bad.sum(dtype=i32)
        off_chip = float(world - 1)
        f32 = torch.float32
        a2a = off_chip * b * plan.s_max * out_bytes
        return {
            "ids_routed": routed,
            "id_overflow": overflow,
            "invalid_id_count": invalid,
            "id_a2a_bytes": torch.full((1,), off_chip * plan.l_max
                                       * id_bytes, dtype=f32, device=dev),
            "out_a2a_bytes": torch.full((1,), a2a, dtype=f32, device=dev),
            "grad_a2a_bytes": torch.full((1,), a2a, dtype=f32, device=dev),
            "out_pad_frac": 1.0 - torch.full(
                (1,), live_cols, dtype=f32, device=dev)
            / float(max(plan.s_max, 1)),
        }

    # --------------------------------------------------------------- telemetry

    def telemetry_streams(self, residuals) -> Dict[int, tuple]:
        """Per width, ``(ids [n] int32, live [n] bool)``: the logical slab
        rows the forward routed and whether each is live, over every
        group of that width in plan order (``residuals``: the second
        output of :meth:`forward_with_residuals`, or a list of them, whose
        streams concatenate; each group's ids sender-major, as received).
        A dense slot's id is live when it lies in its table slice and the
        slot is live; a ragged slot's position also when it lies within
        the slot's claimed values. On a row-sliced slot the id is first
        made local to the slice (its row base subtracted), so each id is
        counted on exactly the slice that owns it (JAX's
        ``update_telemetry``)."""
        res_list = ([residuals] if residuals and residuals[0] == "dist"
                    else list(residuals))
        world = self.world_size
        per_width: Dict[int, tuple] = {}
        for res in res_list:
            _, ids_recv, encs, b = res
            plan = self._get_plan(list(encs), b)
            for gi, g in enumerate(plan.groups):
                dev = ids_recv.device
                rows, roff, _, _ = self._plan_meta(plan, gi, dev)
                valid, _ = self._plan_bwd_meta(plan, gi, dev)
                rbase = self._plan_rbase(plan, gi, dev)
                region = ids_recv[:, g.goff:g.goff + g.n * g.blen]
                if g.kind == "d":
                    ids = region.reshape(world, g.n, b, g.hot)
                    per_slot = (slice(None), slice(None), None, None)
                else:
                    r3 = region.reshape(world, g.n, g.blen)
                    ids = r3[:, :, :g.hot]
                    tot = r3[:, :, g.hot:g.hot + b].sum(dim=2,
                                                        dtype=torch.int32)
                    per_slot = (slice(None), slice(None), None)
                if rbase is not None:
                    ids = ids - rbase[None][per_slot]
                live = (ids >= 0) & (ids < rows[None][per_slot])
                if valid is not None:
                    live = live & valid[None][per_slot]
                if g.kind != "d":
                    live = live & (torch.arange(
                        g.hot, dtype=torch.int32, device=dev)[None, None]
                        < tot.clamp(max=g.hot)[:, :, None])
                grow = (ids + roff[None][per_slot]).to(torch.int32)
                acc = per_width.setdefault(g.width, ([], []))
                acc[0].append(grow.reshape(-1))
                acc[1].append(live.reshape(-1))
        return {w: tuple(torch.cat(x) if len(x) > 1 else x[0] for x in acc)
                for w, acc in per_width.items()}

    def update_telemetry(self, tstate, residuals, config):
        """Fold one forward's routed ids into the carried access telemetry
        (:mod:`~..analysis.telemetry`), in place: per width slab, the
        count-min sketch and the top-k hot-row merge over the live
        logical slab rows (:meth:`telemetry_streams`; kernels K13-K15),
        then the step count and the cumulative routed-id load.

        Args:
          tstate: the telemetry state without its world axis
            (:func:`~..analysis.telemetry.local_state`).
          residuals: the second output of :meth:`forward_with_residuals`,
            or a list of them (their id streams fold as one).
          config: a :class:`~..analysis.telemetry.TelemetryConfig`.

        Widths fold in ascending order, each from its fold record, and
        ``ids_total`` adds the sum of their float32 live counts, summed in
        that order, as JAX does. Returns the state (the same tensors)."""
        streams = sorted(self.telemetry_streams(residuals).items())
        total = (torch.empty((1,), dtype=torch.float32,
                             device=tstate["ids_total"].device)
                 if streams else None)
        for k, (w, (ids, live)) in enumerate(streams):
            tel._record(tstate[_wkey(w)], ids, live, config, total,
                        first=k == 0)
        tstate["steps"].add_(1)
        if total is not None:
            tstate["ids_total"].add_(total)
        return tstate

    # --------------------------------------------------------- sparse backward

    def sparse_apply_gradients(self, params: EmbedParams, opt_state,
                               residuals, out_grads, optimizer, lr,
                               scale=None, enable=None):
        """Manual sparse backward + IN-PLACE optimizer update.

        Replaces autodiff through the slabs: ``out_grads`` are the
        cotangents of this layer's outputs (from differentiating the
        dense model w.r.t. the embedding activations), applied as
        per-row scatter updates; no dense table gradient is built.

        Args:
          params: the slabs (``[1, rows, w]`` or ``[rows, w]``), updated
            in place.
          opt_state: optimizer slab state from ``optimizer.init``
            (slab-shaped state is updated in place too).
          residuals: second output of :meth:`forward_with_residuals`.
          out_grads: cotangents matching the forward outputs.
          optimizer: :class:`~.optimizers.SparseSGD` or
            :class:`~.optimizers.SparseAdagrad`.
          lr: learning rate, a Python number or a 0-d float32 tensor.
          scale: gradient pre-scale; defaults to ``1/world_size``.
          enable: optional 0-d bool tensor; when False the update is
            skipped with the slabs and their optimizer state bitwise
            unchanged (every id goes to
            the dropped-row sentinel, see
            :func:`~.apply.apply_width_streams`).

        Returns:
          ``(params, opt_state)`` as ``[rows, w]`` views of the updated
          slabs and the optimizer state.
        """
        return apply_mod.sparse_apply_gradients(
            self, params, opt_state, residuals, out_grads, optimizer, lr,
            scale=scale, enable=enable)
