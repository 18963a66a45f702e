"""Model-parallel embedding layer (counterpart of
``distributed_embeddings_tpu/parallel/dist_embedding.py``), at world 1.

What this slice ports: the constructor's placement plan and slab-offset
bookkeeping, ``init``, input normalization, the cached exchange plans,
the world-1 forward (``__call__`` / ``forward_with_residuals``), and
``get_table`` / ``get_weights`` / ``set_weights`` (chunked, with the
``src_dtype`` and ``use_lock`` of the checkpoint codec). Tables of one width stack row-major
into one LOGICAL slab per width, ``{"w128": [world, rows_cap, 128]}``,
each table starting at the same row offset as in the JAX package (its
lane-packing alignment is kept, see ``ops/packed_slab.py``), so both
packages build identical exchange plans. Every (width, hotness) group
of the plan is ONE launch of the gather kernel (``parallel/lookup.py``).

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
``parallel/streaming.py``, kernels K16-K17).

Not yet ported, each raising ``NotImplementedError`` with its ROADMAP
item: ``world_size > 1`` (A7), row slicing (A9), the pipelined step's
``"serve"`` streaming form (A7) and the ``'raise'`` invalid-id policy
(A12); model-parallel input and step schedules (A5b, A7, A11b).

Ids must lie in ``[0, input_dim)``; out-of-range ids CLIP in the
forward (a negative id reads row 0, one past the table its last row),
as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..analysis import telemetry as tel
from ..layers.embedding import default_embeddings_init
from ..ops import packed_slab as ps
from ..ops.embedding_lookup import Ragged, SparseIds, row_to_split
from ..utils.convert import host_tensor
from ..utils.device import resolve_device
from . import apply as apply_mod
from . import exchange as exchange_mod
from . import lookup as lookup_mod
from . import plan as plan_mod
from .strategy import DistEmbeddingStrategy

EmbedParams = Dict[str, torch.Tensor]

#: host rows per copy in set_weights / get_weights: 128M elements, the
#: JAX package's checkpoint chunk
CHECKPOINT_CHUNK_ELEMS = 128 * 1024 * 1024


def _wkey(width: int) -> str:
    return f"w{width}"


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


class DistributedEmbedding:
    """Embedding tables behind one plan-driven lookup (world 1).

    Args follow the JAX package's ``DistributedEmbedding``:
      embeddings: table config dicts (``input_dim``, ``output_dim``,
        optional ``combiner`` and ``embeddings_initializer`` — an
        in-place ``init(out, generator)``, see ``layers/embedding.py``).
      world_size: must be 1 in this slice.
      strategy, column_slice_threshold, input_table_map, input_hotness,
        table_loads: passed to :class:`DistEmbeddingStrategy`.
      compute_dtype: torch dtype the outputs are cast to (``None`` keeps
        the table dtype).
      masked_reads: out-of-range ids read a ZERO row instead of clipping.
      invalid_id_policy: ``'clamp'`` (default) or ``'drop'`` (forces
        ``masked_reads``).
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
                 table_loads: Optional[Sequence[float]] = None):
        if int(world_size) != 1:
            raise NotImplementedError(
                "world_size > 1 (the all-to-all exchanges over NCCL) is "
                "not ported yet: ROADMAP A7")
        if row_slice is not None:
            raise NotImplementedError(
                "row slicing is not ported yet: ROADMAP A9")
        if invalid_id_policy == "raise":
            raise NotImplementedError(
                "the 'raise' ingestion checks are not ported yet: "
                "ROADMAP A12")
        if invalid_id_policy not in ("clamp", "drop"):
            raise ValueError(
                f"invalid_id_policy must be 'clamp' | 'drop' | 'raise', "
                f"got {invalid_id_policy!r}")
        self.world_size = 1
        self.compute_dtype = compute_dtype
        self.invalid_id_policy = invalid_id_policy
        self.masked_reads = bool(masked_reads) or invalid_id_policy == "drop"
        self.strategy = DistEmbeddingStrategy(
            embeddings, self.world_size, strategy=strategy,
            input_table_map=input_table_map,
            column_slice_threshold=column_slice_threshold,
            input_hotness=input_hotness, table_loads=table_loads)
        # streaming (dynamic-vocab) tables: {tid: (capacity, buckets)}.
        # The declared input_dim is the slab footprint (capacity slots,
        # then the shared bucket rows); only the id interpretation changes
        # (external ids remap through the carried slot map,
        # parallel/streaming.py). A slot map cannot span slices.
        self.streaming_tables: Dict[int, tuple] = {}
        slices = [0] * len(self.strategy.global_configs)
        for tids in self.strategy.table_ids_list:
            for tid in tids:
                slices[tid] += 1
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

    # ------------------------------------------------------------------ params

    def _tables_of_width(self, width: int):
        """``(config, slab row offset)`` of rank 0's tables of one width."""
        return [(c, self.row_offsets_list[0][m])
                for m, c in enumerate(self.strategy.local_configs_list[0])
                if int(c["output_dim"]) == width]

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device="cuda") -> EmbedParams:
        """Build ``{"w<width>": [world, rows_cap, width]}``.

        Each slab is allocated once (``torch.empty``) and filled IN
        PLACE, table by table, by its initializer (or, when every table
        of the width uses the default, by one uniform fill of the whole
        slab, as the JAX package's fast path does), so no second copy of
        a slab ever exists. Rows between and after tables are zeroed."""
        dev = resolve_device(device)
        out = {}
        for w in self.widths:
            buf = torch.empty((self.world_size, self.rows_cap[w], w),
                              dtype=dtype, device=dev)
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

    def _table_tensor(self, params: EmbedParams, tid: int,
                      chunk_elems: int = CHECKPOINT_CHUNK_ELEMS
                      ) -> torch.Tensor:
        """ONE global table ``[input_dim, output_dim]`` as a CPU tensor
        in the slab's dtype (bfloat16 kept), copied in row chunks of at
        most ``chunk_elems`` elements."""
        cfg = self.strategy.global_configs[tid]
        m = self.strategy.table_ids_list[0].index(tid)
        rows, w = int(cfg["input_dim"]), int(cfg["output_dim"])
        roff = self.row_offsets_list[0][m]
        slab = params[_wkey(w)][0]
        host = torch.empty((rows, w), dtype=slab.dtype)
        step = max(1, int(chunk_elems) // w)
        for s in range(0, rows, step):
            n = min(step, rows - s)
            host[s:s + n].copy_(slab[roff + s:roff + s + n])
        return host

    def get_table(self, params: EmbedParams, tid: int,
                  chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                  all_ranks: bool = True) -> np.ndarray:
        """ONE global table on the host, ``[input_dim, output_dim]``,
        copied in row chunks of at most ``chunk_elems`` elements, so a
        checkpoint writer holds one table, not the model. numpy has no
        bfloat16, so bfloat16 tables come back as float32 (exact).
        ``all_ranks`` matters only at world > 1 (ROADMAP A7): here the
        one process always gets the table."""
        del all_ranks
        t = self._table_tensor(params, tid, chunk_elems)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def get_weights(self, params: EmbedParams,
                    chunk_elems: int = CHECKPOINT_CHUNK_ELEMS,
                    all_ranks: bool = True) -> List[np.ndarray]:
        """The global tables on the host (:meth:`get_table` each)."""
        return [self.get_table(params, tid, chunk_elems=chunk_elems,
                               all_ranks=all_ranks)
                for tid in range(len(self.strategy.global_configs))]

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

        ``use_lock=True`` serializes the build across this user's
        processes on one per-uid file lock (the JAX package's; its
        cross-host turn-taking belongs to world > 1, ROADMAP A7)."""
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

        def rows_of(src, s, n):
            part = src[s:s + n]
            if _is_void(part):
                bits = np.array(part).view(np.int16)  # a writable copy
                return torch.from_numpy(bits).view(torch.bfloat16)
            return host_tensor(part)

        def build():
            out = {}
            for w in self.widths:
                buf = torch.zeros((self.world_size, self.rows_cap[w], w),
                                  dtype=dtype, device=dev)
                step = max(1, int(chunk_elems) // w)
                for m, c in enumerate(self.strategy.local_configs_list[0]):
                    if int(c["output_dim"]) != w:
                        continue
                    src = loaded[self.strategy.table_ids_list[0][m]]
                    roff, rows = (self.row_offsets_list[0][m],
                                  int(c["input_dim"]))
                    for s in range(0, rows, step):
                        n = min(step, rows - s)
                        buf[0, roff + s:roff + s + n].copy_(
                            rows_of(src, s, n).to(dtype))
                out[_wkey(w)] = buf
            return out

        if not use_lock:
            return build()
        import fcntl

        with open(self._uid_lock_path(), "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                return build()
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)

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

    def _plan_meta(self, plan, gi: int, device):
        """Device arrays of one group's per-slot plan rows, cached per
        plan: ``rows``/``roff`` (int64), the divisor (``hot`` on mean
        slots of a multi-hot group, else 1) and the zero-read mask
        (``None`` unless ``masked_reads``)."""
        key = (id(plan), gi, str(device))
        meta = self._meta_cache.get(key)
        if meta is None:
            g = plan.groups[gi]
            mean = plan.mean[gi][0] > 0
            div = np.where(mean & (g.hot > 1), float(g.hot), 1.0)
            mask = (torch.ones(g.n, dtype=torch.int32, device=device)
                    if self.masked_reads else None)
            meta = (torch.as_tensor(plan.rows[gi][0], dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(plan.roff[gi][0], dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(div, dtype=torch.float32, device=device),
                    mask)
            self._meta_cache[key] = meta
        return meta

    def _plan_ragged_meta(self, plan, gi: int, device):
        """A ragged group's per-slot flags, cached per plan: ``mean``
        (int32, ``None`` when no slot is a mean slot; a ragged row's
        divisor is its own length, not the group's capacity) and
        ``valid`` (int32, ``None`` when every slot is live)."""
        key = ("ragged", id(plan), gi, str(device))
        meta = self._meta_cache.get(key)
        if meta is None:
            mean, valid = plan.mean[gi][0] > 0, plan.valid[gi][0] > 0
            meta = (torch.as_tensor(mean, dtype=torch.int32, device=device)
                    if mean.any() else None,
                    None if valid.all() else
                    torch.as_tensor(valid, dtype=torch.int32, device=device))
            self._meta_cache[key] = meta
        return meta

    def _plan_bwd_meta(self, plan, gi: int, device):
        """The backward's per-slot masks of one group, cached per plan:
        ``valid`` (bool, ``None`` when every slot is live) and ``mean``
        (bool, ``None`` when no slot is a mean slot)."""
        key = ("bwd", id(plan), gi, str(device))
        meta = self._meta_cache.get(key)
        if meta is None:
            valid, mean = plan.valid[gi][0] > 0, plan.mean[gi][0] > 0
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
                               streaming=None):
        """Forward pass that also returns the routing residuals
        ``("dist", ids_block, encs, b)`` the sparse backward will read.

        ``streaming`` (streaming vocabularies, :mod:`.streaming`):
        ``(config, state)`` (the local state, without its world axis)
        remaps every streaming-table slot's external ids through the slot
        map right after the id block is built (hits read their slot,
        everything else its shared bucket) and stages this step's
        admissions; the return grows a third element, the per-width
        ``pending`` dict the trainer hands to :func:`.streaming.commit`.
        ``(config, state, False)`` is the read-only form (eval, serving):
        remap only, a 2-tuple return. The residuals carry the REMAPPED
        block, so the backward and telemetry see in-range slab rows."""
        device = next(iter(params.values())).device
        local = {k: v[0] for k, v in params.items()}
        entries, encs, shapes, comm_dtype = self._normalize_inputs(
            inputs, device)
        b = (entries[0][2].shape[0] if isinstance(entries[0], tuple)
             else entries[0].shape[0])
        plan = self._get_plan(encs, b)
        ids_recv = exchange_mod.build_send_blocks(self, plan, entries,
                                                  comm_dtype, device)
        pending = None
        if streaming is not None:
            ids_recv, pending = self._streaming_remap(plan, ids_recv,
                                                      streaming)
        reds = lookup_mod.plan_lookup_groups(self, plan, local, ids_recv)
        outs = []
        for inst in plan.instances:  # worker order == input order here
            g = plan.groups[inst.group]
            red = reds[inst.group]  # [1, n, b, w]
            if inst.num_slots == 1:
                o = red[0, inst.slot0]
            else:
                o = red[0, inst.slot0:inst.slot0 + inst.num_slots
                        ].transpose(0, 1).reshape(b, -1)
            shape = shapes[inst.input_id]
            if shape is not None and len(shape) >= 2:
                comb = self.strategy.global_configs[
                    self.strategy.input_table_map[inst.input_id]
                ].get("combiner")
                lead = shape[1:] if comb is None else shape[1:-1]
                if comb is None or lead:
                    o = o.reshape((b,) + tuple(lead) + (g.width,))
            outs.append(o)
        result = [outs[i] for i in self.strategy.rev_global_input_ids]
        res = ("dist", ids_recv, tuple(encs), b)
        return (result, res) if pending is None else (result, res, pending)

    # --------------------------------------------------------- streaming vocab

    def _streaming_plan_arrays(self, plan, gi: int, device):
        """One group's streaming plan arrays (JAX's per-slot
        ``_streaming_plan_arrays``, expanded to positions), cached per
        plan: ``None`` when the group has no streaming slot, else
        ``(slots, cap, nbuckets, tid, roff)``: the
        slot indices (int64 ``[k]``), then per position of those slots
        (slot-major, as the region holds them: ``b * hot`` ids a dense
        slot, ``hot`` values a ragged one) its table's capacity, bucket
        count, table id (the hash salt) and slab row offset (int32)."""
        key = ("streaming", id(plan), gi, str(device))
        if key in self._meta_cache:
            return self._meta_cache[key]
        g = plan.groups[gi]
        per_slot = {}
        for inst in plan.instances:
            tid = self.strategy.input_table_map[inst.input_id]
            info = self.streaming_tables.get(tid)
            if inst.group != gi or inst.rank != 0 or info is None:
                continue
            for k in range(inst.slot0, inst.slot0 + inst.num_slots):
                per_slot[k] = (info[0], info[1], tid,
                               int(plan.roff[gi][0][k]))
        meta = None
        if per_slot:
            slots = sorted(per_slot)
            per = plan.b * g.hot if g.kind == "d" else g.hot
            cols = np.repeat(np.asarray([per_slot[k] for k in slots],
                                        np.int32), per, axis=0)
            meta = (torch.as_tensor(slots, dtype=torch.int64, device=device),
                    *(torch.as_tensor(np.ascontiguousarray(cols[:, j]),
                                      device=device) for j in range(4)))
        self._meta_cache[key] = meta
        return meta

    def _streaming_remap(self, plan, ids_recv, streaming):
        """Remap every streaming-table slot's external ids in the id block
        through the slot map (:func:`.streaming.remap_width`, one call
        per width over the streaming slots of all its groups in plan
        order) and, in update mode, stage the admissions. Only live
        streaming positions are rewritten (``ids >= 0``; a ragged slot's
        positions below ``min(total length, capacity)``): other slots,
        dead positions, negative ids, lengths and weights stay as they
        are. Returns ``(ids_recv, pending)``: ``{width: (staged_cms,
        remap)}`` in update mode, else ``None``."""
        from . import streaming as smod

        if not self.streaming_tables:
            raise ValueError(
                "streaming= passed but no table declares a 'streaming' "
                "config entry")
        if len(streaming) == 2:
            (config, sstate), update = streaming, True
        else:
            config, sstate, update = streaming
        if update not in (True, False):
            raise NotImplementedError(
                f"streaming form {update!r}: the pipelined step's 'serve' "
                "form is not ported yet: ROADMAP A7")
        dev, b = ids_recv.device, plan.b
        per_width: Dict[int, list] = {}
        sites = []
        for gi, g in enumerate(plan.groups):
            meta = self._streaming_plan_arrays(plan, gi, dev)
            if meta is None:
                continue
            slots, *per_pos = meta
            region = ids_recv[0, g.goff:g.goff + g.n * g.blen].view(
                g.n, g.blen)
            sel = region.index_select(0, slots)
            if g.kind == "d":
                vals = sel
                live = torch.ones_like(vals, dtype=torch.bool)
            else:  # values, then the lengths (and the weight bits)
                vals = sel[:, :g.hot]
                tot = sel[:, g.hot:g.hot + b].sum(dim=1, dtype=torch.int32)
                live = (torch.arange(g.hot, dtype=torch.int32, device=dev)
                        [None] < tot.clamp(max=g.hot)[:, None])
            acc = per_width.setdefault(g.width, [])
            start = sum(p[0].numel() for p in acc)
            acc.append((vals.reshape(-1), live.reshape(-1), *per_pos))
            sites.append((g, region, slots, start, vals, live))
        remapped, pending = {}, {}
        for w, pieces in sorted(per_width.items()):
            stream = smod.WidthStream(*(
                torch.cat([p[j] for p in pieces]) if len(pieces) > 1
                else pieces[0][j] for j in range(6)))
            remapped[w], pend = smod.remap_width(
                sstate[_wkey(w)], stream, self.rows_cap[w], config,
                update=update)
            if pend is not None:
                pending[w] = pend
        for g, region, slots, start, vals, live in sites:
            new = remapped[g.width][start:start + vals.numel()].view(
                vals.shape)
            new = torch.where(live & (vals >= 0), new.to(vals.dtype), vals)
            region[slots, :vals.shape[1]] = new
        return ids_recv, (pending if update else None)

    # --------------------------------------------------------------- telemetry

    def telemetry_streams(self, residuals) -> Dict[int, tuple]:
        """Per width, ``(ids [n] int32, live [n] bool)``: the logical slab
        rows the forward routed and whether each is live, over every
        group of that width in plan order (``residuals``: the second
        output of :meth:`forward_with_residuals`, or a list of them, whose
        streams concatenate). A dense slot's id is live when it lies in
        its table and the slot is live; a ragged slot's position also
        when it lies within the slot's claimed values."""
        res_list = ([residuals] if residuals and residuals[0] == "dist"
                    else list(residuals))
        world = self.world_size
        per_width: Dict[int, tuple] = {}
        for res in res_list:
            _, ids_recv, encs, b = res
            plan = self._get_plan(list(encs), b)
            for gi, g in enumerate(plan.groups):
                if plan.rsliced[gi].any():
                    raise NotImplementedError(
                        "telemetry of row-sliced slots is not ported yet: "
                        "ROADMAP A9")
                dev = ids_recv.device
                rows, roff, _, _ = self._plan_meta(plan, gi, dev)
                valid, _ = self._plan_bwd_meta(plan, gi, dev)
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

        Widths fold in ascending order, and ``ids_total`` adds their
        float32 live counts in that order, as JAX does. Returns the state
        (the same tensors)."""
        total = None
        for w, (ids, live) in sorted(self.telemetry_streams(
                residuals).items()):
            _, count = tel._record(tstate[_wkey(w)], ids, live, config)
            total = count if total is None else total + count
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
