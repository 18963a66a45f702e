"""Batched strided copies of the exchange layer on the hand-written
kernels K19 (``pack_ids``: the id blocks) and K20 (``pack_columns``: the
float column blocks), both in ``csrc/exchange_pack.cu``, with their plain
PyTorch version.

Counterpart of the layout half of
``distributed_embeddings_tpu/parallel/exchange.py`` (``assemble_cells``
under ``build_send_blocks`` and ``pack_grad_blocks``), of the exchange
rows of ``parallel/lookup.py:plan_lookup`` and of the dp-side unpack in
``parallel/dist_embedding.py:forward_with_residuals``: each is a set of
2-D copies between a few tensors, which XLA lowered to concatenates,
transposes and slices.

A :class:`CopyPlan` lists the copies in ELEMENTS, by the index of the
source and of the destination tensor in the lists a call passes, so it
is built once per exchange plan and reused every step; a call only
supplies the tensors. A source index of ``-1`` zero-fills. A plan may
also hold SUMS (K20 only): a destination block that is the sum of
``k >= 2`` source blocks of its dtype, added in order and rounded to the
dtype after each add (the unpack of a row-sliced table's slices). On the
card
the wrapper turns each copy into a descriptor (addresses patched from the
tensors, the widest unit the alignment allows) and launches once per
:data:`MAX_DESCS` descriptors; on the CPU it runs :func:`batched_copy_plain`.

The launches go through the shared launch path (``_kernels.LaunchRecord``):
the first call with a set of tensors checks them and builds the
descriptor chunks, kept on the plan under a key of every fact they rest
on (per tensor its address, shape, strides, dtype and device); a later
call with the same key (the caching allocator hands a step's tensors the
same addresses step after step) only replays one ``ctypes`` call per
chunk.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import _kernels

#: the most descriptors one launch carries (``csrc/exchange_pack.cu``)
MAX_DESCS = 504
#: units a tile of the kernel covers (256 threads x 4)
TILE_UNITS = 1024

_ESIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4,
          torch.int64: 8}
_FLOATS = (torch.float32, torch.bfloat16)

# CopyPlan columns
SRC, SRC_OFF, SRC_STRIDE, DST, DST_OFF, DST_STRIDE, ROWS, COLS = range(8)


class CopyPlan:
    """A fixed list of 2-D copies: per copy ``(src, src_off, src_stride,
    dst, dst_off, dst_stride, rows, cols)``, all in elements; ``src`` and
    ``dst`` index the tensor lists of a call (``src == -1``: zero-fill).
    Copies without elements are dropped.

    ``sums`` (optional): per sum ``(dst, dst_off, dst_stride, rows, cols,
    parts)``, ``parts`` a list of ``k >= 2`` ``(src, src_off,
    src_stride)`` (one row stride for all): the destination block is
    ``part 0 + part 1 + ...``, added left to right in the destination's
    dtype, which must be the sources'.

    ``src_width`` (optional, per source index; 0 for none) declares a
    source read by logical rows of that width: it may then arrive as any
    2-D ``[rows, width]`` tensor whose columns are contiguous (a column
    slice of a wider one, as an autograd cotangent often is), its offsets
    and strides mapped through its row stride at each call. Its copies
    must stay inside one logical row and step whole rows."""

    def __init__(self, copies: Sequence[Sequence[int]],
                 src_width: Sequence[int] = (), sums: Sequence = ()):
        a = np.asarray(list(copies), dtype=np.int64).reshape(-1, 8)
        self.a = a[(a[:, ROWS] > 0) & (a[:, COLS] > 0)]
        a = self.a
        #: per sum, its parts as copies ``[k, 8]`` (one destination)
        self.sums = []
        for dst, doff, dstride, rows, cols, parts in sums:
            if len(parts) < 2:
                raise ValueError("a sum needs at least two parts")
            if len({p[2] for p in parts}) != 1:
                raise ValueError("a sum's parts must share a row stride")
            if rows > 0 and cols > 0:
                self.sums.append(np.asarray(
                    [(p[0], p[1], p[2], dst, doff, dstride, rows, cols)
                     for p in parts], np.int64))
        every = np.concatenate([a] + self.sums) if self.sums else a
        read = every[:, SRC] >= 0
        if self.sums and (np.concatenate(self.sums)[:, SRC] < 0).any():
            raise ValueError("a sum's parts must read sources")
        #: the source indices read, and per index the elements it must hold
        self.used_src = sorted(set(every[read, SRC].tolist()))
        self.n_src = self.used_src[-1] + 1 if self.used_src else 0
        self.n_dst = int(every[:, DST].max()) + 1 if len(every) else 0
        s_last = (every[:, ROWS] - 1) * every[:, SRC_STRIDE] \
            + every[:, SRC_OFF] + every[:, COLS]
        d_last = (every[:, ROWS] - 1) * every[:, DST_STRIDE] \
            + every[:, DST_OFF] + every[:, COLS]
        src_need = np.zeros(self.n_src, np.int64)
        np.maximum.at(src_need, every[read, SRC], s_last[read])
        dst_need = np.zeros(self.n_dst, np.int64)
        np.maximum.at(dst_need, every[:, DST], d_last)
        self.src_need, self.dst_need = src_need.tolist(), dst_need.tolist()
        width = np.zeros(max(self.n_src, len(src_width)), np.int64)
        width[:len(src_width)] = src_width
        #: the sources read by logical rows, and per copy of theirs
        #: (offset // width, offset % width, stride // width)
        self.row_src = [i for i in self.used_src if width[i]]
        self.src_width = width.tolist()
        w = np.where(a[:, SRC] >= 0, width[np.maximum(a[:, SRC], 0)], 0)
        self.rowwise = w > 0
        wr = np.where(self.rowwise, w, 1)
        self.q_off, self.r_off = a[:, SRC_OFF] // wr, a[:, SRC_OFF] % wr
        self.q_stride = a[:, SRC_STRIDE] // wr
        if ((self.r_off + a[:, COLS] > wr) | (a[:, SRC_STRIDE] % wr != 0)
                )[self.rowwise].any():
            raise ValueError("a copy of a row-wise source crosses a row")
        if any(width[p[:, SRC]].any() for p in self.sums):
            raise ValueError("a sum cannot read a row-wise source")
        #: the card's launch records by tensor facts (:func:`find_record`)
        self.launch_cache = _kernels.LaunchCache()

    def __len__(self) -> int:
        return len(self.a) + len(self.sums)


def _check_tensors(plan: CopyPlan, srcs, dsts, what: str):
    """The common dtype of the sources and of the destinations (``None``
    when no copy reads a source), after checking counts, contiguity and
    extents."""
    if len(srcs) < plan.n_src or len(dsts) < plan.n_dst:
        raise ValueError(f"{what}: the plan reads {plan.n_src} sources and "
                         f"writes {plan.n_dst} destinations, got "
                         f"{len(srcs)} and {len(dsts)}")
    used = [srcs[i] for i in plan.used_src]
    for kind, idx, ts, need in (("source", plan.used_src, used,
                                 plan.src_need),
                                ("destination", range(len(dsts)), dsts,
                                 plan.dst_need)):
        for i, t in zip(idx, ts):
            w = plan.src_width[i] if kind == "source" else 0
            if w:  # rows of width w, columns contiguous
                ok = t.dim() == 2 and t.shape[1] == w and (
                    t.stride(1) == 1 or w == 1) and t.stride(0) >= w
                n = t.shape[0] * w if t.dim() == 2 else 0
            else:
                ok, n = t.is_contiguous(), t.numel()
            if not ok:
                raise ValueError(f"{what}: {kind} {i} must be "
                                 + (f"[rows, {w}] with contiguous columns"
                                    if w else "contiguous"))
            if i < len(need) and n < need[i]:
                raise ValueError(f"{what}: {kind} {i} holds {n} "
                                 f"elements, the plan needs {need[i]}")
    sdt = {t.dtype for t in used}
    ddt = {t.dtype for t in dsts}
    if len(sdt) > 1 or len(ddt) != 1:
        raise ValueError(f"{what}: sources must share one dtype and "
                         f"destinations another, got {sdt} and {ddt}")
    return next(iter(sdt), None), next(iter(ddt))


def _src_geometry(plan: CopyPlan, srcs):
    """Per copy, ``(offset, row stride)`` in elements of its source's
    storage from the source's first element: the planned ones, with a
    row-wise source's mapped through its row stride."""
    off, stride = plan.a[:, SRC_OFF], plan.a[:, SRC_STRIDE]
    if not plan.row_src:
        return off, stride
    rs = np.zeros(len(plan.src_width), np.int64)
    rs[plan.row_src] = [srcs[i].stride(0) for i in plan.row_src]
    s = rs[np.maximum(plan.a[:, SRC], 0)]
    return (np.where(plan.rowwise, plan.q_off * s + plan.r_off, off),
            np.where(plan.rowwise, plan.q_stride * s, stride))


def batched_copy_plain(plan: CopyPlan, srcs: Sequence[torch.Tensor],
                       dsts: Sequence[torch.Tensor]) -> None:
    """Plain PyTorch version of :func:`pack_ids` / :func:`pack_columns`:
    each copy through ``as_strided`` views (``copy_`` casts a float32
    source to bfloat16 with round to nearest even, as the kernel does)."""
    soff, sstride = _src_geometry(plan, srcs)
    a = plan.a.copy()
    a[:, SRC_OFF], a[:, SRC_STRIDE] = soff, sstride
    for (si, so, ss, di, do, ds, rows, cols) in a.tolist():
        d = dsts[di]
        view = d.as_strided((rows, cols), (ds, 1), d.storage_offset() + do)
        if si < 0:
            view.zero_()
        else:
            s = srcs[si]
            view.copy_(s.as_strided((rows, cols), (ss, 1),
                                    s.storage_offset() + so))
    for parts in plan.sums:
        _, _, _, di, do, ds, rows, cols = parts[0].tolist()
        d = dsts[di]
        total = None
        for si, so, ss in parts[:, :3].tolist():
            s = srcs[si]
            x = s.as_strided((rows, cols), (ss, 1), s.storage_offset() + so)
            total = x if total is None else total + x
        d.as_strided((rows, cols), (ds, 1), d.storage_offset() + do).copy_(
            total)


def _lowbit(x: np.ndarray) -> np.ndarray:
    return x & -x


def _raw_mode(unit_bytes: np.ndarray) -> np.ndarray:
    """Kernel mode of a raw unit: 2, 4, 8, 16 bytes -> 0, 1, 2, 3."""
    return np.log2(unit_bytes).astype(np.int64) - 1


def descriptors(plan: CopyPlan, srcs, dsts, src_dtype, dst_dtype
                ) -> np.ndarray:
    """The kernel's descriptors ``int64 [n, 8]`` (src address, dst
    address, src stride, dst stride, rows, cols, tile0 = 0, mode) for one
    call: addresses from the tensors, everything in the widest unit that
    every address, stride and row length of the copy allows."""
    a = plan.a
    n = len(a)
    zero = a[:, SRC] < 0
    soff, sstride = _src_geometry(plan, srcs)
    sbase = np.asarray([t.data_ptr() for t in srcs] or [0], np.int64)
    dbase = np.asarray([t.data_ptr() for t in dsts], np.int64)
    de = _ESIZE[dst_dtype]
    se = _ESIZE[src_dtype] if src_dtype is not None else de
    saddr = np.where(zero, 0, sbase[np.maximum(a[:, SRC], 0)]
                     + soff * se)
    daddr = dbase[a[:, DST]] + a[:, DST_OFF] * de
    out = np.zeros((n, 8), np.int64)
    if src_dtype is None or src_dtype == dst_dtype:
        # raw units of 2..16 bytes
        g = (daddr | (a[:, DST_STRIDE] * de) | (a[:, COLS] * de)
             | np.where(zero, 0, saddr | (sstride * se)))
        unit = np.minimum(_lowbit(g), 16)
        if (unit < de).any():
            raise ValueError("exchange copy: a tensor is not aligned to its "
                             "element size")
        per = unit // de  # elements a unit
        mode = _raw_mode(unit)
    else:
        # casts: units of 1, 2 or 4 elements
        if {src_dtype, dst_dtype} != set(_FLOATS):
            raise ValueError(f"exchange copy: no cast from {src_dtype} to "
                             f"{dst_dtype}")
        g = ((daddr // de) | a[:, DST_STRIDE] | a[:, COLS]
             | np.where(zero, 0, (saddr // se) | sstride))
        per = np.minimum(_lowbit(g), 4)
        base = 4 if src_dtype == torch.float32 else 7
        mode = base + np.log2(per).astype(np.int64)
        # a zero-filled copy has no source: raw units of the destination
        zbytes = np.minimum(_lowbit(daddr | (a[:, DST_STRIDE] * de)
                                    | (a[:, COLS] * de)), 16)
        per = np.where(zero, zbytes // de, per)
        mode = np.where(zero, _raw_mode(zbytes), mode)
    out[:, 0] = saddr
    out[:, 1] = daddr
    out[:, 2] = sstride // per
    out[:, 3] = a[:, DST_STRIDE] // per
    out[:, 4] = a[:, ROWS]
    out[:, 5] = a[:, COLS] // per
    out[:, 7] = mode
    return out


#: the first summing mode: float32 (10-12) and bfloat16 (13-15) sums in
#: units of 1, 2, 4 elements, the part count from bit 8
SUM_MODE = 10


def sum_descriptors(plan: CopyPlan, srcs, dsts, dtype):
    """``(descriptors int64 [m, 8], addresses [m] of int64 [k])`` of the
    plan's sums for one call: per sum its destination, the parts' row
    stride, rows and columns in its unit (1, 2 or 4 elements, the widest
    every address, stride and row length allows), and its mode (``10 +
    3 * (dtype is bfloat16) + log2(unit) + (k << 8)``; column 0, the
    index of its first address, is set per launch); and its parts'
    addresses."""
    if dtype not in _FLOATS:
        raise ValueError(f"exchange sum: {dtype} is not a float dtype")
    es = _ESIZE[dtype]
    out = np.zeros((len(plan.sums), 8), np.int64)
    addrs = []
    for i, parts in enumerate(plan.sums):
        _, _, ss, di, do, ds, rows, cols = parts[0].tolist()
        daddr = dsts[di].data_ptr() + do * es
        sa = [srcs[si].data_ptr() + so * es
              for si, so in parts[:, :2].tolist()]
        g = (daddr // es) | ds | cols | ss
        for x in sa:
            g |= x // es
        per = min(int(_lowbit(np.int64(g))), 4)
        if any(x % es for x in sa + [daddr]):
            raise ValueError("exchange sum: a tensor is not aligned to its "
                             "element size")
        out[i, 1:6] = (daddr, ss // per, ds // per, rows, cols // per)
        out[i, 7] = (SUM_MODE + 3 * (dtype == torch.bfloat16)
                     + int(np.log2(per)) + (len(sa) << 8))
        addrs.append(np.asarray(sa, np.int64))
    return out, addrs


def launch_chunks(plan: CopyPlan, srcs, dsts, src_dtype, dst_dtype,
                  what: str):
    """``[(array int64 [n + n_rows, 8], tiles, n, n_rows)]`` of one call:
    :func:`descriptors`, then :func:`sum_descriptors`, split into
    launches of at most :data:`MAX_DESCS` rows, each launch's
    descriptors followed by its sums' address rows (8 addresses a row;
    column 0 of a sum its first address's index there), each
    descriptor's first tile (column 6) counted from its launch's start."""
    desc = descriptors(plan, srcs, dsts, src_dtype, dst_dtype)
    addrs = [None] * len(desc)
    if plan.sums:
        sdesc, saddrs = sum_descriptors(plan, srcs, dsts, dst_dtype)
        desc = np.concatenate([desc, sdesc])
        addrs += saddrs
    tiles = -(-(desc[:, 4] * desc[:, 5]) // TILE_UNITS)
    groups, cur, n_addr = [], [], 0
    for i in range(len(desc)):
        k = 0 if addrs[i] is None else len(addrs[i])
        if cur and len(cur) + 1 + -(-(n_addr + k) // 8) > MAX_DESCS:
            groups.append(cur)
            cur, n_addr = [], 0
        cur.append(i)
        n_addr += k
    if cur:
        groups.append(cur)
    chunks = []
    for idx in groups:
        d = desc[idx].copy()
        t = tiles[idx]
        d[:, 6] = np.cumsum(t) - t
        flat = []
        for j, i in enumerate(idx):
            if addrs[i] is not None:
                d[j, 0] = len(flat)
                flat.extend(addrs[i].tolist())
        n_rows = -(-len(flat) // 8)
        rows = np.zeros((n_rows, 8), np.int64)
        rows.reshape(-1)[:len(flat)] = flat
        n_tiles = int(t.sum())
        if n_tiles >= 2 ** 31:
            raise ValueError(f"{what}: {n_tiles} tiles in one launch")
        chunks.append((np.ascontiguousarray(np.concatenate([d, rows])),
                       n_tiles, len(idx), n_rows))
    return chunks


def _library():
    """The loaded ``exchange_pack`` library, its launch geometry checked
    against this module's once."""
    lib = _kernels.library("exchange_pack")
    if not getattr(lib, "geometry_checked", False):
        if (lib.detpu_pack_max_descs(), lib.detpu_pack_tile_units()) != (
                MAX_DESCS, TILE_UNITS):
            raise RuntimeError("csrc/exchange_pack.cu and "
                               "ops/exchange_pack.py disagree on the launch "
                               "geometry")
        lib.geometry_checked = True
    return lib


#: per wrapper: the C function, the dtypes it takes
_WRAPPERS = {"pack_ids": ("detpu_pack_ids", (torch.int32, torch.int64)),
             "pack_columns": ("detpu_pack_cols", _FLOATS)}


def _validate(plan: CopyPlan, what: str, srcs, dsts):
    """Every check of a call (raising as the wrappers always have): the
    common dtypes of the sources and the destinations."""
    if not dsts:
        raise ValueError(f"{what}: no destination")
    if what == "pack_ids":
        if plan.n_dst > 1:
            raise ValueError("pack_ids writes one destination")
        if plan.sums:
            raise ValueError("pack_ids copies; only pack_columns sums")
        out = dsts[0]
        sdt = {srcs[i].dtype for i in plan.used_src if i < len(srcs)}
        if sdt - {out.dtype}:
            raise ValueError(f"pack_ids: sources {sdt} must have the "
                             f"block's dtype {out.dtype}")
    sdt, ddt = _check_tensors(plan, srcs, dsts, what)
    for dt in (sdt, ddt):
        if dt is not None and dt not in _WRAPPERS[what][1]:
            raise ValueError(f"{what}: dtype {dt} is not one of "
                             f"{_WRAPPERS[what][1]}")
    if plan.sums and sdt != ddt:
        raise ValueError(f"{what}: a sum's parts must have the output's "
                         f"dtype, got {sdt} and {ddt}")
    return sdt, ddt


def build_record(plan: CopyPlan, what: str, srcs, dsts
                 ) -> _kernels.LaunchRecord:
    """Validate a call of ``what`` (``"pack_ids"`` or ``"pack_columns"``)
    and build its launch record: the descriptor chunks
    (``record.payload``, :func:`launch_chunks`) and, for CUDA tensors,
    one bound ``ctypes`` call per chunk. CPU tensors (the tests) get a
    record without launches."""
    sdt, ddt = _validate(plan, what, srcs, dsts)
    dev = dsts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in srcs):
        raise ValueError(f"{what}: every tensor must be on {dev}")
    chunks = (launch_chunks(plan, srcs, dsts, sdt, ddt, what) if len(plan)
              else [])
    lib, calls = None, []
    if dev.type == "cuda":
        lib = _library()
        fn = getattr(lib, _WRAPPERS[what][0])
        calls = [(fn, (chunk.ctypes.data, n, n_rows, n_tiles)
                  if what == "pack_columns"
                  else (chunk.ctypes.data, n, n_tiles))
                 for chunk, n_tiles, n, n_rows in chunks]
    return _kernels.LaunchRecord(
        lib, what, calls, (dev.index or 0) if dev.type == "cuda" else -1,
        payload=[c[:2] for c in chunks])


def record_key(what: str, srcs: Sequence[torch.Tensor],
               dsts: Sequence[torch.Tensor]) -> tuple:
    """Every fact a launch record of ``what`` rests on: the number of
    sources and, per source and destination, its address, shape,
    strides, dtype and device."""
    ts = [*srcs, *dsts]
    return (what, len(ts) - len(dsts), *_kernels.tensor_key(ts))


def find_record(plan: CopyPlan, what: str, srcs: Sequence[torch.Tensor],
                dsts: Sequence[torch.Tensor], build_on_cpu: bool = False):
    """The launch record of a call, found on the plan by
    :func:`record_key` or built (:func:`build_record`) and kept. A miss on CPU
    tensors is validated and gives ``None`` (the wrapper runs the plain
    version) unless ``build_on_cpu``."""
    key = record_key(what, srcs, dsts)
    rec = plan.launch_cache.get(key)
    if rec is not None:
        return rec
    srcs, dsts = list(srcs), list(dsts)
    if dsts and dsts[0].device.type == "cpu" and not build_on_cpu:
        _validate(plan, what, srcs, dsts)
        return None
    return plan.launch_cache.add(key, build_record(plan, what, srcs, dsts))


def pack_ids(plan: CopyPlan, srcs: Sequence[torch.Tensor],
             out: torch.Tensor) -> torch.Tensor:
    """K19: run ``plan``'s copies from the id tensors ``srcs`` (int32 or
    int64, one dtype, contiguous) into ``out`` (the same dtype,
    contiguous; destination 0). A CPU ``out`` runs
    :func:`batched_copy_plain`; a CUDA ``out`` launches the kernel or
    raises. Returns ``out``."""
    rec = find_record(plan, "pack_ids", srcs, (out,))
    if rec is None:
        batched_copy_plain(plan, list(srcs), [out])
    else:
        pack_ids.launches += rec.replay()
    return out


pack_ids.launches = 0


def pack_columns(plan: CopyPlan, srcs: Sequence[torch.Tensor],
                 dsts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """K20: run ``plan``'s copies from the float tensors ``srcs`` (one
    dtype, contiguous) into ``dsts`` (one dtype, contiguous), casting
    float32 <-> bfloat16 where the two differ. CPU tensors run
    :func:`batched_copy_plain`; CUDA tensors launch the kernel or raise.
    Returns ``dsts``."""
    dsts = list(dsts)
    rec = find_record(plan, "pack_columns", srcs, dsts)
    if rec is None:
        batched_copy_plain(plan, list(srcs), dsts)
    else:
        n = rec.replay()
        pack_columns.launches += n
        if plan.sums:
            pack_columns.launches_sum += n
    return dsts


pack_columns.launches = 0
#: the launches of plans with sums (row slices), also in ``launches``
pack_columns.launches_sum = 0


def pack_ids_plain(plan: CopyPlan, srcs: Sequence[torch.Tensor],
                   out: torch.Tensor) -> torch.Tensor:
    """:func:`pack_ids` through :func:`batched_copy_plain` on any device
    (the reference run of the card checks). Returns ``out``."""
    batched_copy_plain(plan, list(srcs), [out])
    return out


def pack_columns_plain(plan: CopyPlan, srcs: Sequence[torch.Tensor],
                       dsts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`pack_columns` through :func:`batched_copy_plain` on any
    device. Returns ``dsts``."""
    dsts = list(dsts)
    batched_copy_plain(plan, list(srcs), dsts)
    return dsts


__all__ = ["CopyPlan", "MAX_DESCS", "batched_copy_plain", "descriptors",
           "launch_chunks", "pack_columns", "pack_columns_plain", "pack_ids",
           "pack_ids_plain", "sum_descriptors"]
