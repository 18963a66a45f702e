"""Builds and loads the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper
(``sm_90a``) into its own shared library under ``build/kernels/`` beside
the package, and loaded with ``ctypes``. The sources export plain C
functions: every pointer and the stream pass as ``c_void_p``, sizes as
``c_int64``/``c_int``, and each function returns the ``cudaError_t`` of
its launch, which the wrapper turns into an exception.

The build runs at first use (or up front through :func:`build_all`),
one ``nvcc`` per source, all started together. A library is named by a
hash of its source, of every local header the source includes
(``#include "x.cuh"``, followed recursively) and of the flags, so an
edited source or header never loads a stale build. Nothing here runs at
import time, and nothing falls back: a failed build or launch raises.

The shared launch path (:class:`LaunchRecord`, :class:`LaunchCache`,
:func:`tensor_key`): a wrapper validates its tensors and builds its
launches' arguments once, keeps them as a record under a key that holds
every fact the checks and the arguments rest on (per tensor its address,
shape, strides or contiguity, dtype and device), and on a later call
with the same key only reads the per-call pointers and the stream and
replays the bound C functions: no check, no allocation beyond the
call's own output, no host read of a device value, nothing copied from
pageable memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of each exported function, per source stem
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "gather_combine": {
        # slab, slab_rows, width, ids_is_64, rows, roff, div, mask,
        # weighted, n_slots, b, hot, dtype, vb, prepared (host, out)
        "detpu_gather_combine_prepare": (_P, _I64, _I, _I, _P, _P, _P, _P,
                                         _I, _I, _I64, _I, _I, _I, _P),
        # prepared, ids, weights, out, stream
        "detpu_gather_combine_launch": (_P, _P, _P, _P, _P),
        # -> the bytes of a prepared launch
        "detpu_gather_combine_prepared_bytes": (),
    },
    "dot_interact": {
        # ptrs, strides (host int64), n_table, fstride, batch,
        # num_features, dim, dtype, out_fs, out_rs, dy_aligned, prepared
        # (host, out)
        "detpu_dot_interact_prepare": (_P, _P, _I, _I64, _I64, _I, _I, _I,
                                       _I64, _I64, _I, _P),
        # prepared, out, stream
        "detpu_dot_interact_fwd_launch": (_P, _P, _P),
        # prepared, dy, dfeats, stream
        "detpu_dot_interact_bwd_launch": (_P, _P, _P, _P),
        # -> the bytes of a prepared launch
        "detpu_dot_interact_prepared_bytes": (),
        # prepared -> bit 0: K2, bit 1: K4 on the tensor cores
        "detpu_dot_interact_paths": (_P,),
    },
    "sgd_scatter": {
        # rows, width, slab_dtype, ids_is_64, n, vals_dtype, neg_lr,
        # lr_on_card, cast_vals, scratch, prepared (host, out)
        "detpu_sgd_scatter_prepare": (_I64, _I, _I, _I, _I64, _I, _F, _I,
                                      _I, _P, _P),
        # prepared, slab, ids, vals, lr, stream
        "detpu_sgd_scatter_launch": (_P, _P, _P, _P, _P, _P),
        # n, width -> bytes of card scratch
        "detpu_sgd_scatter_scratch_bytes": (_I64, _I),
        # -> the bytes of a prepared launch / K3's chunk L / a sort tile
        "detpu_segment_prepared_bytes": (),
        "detpu_segment_split": (),
        "detpu_segment_sort_tile": (),
    },
    "sgd_promoted": {
        # rows, width, ids_is_64, n, vals_dtype, scratch, prepared (out)
        "detpu_sgd_promoted_prepare": (_I64, _I, _I, _I64, _I, _P, _P),
        # prepared, slab, ids, vals, lr, stream
        "detpu_sgd_promoted_launch": (_P, _P, _P, _P, _P, _P),
        # n, width -> bytes of card scratch
        "detpu_sgd_promoted_scratch_bytes": (_I64, _I),
        # -> the bytes of a prepared launch / the block path's length
        "detpu_segment_prepared_bytes": (),
        "detpu_segment_long": (),
    },
    "dedup": {
        # n, width, ids_is_64, vals_dtype, pad_id, u_cap, scratch, prepared
        # (host, out)
        "detpu_dedup_prepare": (_I64, _I, _I, _I, _I64, _I64, _P, _P),
        # prepared, ids, vals, valid, uids, ugrads, stream
        "detpu_dedup_launch": (_P, _P, _P, _P, _P, _P, _P),
        # n, width, ids_is_64 -> bytes of card scratch
        "detpu_dedup_scratch_bytes": (_I64, _I, _I),
        # -> the bytes of a prepared launch
        "detpu_dedup_prepared_bytes": (),
    },
    "adagrad": {
        # slab, slab_dtype, acc, acc_dtype, rows, width, uids, ids_is_64, u,
        # ugrads, lr, lr_dev, eps, stream
        "detpu_adagrad_rows": (_P, _I, _P, _I, _I64, _I, _P, _I, _I64, _P,
                               ctypes.c_float, _P, ctypes.c_float, _P),
        # slab, slab_dtype, acc, acc_dtype, grad, numel, lr, lr_dev, eps,
        # stream
        "detpu_adagrad_dense": (_P, _I, _P, _I, _P, _I64, ctypes.c_float,
                                _P, ctypes.c_float, _P),
    },
    "adam": {
        # slab, slab_dtype, mu, nu, mom_dtype, rows, width, uids, ids_is_64,
        # u, ugrads, b1, omb1, b2, omb2, bp, lr, lr_dev, eps, eps_root, vec,
        # stream
        "detpu_adam_rows": (_P, _I, _P, _P, _I, _I64, _I, _P, _I, _I64, _P,
                            _F, _F, _F, _F, _P, _F, _P, _F, _F, _I, _P),
    },
    "momentum": {
        # slab, slab_dtype, trace, tr_dtype, rows, width, uids, ids_is_64,
        # u, ugrads, m, nesterov, neg_lr, lr_dev, vec, stream
        "detpu_momentum_rows": (_P, _I, _P, _I, _I64, _I, _P, _I, _I64, _P,
                                _F, _I, _F, _P, _I, _P),
    },
    "csr": {
        # len_is_64, slot_stride, n_slots, b, valid, scratch, prepared
        "detpu_lengths_to_splits_prepare": (_I, _I64, _I, _I64, _P, _P,
                                            _P),
        # n_slots, b -> bytes of card scratch
        "detpu_lengths_to_splits_scratch_bytes": (_I, _I64),
        # rows_is_64, stride, nnz, dim0, out_is_64, prepared
        "detpu_row_to_split_prepare": (_I, _I64, _I64, _I64, _I, _P),
        # is_64, n_slots, nrows, cap, prepared
        "detpu_ragged_row_ids_prepare": (_I, _I, _I64, _I64, _P),
        # prepared, src, dst, stream
        "detpu_csr_launch": (_P, _P, _P, _P),
        # -> the bytes of a prepared launch / the lengths a scan tile
        # covers
        "detpu_csr_prepared_bytes": (),
        "detpu_csr_scan_tile": (),
    },
    "ragged_combine": {
        # slab, slab_rows, width, dtype, ids_is_64, v_stride, rows, roff,
        # mean, mask, w_esize, w_stride, out_dtype, n_slots, b, cap,
        # prepared (host, out)
        "detpu_ragged_combine_prepare": (_P, _I64, _I, _I, _I, _I64, _P, _P,
                                         _P, _P, _I, _I64, _I, _I, _I64,
                                         _I64, _P),
        # prepared, values, splits, weights, out, stream
        "detpu_ragged_combine_launch": (_P, _P, _P, _P, _P, _P),
        # -> the bytes of a prepared launch
        "detpu_ragged_combine_prepared_bytes": (),
    },
    "ragged_grad": {
        # g, g_slot_stride, g_row_stride, width, dtype, splits, values,
        # ids_in_64, v_stride, rows, roff, sentinel, ids_out, ids_out_64,
        # mean, reciprocal, weights, w_esize, w_stride, vals_out, n_slots,
        # b, cap, stream
        "detpu_ragged_grad": (_P, _I64, _I64, _I, _I, _P, _P, _I, _I64, _P,
                              _P, _I64, _P, _I, _P, _I, _P, _I, _I64, _P,
                              _I, _I64, _I64, _P),
    },
    "sketch": {
        # n -> blocks (and int64 count partials) of detpu_cms_update
        "detpu_cms_update_blocks": (_I64,),
        # cms, depth, buckets, ids, live, n, count_part, stream
        "detpu_cms_update": (_P, _I, _I, _P, _P, _I64, _P, _P),
        # cms, depth, buckets, ids, n, est, stream
        "detpu_cms_query": (_P, _I, _I, _P, _I64, _P, _P),
        # n, k_pool -> bytes; n -> the bytes of it each call clears
        "detpu_topk_pool_scratch_bytes": (_I64, _I),
        "detpu_topk_pool_clear_bytes": (_I64,),
        # -> the largest k_pool
        "detpu_topk_pool_max": (),
        # cms, depth, buckets, ids, live, n, k_pool, pool, scratch, stream
        "detpu_topk_pool": (_P, _I, _I, _P, _P, _I64, _I, _P, _P, _P),
        # -> the largest topk + candidates merged in shared memory
        "detpu_topk_merge_max": (),
        # topk, candidates -> bytes of device scratch (0 below the max)
        "detpu_topk_merge_scratch_bytes": (_I, _I),
        # cms, depth, buckets, pool, k_pool, candidates, topk_ids,
        # topk_est, topk, ids_acc, count_part, n_part, count_out, scratch,
        # stream
        "detpu_topk_merge": (_P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P,
                             _I, _P, _P, _P),
    },
    "exchange_pack": {
        # descs (host int64 [n, 8]), n, n_tiles, stream
        "detpu_pack_ids": (_P, _I, _I64, _P),
        "detpu_pack_cols": (_P, _I, _I64, _P),
        # -> the most descriptors a launch takes / the units a tile covers
        "detpu_pack_max_descs": (),
        "detpu_pack_tile_units": (),
    },
    "grad_health": {
        # descs (host int64 [n, 6]), n, chunks, partials, out, stream
        "detpu_grad_health": (_P, _I, _I64, _P, _P, _P),
        # -> the most tensors a call takes / the elements a chunk covers
        "detpu_grad_health_max_tensors": (),
        "detpu_grad_health_chunk": (),
    },
    "dense_update": {
        # descs (host int64 [n, 6]), n, tile, kind, nlr, nlr_on_card, m,
        # b1, omb1, b2, omb2, eps, eps_root, advance, prepared (host, out)
        "detpu_dense_update_prepare": (_P, _I, _I64, _I, _F, _I, _F, _F,
                                       _F, _F, _F, _F, _F, _I, _P),
        # prepared, nlr_dev, bp, ok, count_a, count_s, stream
        "detpu_dense_update_launch": (_P, _P, _P, _P, _P, _P, _P),
        # -> the most tensors a launch takes / the bytes of a prepared
        # launch
        "detpu_dense_update_max_tensors": (),
        "detpu_dense_update_prepared_bytes": (),
    },
    "streaming": {
        # ext, ext_is_64, live, cap, nb, tid, roff, slot_fp, n, local_rows,
        # key, live_out, flags, rowc, stream
        "detpu_stream_hash": (_P, _I, _P, _P, _P, _P, _P, _P, _I64, _P, _P,
                              _P, _P, _P, _P),
        # cms, depth, buckets, key, flags, rowc, slot_freq, admit, margin,
        # n, rows_cap, best_key, best_pos, est, scrub_rows, hit_rows,
        # counts, stream
        "detpu_stream_stage": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I64,
                               _I, _P, _P, _P, _P, _P, _P, _P),
        # slab, slab_dtype, width, rows_cap, leaf_ptrs, leaf_dtypes,
        # leaf_fills, n_leaves, scrub_rows, fp, est, hit_rows, n, slot_fp,
        # slot_freq, cms, staged, cms_numel, counts, totals, c_admitted,
        # c_evicted, c_bucket, c_hit, steps, finalize, enable, stream
        "detpu_stream_commit": (_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P,
                                _P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P,
                                _P, _P, _P, _P, _I, _P, _P),
    },
}

#: return type of the exported functions that return no ``cudaError_t``
RESTYPES = {"detpu_dedup_scratch_bytes": _I64,
            "detpu_dedup_prepared_bytes": _I64,
            "detpu_gather_combine_prepared_bytes": _I64,
            "detpu_dot_interact_prepared_bytes": _I64,
            "detpu_ragged_combine_prepared_bytes": _I64,
            "detpu_csr_prepared_bytes": _I64,
            "detpu_csr_scan_tile": _I64,
            "detpu_lengths_to_splits_scratch_bytes": _I64,
            "detpu_sgd_promoted_scratch_bytes": _I64,
            "detpu_sgd_scatter_scratch_bytes": _I64,
            "detpu_segment_prepared_bytes": _I64,
            "detpu_segment_split": _I64,
            "detpu_segment_sort_tile": _I64,
            "detpu_segment_long": _I64,
            "detpu_topk_pool_scratch_bytes": _I64,
            "detpu_topk_pool_clear_bytes": _I64,
            "detpu_topk_merge_scratch_bytes": _I64,
            "detpu_grad_health_chunk": _I64,
            "detpu_dense_update_prepared_bytes": _I64}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` failed or is missing; the message carries its output."""


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the ``PATH``, or the toolkit's
    default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels build only where the toolkit is")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_bytes(path: str) -> bytes:
    """The bytes of ``path`` followed by those of every local header it
    includes (quoted includes, resolved beside the including file, each
    once, in order of first inclusion)."""
    seen: List[str] = []

    def visit(p: str) -> None:
        p = os.path.normpath(p)
        if p in seen:
            return
        seen.append(p)
        with open(p, "rb") as f:
            text = f.read()
        for inc in _LOCAL_INCLUDE.findall(text):
            visit(os.path.join(os.path.dirname(p), inc.decode()))

    visit(path)
    out = b""
    for p in seen:
        with open(p, "rb") as f:
            out += f.read()
    return out


def _lib_path(name: str) -> str:
    h = hashlib.sha256(source_bytes(os.path.join(CSRC, name + ".cu"))
                       + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` resource lines) of the
    current build of ``name``, or ``""`` before it was built."""
    log = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def build_all(names: Optional[Sequence[str]] = None) -> List[str]:
    """Compile every kernel source not yet built, one ``nvcc`` process
    per source, all running at once. Returns the library paths."""
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (exit {rc}):\n{build_log(name)}")
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return [_lib_path(n) for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)
    with ``argtypes``/``restype`` set for every exported function."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = RESTYPES.get(fn, ctypes.c_int)
            lib.detpu_error_string.argtypes = [ctypes.c_int]
            lib.detpu_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        msg = lib.detpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} "
                           f"(cudaError_t {err})")


# ------------------------------------------------------ the launch records

#: launch records a cache keeps: the caching allocator hands a step's
#: tensors the same addresses step after step, so they are found again
LAUNCH_CACHE = 8

_PTR = torch.Tensor.data_ptr
_SHAPE = operator.attrgetter("shape")
_STRIDE = torch.Tensor.stride
_DTYPE = operator.attrgetter("dtype")
_DEVICE = torch.Tensor.get_device


def tensor_key(ts: Sequence[torch.Tensor]) -> tuple:
    """Every fact a record rests on for the tensors ``ts``, in one flat
    tuple: their addresses, shapes, strides, dtypes and device indices
    (-1 off the card), each fact for all tensors in one C-level pass
    (``map`` over unbound methods; ``chip_smoke.py``'s
    ``launch_host_split`` times it against a tuple a tensor)."""
    return (*map(_PTR, ts), *map(_SHAPE, ts), *map(_STRIDE, ts),
            *map(_DTYPE, ts), *map(_DEVICE, ts))


def layout_key(t: Optional[torch.Tensor]) -> Optional[tuple]:
    """The facts of a tensor that a call passes anew each time (its
    address is read per call, never kept): shape, strides, dtype and
    device index; ``None`` for ``None``."""
    if t is None:
        return None
    return t.shape, t.stride(), t.dtype, t.get_device()


def stream_handle(index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``index``,
    read without building a ``torch.cuda.Stream`` (``chip_smoke.py``'s
    ``launch_host_split`` times it against
    ``torch.cuda.current_stream(dev).cuda_stream``)."""
    return torch._C._cuda_getCurrentRawStream(index)


def device_index(dev: torch.device) -> int:
    """A record's card index (-1 off the card)."""
    return (dev.index or 0) if dev.type == "cuda" else -1


def find_or_build(cache: "LaunchCache", key: tuple, build, on_cpu: bool,
                  build_on_cpu: bool, *args) -> Optional["LaunchRecord"]:
    """The record under ``key`` in ``cache``, or ``build(*args)`` kept
    there. A miss on CPU tensors is validated (``build`` raises as the
    wrapper always has) and gives None (the wrapper runs the plain
    version) unless ``build_on_cpu``."""
    rec = cache.get(key)
    if rec is not None:
        return rec
    if on_cpu and not build_on_cpu:
        build(*args)
        return None
    return cache.add(key, build(*args))


class LaunchRecord:
    """One call's launches, validated and built once: per launch the
    bound C function and its leading arguments (converted once); a
    replay appends the per-call pointers and the current stream.

    ``keep`` false marks a record that must not be found again (it rests
    on a copy the call made). The C functions return a ``cudaError_t``,
    which :func:`check` turns into an exception."""

    __slots__ = ("lib", "what", "calls", "device", "keep", "payload")

    def __init__(self, lib: Optional[ctypes.CDLL], what: str,
                 calls: Sequence[Tuple[Callable, tuple]], device: int,
                 keep: bool = True, payload=None):
        self.lib, self.what = lib, what
        self.calls = tuple(calls)
        self.device, self.keep = device, keep
        #: what the arguments point into (host buffers), kept alive
        self.payload = payload

    def replay(self, *tail) -> int:
        """Launch every call on the current stream; returns the number
        of launches."""
        stream = stream_handle(self.device)
        for fn, head in self.calls:
            err = fn(*head, *tail, stream)
            if err:
                check(self.lib, err, self.what)
        return len(self.calls)


class LaunchCache:
    """A wrapper's (or a plan's) launch records by key, at most
    :data:`LAUNCH_CACHE` of them (the oldest goes first); ``builds``
    counts the records made. :meth:`get` compares a key with the last
    record's before it hashes it: a step calls with the same tensors
    again, and one comparison costs less than a hash and a comparison.
    Lookups take no lock (the last record and its key are one attribute,
    read at once); additions do."""

    __slots__ = ("records", "builds", "cap", "_last", "_lock")

    def __init__(self, cap: int = LAUNCH_CACHE):
        self.records: Dict[tuple, LaunchRecord] = {}
        self.builds = 0
        self.cap = cap
        self._last: Tuple[Optional[tuple], Optional[LaunchRecord]] = (None,
                                                                      None)
        self._lock = threading.Lock()

    def get(self, key: tuple) -> Optional[LaunchRecord]:
        """The record kept under ``key``, or None."""
        last = self._last
        if key == last[0]:
            return last[1]
        rec = self.records.get(key)
        if rec is not None:
            self._last = (key, rec)
        return rec

    def add(self, key: tuple, record: LaunchRecord) -> LaunchRecord:
        """Count a new record and keep it under ``key`` unless it is
        marked not to be kept. Returns it."""
        with self._lock:
            self.builds += 1
            if record.keep:
                if len(self.records) >= self.cap:
                    old = next(iter(self.records))
                    del self.records[old]
                    if old == self._last[0]:
                        self._last = (None, None)
                self.records[key] = record
                self._last = (key, record)
        return record

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self._last = (None, None)
