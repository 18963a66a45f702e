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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

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
        # slab, slab_rows, width, ids, ids_is_64, rows, roff, div, mask,
        # weights, out, n_slots, b, hot, dtype, stream
        "detpu_gather_combine": (_P, _I64, _I, _P, _I, _P, _P, _P, _P,
                                 _P, _P, _I, _I64, _I, _I, _P),
    },
    "dot_interact": {
        # feats, out, batch, num_features, dim, dtype, stream
        "detpu_dot_interact_fwd": (_P, _P, _I64, _I, _I, _I, _P),
        # feats, dy, dfeats, batch, num_features, dim, dtype, stream
        "detpu_dot_interact_bwd": (_P, _P, _P, _I64, _I, _I, _I, _P),
    },
    "sgd_scatter": {
        # slab, rows, width, slab_dtype, ids, ids_is_64, n, vals,
        # vals_dtype, neg_lr, neg_lr_dev, cast_vals, stream
        "detpu_sgd_scatter": (_P, _I64, _I, _I, _P, _I, _I64, _P, _I,
                              ctypes.c_float, _P, _I, _P),
    },
    "sgd_promoted": {
        # slab, rows, width, ids, ids_is_64, n, vals, vals_dtype,
        # neg_lr_dev, scratch, stream
        "detpu_sgd_promoted": (_P, _I64, _I, _P, _I, _I64, _P, _I, _P, _P,
                               _P),
        # n, rows -> bytes
        "detpu_sgd_promoted_scratch_bytes": (_I64, _I64),
    },
    "dedup": {
        # ids, ids_is_64, n, vals, vals_dtype, width, pad_id, u_cap, uids,
        # ugrads, scratch, stream
        "detpu_dedup": (_P, _I, _I64, _P, _I, _I, _I64, _I64, _P, _P, _P,
                        _P),
        # n, width, ids_is_64 -> bytes
        "detpu_dedup_scratch_bytes": (_I64, _I, _I),
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
        # lengths, len_is_64, slot_stride, n_slots, b, valid, splits,
        # stream
        "detpu_lengths_to_splits": (_P, _I, _I64, _I, _I64, _P, _P, _P),
        # rows, rows_is_64, stride, nnz, dim0, splits, out_is_64, stream
        "detpu_row_to_split": (_P, _I, _I64, _I64, _I64, _P, _I, _P),
        # splits, is_64, n_slots, nrows, cap, out, stream
        "detpu_ragged_row_ids": (_P, _I, _I, _I64, _I64, _P, _P),
    },
    "ragged_combine": {
        # slab, slab_rows, width, dtype, values, ids_is_64, v_stride,
        # splits, rows, roff, mean, mask, weights, w_esize, w_stride, out,
        # out_dtype, n_slots, b, cap, stream
        "detpu_ragged_combine": (_P, _I64, _I, _I, _P, _I, _I64, _P, _P,
                                 _P, _P, _P, _P, _I, _I64, _P, _I, _I,
                                 _I64, _I64, _P),
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
        # -> the largest topk + candidates
        "detpu_topk_merge_max": (),
        # cms, depth, buckets, pool, k_pool, candidates, topk_ids,
        # topk_est, topk, ids_acc, count_part, n_part, count_out, stream
        "detpu_topk_merge": (_P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P,
                             _I, _P, _P),
    },
    "exchange_pack": {
        # descs (host int64 [n, 8]), n, n_tiles, stream
        "detpu_pack_ids": (_P, _I, _I64, _P),
        "detpu_pack_cols": (_P, _I, _I64, _P),
        # -> the most descriptors a launch takes / the units a tile covers
        "detpu_pack_max_descs": (),
        "detpu_pack_tile_units": (),
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
            "detpu_sgd_promoted_scratch_bytes": _I64,
            "detpu_topk_pool_scratch_bytes": _I64,
            "detpu_topk_pool_clear_bytes": _I64}

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
