"""Registry of the ``DETPU_*`` environment variables the port reads.

Counterpart of ``distributed_embeddings_tpu/utils/envvars.py``, cut to
the knobs this package has: the ``DETPU_SERVE_*`` declarations that
:class:`~..parallel.serving.ServeConfig` reads, and the train-step
switches (``DETPU_OBS``, ``DETPU_NANGUARD``, ``DETPU_SGD_DEDUP``), the
checkpoint and fault knobs (``DETPU_CKPT_RING``, ``DETPU_FAULT``,
``DETPU_ON_MISMATCH``), the access-telemetry geometry
(``DETPU_TELEMETRY*``) and the streaming-vocab policy
(``DETPU_ADMIT_*``, ``DETPU_EVICT_MARGIN``) and the pipelined step's
microbatch count (``DETPU_MICROBATCH``), with the JAX
package's names and defaults, so one environment configures
both packages alike.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional


class EnvVar(NamedTuple):
    """One registered knob: its default (``None`` = unset) and meaning."""
    name: str
    default: Optional[str]
    doc: str


_REGISTRY: Dict[str, EnvVar] = {}


def declare(name: str, default: Optional[str] = None, doc: str = "") -> str:
    """Register one ``DETPU_*`` variable; returns the name."""
    _REGISTRY[name] = EnvVar(name, default, doc)
    return name


def _require(name: str) -> EnvVar:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"{name!r} is not a registered DETPU env var")
    return spec


def get(name: str) -> Optional[str]:
    """Read a registered variable (its declared default when unset)."""
    return os.environ.get(name, _require(name).default)


def enabled(name: str) -> bool:
    """Truthy read with the JAX package's convention: unset-with-falsy-
    default, empty, and ``"0"`` are off; anything else is on."""
    return get(name) not in (None, "", "0")


def get_float(name: str) -> float:
    """Float read; a malformed value falls back to the declared default."""
    fb = float(_require(name).default or 0.0)
    try:
        return float(os.environ.get(name, fb))
    except (TypeError, ValueError):
        return fb


def get_int(name: str) -> int:
    """Int read (same fallback policy as :func:`get_float`)."""
    fb = int(_require(name).default or 0)
    try:
        return int(os.environ.get(name, fb))
    except (TypeError, ValueError):
        return fb


# deadline-bounded serving runtime (parallel/serving.py)
declare("DETPU_SERVE_DEADLINE_MS", default="100",
        doc="default per-request deadline (ms, from submit): the "
            "scheduler flushes early to make it and drops requests "
            "already past it (typed Expired)")
declare("DETPU_SERVE_MAX_BATCH", default="256",
        doc="largest padded-batch rung (samples per flush)")
declare("DETPU_SERVE_MAX_QUEUE", default="1024",
        doc="hard admission bound (queued samples): a submit that would "
            "exceed it is shed with a typed Overloaded response")
declare("DETPU_SERVE_MAX_WAIT_MS", default="5",
        doc="batching delay: a queued request is flushed no later than "
            "this many ms after submit (0 under pressure)")
declare("DETPU_SERVE_RUNGS", default="",
        doc="comma-separated explicit padded-batch ladder (ascending) "
            "overriding the power-of-two default")
declare("DETPU_SERVE_SHED_FRAC", default="0.5",
        doc="queue fraction of DETPU_SERVE_MAX_QUEUE at which new "
            "lowest-priority (<= 0) requests are refused with a typed "
            "Overloaded response")

# train step (parallel/trainer.py, parallel/optimizers.py)
declare("DETPU_OBS", default="",
        doc="1 = build train steps with on-device step metrics (3-tuple "
            "return) and let the DLRM example write its metrics sidecar")
declare("DETPU_NANGUARD", default="1",
        doc="on-device non-finite guard in the hybrid step; 0 = build the "
            "unguarded step")
declare("DETPU_SGD_DEDUP", default="",
        doc="1 = force the sort/segment-sum dedup pass (K5) into "
            "SparseSGD, to compare it with the direct scatter")

# checkpoints and fault injection (utils/checkpoint.py, utils/runtime.py)
declare("DETPU_CKPT_RING", default="2",
        doc="ring size of last-good checkpoints kept BEYOND <dir> and "
            "<dir>.prev (save_train_state keep_last_n): each save archives "
            "the displaced .prev under <dir>.ring/ and prunes to this many "
            "entries. 0 = no ring")
declare("DETPU_FAULT", default="",
        doc="comma-separated fault injections: hang|slow|raise|die:<point> "
            "(checkpoint_write, checkpoint_commit, checkpoint_read) and "
            "corrupt@ckpt (flip a byte in each just-committed checkpoint's "
            "first table file, for the CRC manifest and .prev fallback)")
declare("DETPU_ON_MISMATCH", default="reshard",
        doc="restore policy of the DLRM example when a checkpoint's "
            "recorded sharding plan differs from the model's: 'reshard' "
            "re-slices the logical tables under the current plan, 'error' "
            "raises CheckpointMismatch")

# access telemetry (analysis/telemetry.py; carried through train steps
# built by parallel/trainer.py when enabled)
declare("DETPU_TELEMETRY", default="",
        doc="1 = telemetry-aware entry points build their steps with "
            "carried access telemetry. Plain step builders need the "
            "explicit telemetry= opt-in (it changes the step's call arity)")
declare("DETPU_TELEMETRY_CANDIDATES", default="0",
        doc="per-step unique-id candidates merged into the hot-row "
            "top-k; 0 = 4 * DETPU_TELEMETRY_TOPK")
declare("DETPU_TELEMETRY_INTERVAL", default="100",
        doc="metrics-log cadence (steps) of a telemetry demo run (the "
            "JAX package's tools/obs_report.py reads it)")
declare("DETPU_TELEMETRY_SKETCH_DEPTH", default="4",
        doc="count-min sketch rows (independent hashes) per width slab")
declare("DETPU_TELEMETRY_SKETCH_WIDTH", default="2048",
        doc="count-min sketch buckets per row; estimate error ~ "
            "total_ids/buckets")
declare("DETPU_TELEMETRY_TOPK", default="32",
        doc="hot-row slots tracked per width slab per rank")

# streaming vocab: frequency-gated admission + approximate-LFU eviction
# (parallel/streaming.py; carried through train steps built by
# parallel/trainer.py with dynamic=)
declare("DETPU_ADMIT_MIN_COUNT", default="2",
        doc="count-min estimate an external id needs before it may claim "
            "a dynamic-table slot; below it the id is served from its "
            "shared hash bucket")
declare("DETPU_ADMIT_SKETCH_DEPTH", default="4",
        doc="admission count-min sketch rows (independent hashes) per "
            "streaming width slab")
declare("DETPU_ADMIT_SKETCH_WIDTH", default="4096",
        doc="admission count-min sketch buckets per row; estimate error "
            "~ total_ids/buckets")
declare("DETPU_EVICT_MARGIN", default="1",
        doc="approximate-LFU eviction margin: a claim on an occupied "
            "slot succeeds only when the incoming estimate >= occupant "
            "frequency + margin (0 = ties evict)")

# the pipelined step's microbatch count (parallel/schedule.py)
declare("DETPU_MICROBATCH", default="2",
        doc="microbatch count K of steps built with a pipelined schedule "
            "(parallel.schedule.pipelined_schedule(K=None) resolves K "
            "here; only schedule='pipelined' opt-ins read it, the "
            "default schedule stays serialized regardless). The per-rank "
            "batch splits into K chains whose exchanges stay in flight "
            "under the other microbatches' lookups and dense compute, "
            "with gradients accumulated so the applied update matches "
            "the serialized step (K=1 IS the serialized step; the opt-in "
            "default is 2 so asking for a pipeline builds one). The "
            "per-rank batch must divide by K")
