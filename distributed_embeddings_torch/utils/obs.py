"""The train step's observability switches, the step-metrics schema and
its JSONL logger, and the process-level counters and events (counterpart
of the parts of ``distributed_embeddings_tpu/utils/obs.py`` the port
calls): the two readers ``make_hybrid_train_step`` and
``make_hybrid_train_loop`` call (read when a step is BUILT), the key
tuples of the instrumented step's metrics dict (the port's own copy of
JAX's), :func:`summarize` of one metrics dict, :class:`MetricsLogger`,
the counters and structured events the checkpoint codec and the fault
points record, and the step's phase scopes (:func:`scope`, named as
``parallel/schedule.py`` names the phases)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from . import envvars

logger = logging.getLogger(__name__)

OBS_ENV = "DETPU_OBS"
NANGUARD_ENV = "DETPU_NANGUARD"

#: prefix of every phase scope's profiler range (``detpu/<name>``)
SCOPE_PREFIX = "detpu"

#: Keys of the instrumented step's metrics dict (``with_metrics=True`` /
#: ``DETPU_OBS=1``). Every value is a per-rank ``[world]`` tensor (JAX's
#: per-rank vector; ``[1]`` at world 1), except the three per-table
#: health sentinels (``table_*``), which are ``[world, n_tables]``; the
#: train loop stacks each along a leading step axis.
STEP_METRIC_KEYS = (
    "ids_routed",        # live (non-padding) ids this rank received
    "id_overflow",       # ragged ids lost to static-capacity truncation
    "invalid_id_count",  # negative / out-of-vocab ids among the live ids
    "id_a2a_bytes",      # id-exchange bytes leaving this rank (dp->mp)
    "out_a2a_bytes",     # activation-exchange bytes leaving (mp->dp fwd)
    "grad_a2a_bytes",    # cotangent-exchange bytes leaving (dp->mp bwd)
    "out_pad_frac",      # dead-column fraction of this rank's output rows
    "loss",              # the step's loss
    "emb_grad_norm",     # L2 norm of this rank's embedding cotangents
    "dense_grad_norm",   # L2 norm of the (averaged) dense gradient
    "skipped_steps",     # 1 when the non-finite guard skipped this step
    "step",              # step counter at the START of the step
    "table_grad_norm",      # per-table L2 norm of the sparse cotangents
    "table_update_maxabs",  # per-table max |row update| (lr/world scaled)
    "table_nonfinite",      # per-table count of non-finite cotangents
)

#: The per-table health-sentinel subset of :data:`STEP_METRIC_KEYS`.
TABLE_HEALTH_KEYS = ("table_grad_norm", "table_update_maxabs",
                     "table_nonfinite")

#: Extra step-metric keys of streaming-vocabulary steps (``dynamic=``):
#: ``[1]`` counts of THIS step's slot-map transitions, gated by the
#: non-finite guard like the updates they describe (a skipped step
#: reports zeros).
STREAMING_METRIC_KEYS = (
    "stream_admitted",    # external ids admitted to a real slot
    "stream_evicted",     # slot occupants evicted back to their bucket
    "stream_bucket_ids",  # live ids served from a shared hash bucket
    "stream_hit_ids",     # live ids served from their admitted slot
)

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}
_events: List[Dict[str, Any]] = []


def metrics_enabled() -> bool:
    """Whether ``DETPU_OBS`` asks for step metrics."""
    return envvars.enabled(OBS_ENV)


def nanguard_enabled() -> bool:
    """Whether the on-device non-finite guard is on. Default ON
    (``DETPU_NANGUARD`` unset or truthy); ``DETPU_NANGUARD=0`` builds the
    unguarded step."""
    return envvars.enabled(NANGUARD_ENV)


# ------------------------------------------------------------ phase scopes

#: the list :func:`phase_log` collects scope names into (None: off)
_phase_log: Optional[List[str]] = None


class scope:
    """``with obs.scope(name):`` marks one phase of the step: a
    ``torch.profiler.record_function("detpu/<name>")`` range while a
    profiler records (the port's counterpart of JAX's
    ``jax.named_scope``), the name appended to the active
    :func:`phase_log`, and nothing else (no profiler, no log: two
    checks). The names are ``parallel/schedule.py``'s phases, with the
    pipelined step's ``_mb{k}`` tags; a wait on an exchange in flight is
    ``<phase>_wait``."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        import torch

        if _phase_log is not None:
            _phase_log.append(self.name)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(
                f"{SCOPE_PREFIX}/{self.name}")
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


@contextlib.contextmanager
def phase_log() -> Iterator[List[str]]:
    """Collect the names of the scopes entered inside the block, in the
    order the host entered them (the order the step issued its phases:
    the tests read the pipelined step's schedule from it)."""
    global _phase_log
    saved, _phase_log = _phase_log, []
    try:
        yield _phase_log
    finally:
        _phase_log = saved


def counter_inc(name: str, n: int = 1) -> int:
    """Bump a process-level counter; returns the new value."""
    with _counters_lock:
        v = _counters.get(name, 0) + n
        _counters[name] = v
    return v


def counters() -> Dict[str, int]:
    """Snapshot of every process counter."""
    with _counters_lock:
        return dict(_counters)


def record_event(kind: str, **payload: Any) -> Dict[str, Any]:
    """Record one structured event (``checkpoint_prev_fallback``,
    ``checkpoint_reshard``, ...; also bumps the ``event_<kind>``
    counter); returns the stored record."""
    rec = {"event": kind, "time": time.time(), **payload}
    with _counters_lock:
        _events.append(rec)
    counter_inc(f"event_{kind}")
    return rec


def drain_events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Pop (and return) recorded events: all of them, or only ``kind``.
    Draining is the consumer's acknowledgment; events are delivered at
    most once."""
    with _counters_lock:
        if kind is None:
            out, _events[:] = list(_events), []
            return out
        out = [e for e in _events if e["event"] == kind]
        _events[:] = [e for e in _events if e["event"] != kind]
        return out


def record_fault(point: str) -> None:
    """Counter hook for :func:`.runtime.fault_point`: one bump per fired
    injection, keyed globally and per point."""
    counter_inc("fault_injections")
    counter_inc(f"fault_injections.{point}")


# --------------------------------------------------------- host collection


def summarize(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Host scalar summary of one step-metrics dict (JAX's
    ``obs.summarize``): per-rank vectors reduce to totals (sums for
    counts and bytes, the max for overflow, fractions, norms, skips and
    the table sentinels), other entries to their first element; a vector
    of more than one entry also reports its ``<key>_p50`` and
    ``<key>_p95``. Tensors are read back here."""
    import numpy as np

    def host(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v).reshape(-1)

    out: Dict[str, Any] = {}
    for k in STEP_METRIC_KEYS + STREAMING_METRIC_KEYS:
        if k not in metrics:
            continue
        v = host(metrics[k])
        if v.size == 0:
            continue
        if k in ("ids_routed", "invalid_id_count", "id_a2a_bytes",
                 "out_a2a_bytes", "grad_a2a_bytes"
                 ) or k in STREAMING_METRIC_KEYS:
            out[k] = float(v.sum())
        elif k in ("id_overflow", "out_pad_frac", "emb_grad_norm",
                   "skipped_steps") or k in TABLE_HEALTH_KEYS:
            out[k] = float(v.max())
        else:
            out[k] = float(v[0])
        if v.size > 1:
            out[f"{k}_p50"] = float(np.percentile(v, 50))
            out[f"{k}_p95"] = float(np.percentile(v, 95))
    return out


class MetricsLogger:
    """Fsynced JSONL sidecar of step metrics and counters (JAX's
    ``MetricsLogger``): every record is one JSON line, written, flushed
    and fsynced before the call returns, so a process killed at any point
    leaves every earlier record parseable. Records:

    * ``{"section": "step_metrics", "step": N, "metrics": {...}}`` from
      :meth:`log_step`; tensors are read back and listified (the
      per-rank ``[world]`` vectors stay vectors);
    * ``{"section": "counters", "counters": {...}}`` from
      :meth:`log_counters`: the process counters."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _record(self, section: str, **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"section": section, **fields}
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    def log_step(self, metrics: Dict[str, Any], step: Optional[int] = None,
                 **extra: Any) -> Dict[str, Any]:
        """Append one step-metrics record. ``metrics`` is the dict the
        instrumented train step returned; reading its tensors back here
        is the one host read the caller opted into by logging."""
        host = {k: v.tolist() if hasattr(v, "tolist") else v
                for k, v in metrics.items()}
        rec = dict(extra)
        if step is not None:
            rec["step"] = int(step)
        return self._record("step_metrics", metrics=host, **rec)

    def log_counters(self, **extra: Any) -> Dict[str, Any]:
        """Append the current process-counter snapshot."""
        return self._record("counters", counters=counters(), **extra)

    @staticmethod
    def load(path: str) -> List[Dict[str, Any]]:
        """Parse a metrics sidecar (a torn trailing line is skipped)."""
        out: List[Dict[str, Any]] = []
        if not os.path.exists(path):
            return out
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    logger.warning("skipping torn sidecar line in %s", path)
        return out
