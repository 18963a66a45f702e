"""The train step's observability switches and the process-level
counters and events (counterpart of the parts of
``distributed_embeddings_tpu/utils/obs.py`` the port calls): the two
readers ``make_hybrid_train_step`` and ``make_hybrid_train_loop`` call
(read when a step is BUILT), and the counters and structured events the
checkpoint codec and the fault points record. Step metrics wait for
ROADMAP A6."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from . import envvars

OBS_ENV = "DETPU_OBS"
NANGUARD_ENV = "DETPU_NANGUARD"

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
