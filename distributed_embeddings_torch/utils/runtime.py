"""The fault layer's errors and env-driven fault injection (counterpart
of the part of ``distributed_embeddings_tpu/utils/runtime.py`` that the
checkpoint codec uses, copied where it was JAX-free): the error classes
it raises and :func:`fault_point` / :func:`corrupt_ckpt_requested`, so
a killed process mid-checkpoint and a torn file on disk are testable on
the CPU. Backend probing, retries, deadlines and section records wait
for ROADMAP A12."""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from . import envvars

logger = logging.getLogger(__name__)

FAULT_ENV = "DETPU_FAULT"


class RuntimeFault(RuntimeError):
    """Base class for the fault layer's own errors."""


class CheckpointCorrupt(RuntimeFault):
    """A checkpoint failed validation (missing file, CRC mismatch, torn
    manifest) and no fallback was available."""


class CheckpointMismatch(RuntimeFault):
    """A (whole, CRC-valid) checkpoint does not match the model it is
    being restored into: wrong table count, a table whose saved
    vocab/dim disagrees with ``de.strategy.global_configs``, or another
    sharding plan under ``on_mismatch="error"``. Raised before any data
    streams."""


class CoordinatorUnreachable(RuntimeFault):
    """The process group could not be joined within the retry budget
    (``parallel/bootstrap.py:initialize``): a job that expects ranks must
    not fall apart into independent single-rank runs."""


class FaultInjected(RuntimeFault):
    """Raised by :func:`fault_point` under ``DETPU_FAULT=raise:<point>``."""


# per-process fire counts, keyed by (mode, point): lets a spec carry a
# budget ("fail the first N calls, then pass")
_fire_counts: Dict[Tuple[str, str], int] = {}


def reset_fault_counts() -> None:
    """Forget fire-count state (test isolation helper)."""
    _fire_counts.clear()


def _fault_specs() -> List[Tuple[str, str, Optional[str]]]:
    """Parse ``DETPU_FAULT`` (read at every call so tests can flip it at
    run time): comma-separated ``mode:point[:arg]`` entries; the
    driver-level ``<kind>@<step>`` drills and ``corrupt@ckpt`` are not
    points."""
    out = []
    for item in (envvars.get(FAULT_ENV) or "").split(","):
        item = item.strip()
        if not item or "@" in item.split(":", 1)[0]:
            continue
        parts = item.split(":", 2)
        if len(parts) < 2:
            logger.warning("ignoring malformed %s entry %r", FAULT_ENV, item)
            continue
        out.append((parts[0], parts[1], parts[2] if len(parts) > 2 else None))
    return out


def corrupt_ckpt_requested() -> bool:
    """True when ``DETPU_FAULT=corrupt@ckpt`` asks the checkpoint layer
    to flip a byte in a just-committed table file (simulated silent
    on-disk corruption the CRC manifest must catch)."""
    return any(item.strip() == "corrupt@ckpt"
               for item in (envvars.get(FAULT_ENV) or "").split(","))


def fault_point(point: str) -> None:
    """Named fault-injection hook (``checkpoint_write``,
    ``checkpoint_commit``, ``checkpoint_read``). No-op unless
    ``DETPU_FAULT`` targets ``point``. Modes: ``hang:<point>[:secs]``
    (sleep, default 3600 s), ``slow:<point>[:secs]`` (sleep, default
    5 s), ``raise:<point>[:count]`` (raise :class:`FaultInjected`, only
    the first ``count`` calls with a count), ``die:<point>``
    (``os._exit(17)``: hard process death, no cleanup runs)."""
    for mode, p, arg in _fault_specs():
        if p != point:
            continue
        key = (mode, p)
        n = _fire_counts.get(key, 0)
        if mode == "raise" and arg is not None and n >= int(arg):
            continue  # budget exhausted: the point now passes
        _fire_counts[key] = n + 1
        from . import obs

        obs.record_fault(point)
        if mode == "hang":
            time.sleep(float(arg) if arg else 3600.0)
        elif mode == "slow":
            time.sleep(float(arg) if arg else 5.0)
        elif mode == "raise":
            raise FaultInjected(f"injected fault at {point!r}")
        elif mode == "die":
            logger.error("DETPU_FAULT: dying at %r", point)
            os._exit(17)
        else:
            logger.warning("ignoring unknown %s mode %r", FAULT_ENV, mode)
