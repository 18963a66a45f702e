"""Deadline-bounded serving runtime: request coalescing, overload
admission control, and graceful degradation (counterpart of the core of
``distributed_embeddings_tpu/parallel/serving.py``).

Host-side policy around ONE forward, :func:`~.trainer.make_hybrid_eval_step`
over frozen tables:

* **The ladder** — a small fixed set of padded batch sizes ("rungs");
  every flush runs at one of them, so the kernels see a handful of
  shapes. :meth:`ServingRuntime.warmup` runs each rung once up front
  (building the CUDA kernels on first use).
* **The coalescer** — variable-size requests (``n`` samples each,
  single- or fixed multi-hot ids) pack FIFO into the smallest rung that
  holds them; padding samples are whole fake rows (id 0, zero features)
  whose predictions are sliced off, and the padding fraction is
  reported.
* **The robustness core** — a deadline scheduler (flush on a full rung,
  on ``max_wait_ms``, or early when the tightest queued deadline
  demands it; requests already past their deadline are answered with a
  typed :class:`Expired`) and a degradation ladder: level 0 batches for
  efficiency, level 1 (a full rung queued) drops the batching delay,
  level 2 (``shed_frac x max_queue`` queued) refuses new
  ``priority <= 0`` requests with a typed :class:`Overloaded`; at
  ``max_queue`` everything new is refused. A flush that raises answers
  its requests with a typed :class:`Failed`.

Every :class:`Served` carries five latency spans that sum to its
``latency_ms``: queue wait (its own), then its flush's coalesce,
dispatch, device compute (up to the predictions on the host) and reply
slicing. :meth:`ServingRuntime.stats` reports counts, the padding
fraction and latency percentiles (``np.percentile(...,
method="lower")`` over the last :data:`STATS_WINDOW` served requests).

The runtime is single-threaded and clock-injectable: callers own the
loop (``submit`` + ``poll``), tests drive a manual clock, and
:func:`drive` is a real-time load loop.

``streaming=(config, state)`` serves streaming tables through their
slot map read-only (``make_hybrid_eval_step(dynamic=)``): every flush
reads the installed streaming state and none writes it.

Not ported yet (ROADMAP A12 unless named): the metrics registry and its
scrape endpoint, request tracing, snapshot installation and the
freshness rung, ragged requests, the
threaded ``RealtimeDriver`` and burst drills, the supervised worker
process, and the multi-rank mesh (A7b: a layer of world size > 1
raises).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import envvars
from ..utils.data import power_law_ids
from . import streaming as streaming_mod
from .trainer import make_hybrid_eval_step

logger = logging.getLogger(__name__)

#: degradation-ladder levels (index = level)
LEVELS = ("healthy", "pressure", "shed")

#: per-request latency decomposition stages, in pipeline order
STAGES = ("queue_wait", "coalesce", "dispatch", "device_compute",
          "reply_slice")

#: served requests kept for the latency percentiles of stats()
STATS_WINDOW = 1 << 16


class ServeConfig:
    """Static serving policy (ladder, deadlines, admission bounds); every
    unset field reads its ``DETPU_SERVE_*`` variable. ``rungs``
    overrides the power-of-two ladder."""

    def __init__(self,
                 max_batch: Optional[int] = None,
                 rungs: Optional[Sequence[int]] = None,
                 max_wait_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 shed_frac: Optional[float] = None):
        env_rungs = envvars.get("DETPU_SERVE_RUNGS") or ""
        if rungs is None and env_rungs.strip():
            rungs = [int(x) for x in env_rungs.split(",") if x.strip()]
        self.rungs = tuple(int(r) for r in rungs) if rungs else None
        self.max_batch = int(
            max_batch if max_batch is not None
            else (self.rungs[-1] if self.rungs
                  else envvars.get_int("DETPU_SERVE_MAX_BATCH")))
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None
            else envvars.get_float("DETPU_SERVE_MAX_WAIT_MS"))
        self.deadline_ms = float(
            deadline_ms if deadline_ms is not None
            else envvars.get_float("DETPU_SERVE_DEADLINE_MS"))
        self.max_queue = int(
            max_queue if max_queue is not None
            else envvars.get_int("DETPU_SERVE_MAX_QUEUE"))
        self.shed_frac = float(
            shed_frac if shed_frac is not None
            else envvars.get_float("DETPU_SERVE_SHED_FRAC"))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if not (0.0 < self.shed_frac <= 1.0):
            raise ValueError("shed_frac must be in (0, 1]")
        if self.max_queue < self.max_batch:
            raise ValueError(
                f"max_queue ({self.max_queue}) must hold at least one "
                f"full batch ({self.max_batch}) — a queue smaller than "
                "a rung sheds healthy traffic")


def resolve_rungs(config: ServeConfig, world: int) -> Tuple[int, ...]:
    """The padded-batch ladder: explicit ``config.rungs`` validated, or
    powers of two from ``max(8, world)`` up to ``max_batch`` (each
    rounded up to a ``world`` multiple; the top rung rounds down)."""
    if config.rungs:
        rungs = list(config.rungs)
        if sorted(rungs) != rungs or len(set(rungs)) != len(rungs):
            raise ValueError(f"rungs must be strictly ascending: {rungs}")
        for r in rungs:
            if r < 1 or r % world:
                raise ValueError(
                    f"rung {r} is not a positive multiple of world "
                    f"{world}")
        return tuple(rungs)

    def up(x: int) -> int:
        return ((x + world - 1) // world) * world

    lo = up(max(8, world))
    hi = max(world, (config.max_batch // world) * world)
    rungs = []
    r = lo
    while r < hi:
        rungs.append(r)
        r *= 2
    rungs.append(hi)
    return tuple(sorted(set(rungs)))


# ---------------------------------------------------------------- requests


@dataclasses.dataclass
class Request:
    """One inference request: ``n`` samples of categorical ids (one
    ``[n]`` or ``[n, h]`` int array per model input) plus the dense
    ``batch`` (``None`` or one ``[n, ...]`` array) the ``pred_fn``
    consumes. Higher ``priority``
    survives longer under overload; ``deadline_ms`` (from submit time)
    defaults to the config's."""

    cats: Sequence[Any]
    batch: Any = None
    priority: int = 0
    deadline_ms: Optional[float] = None
    # filled in by submit():
    rid: int = -1
    n: int = 0
    t_submit: float = 0.0
    deadline: float = 0.0


@dataclasses.dataclass
class ServeResult:
    """Base of the typed responses (``isinstance`` IS the status)."""

    rid: int
    latency_ms: float

    @property
    def status(self) -> str:
        return type(self).__name__.lower()


@dataclasses.dataclass
class Served(ServeResult):
    """Predictions for one request, sliced from its flush. ``spans``
    holds one ``<stage>_ms`` entry per :data:`STAGES` member; they sum
    to ``latency_ms``."""

    predictions: Any = None
    rung: int = 0
    deadline_missed: bool = False  # completed, but after the deadline
    spans: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class Overloaded(ServeResult):
    """Typed load-shed rejection: the admission controller refused the
    request (full queue, or shed level + low priority)."""

    reason: str = "queue_full"
    level: int = 0
    queue_samples: int = 0
    spans: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class Expired(ServeResult):
    """The request's deadline passed while it was still queued; counted
    ``deadline_missed``. Its whole life was queue wait."""

    deadline_ms: float = 0.0
    spans: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class Failed(ServeResult):
    """The flush this request was coalesced into raised: the request is
    answered typed instead of the exception escaping ``poll()``."""

    reason: str = ""
    spans: Optional[Dict[str, float]] = None


# -------------------------------------------------------------- helpers


def _batch_spec(batch):
    """Per-sample shape and dtype of the dense batch (``None`` or one
    ``[n, ...]`` array)."""
    if batch is None:
        return None
    a = np.asarray(batch)
    return tuple(a.shape[1:]), a.dtype.str


def _to_host(pred: torch.Tensor) -> np.ndarray:
    """Predictions to host numpy (waits for the device)."""
    pred = pred.detach().cpu()
    return (pred.float() if pred.dtype == torch.bfloat16 else pred).numpy()


# ----------------------------------------------------------- the runtime


class ServingRuntime:
    """Single-threaded deadline-bounded server around one forward.

    Usage::

        rt = ServingRuntime(de, pred_fn, state,
                            config=ServeConfig(max_batch=128))
        rt.warmup((template_cats, template_batch))
        rej = rt.submit(Request(cats=..., batch=...))  # None or Overloaded
        results += rt.poll()                           # flushes when due

    Requests arrive as host numpy; each flush packs them, copies them to
    the device that holds the tables, and copies the predictions back.
    ``streaming=(StreamingConfig, streaming_state)`` serves streaming
    tables read-only (cold ids read their buckets; the state is never
    written). ``clock`` is injectable for deterministic tests;
    ``submit`` and ``poll`` accept an explicit ``now``.
    """

    def __init__(self, de, pred_fn: Callable, state,
                 config: Optional[ServeConfig] = None,
                 streaming: Optional[tuple] = None,
                 clock: Callable[[], float] = time.monotonic):
        if de.world_size != 1:
            raise NotImplementedError(
                "serving a layer of world size > 1 (the serving mesh) is "
                "not ported yet: ROADMAP A7b")
        self.de = de
        self.config = config or ServeConfig()
        self.world = 1
        self.rungs = resolve_rungs(self.config, self.world)
        self.state = state
        self.device = next(iter(state.emb_params.values())).device
        self._clock = clock
        self._streaming_cfg = None
        self._streaming_state = None
        if streaming is not None:
            cfg, sstate = streaming
            self._streaming_cfg = streaming_mod.resolve_config(cfg)
            self._streaming_state = sstate
        self._eval = make_hybrid_eval_step(de, pred_fn,
                                           dynamic=self._streaming_cfg)
        self._queue: List[Request] = []
        self._queued_samples = 0
        self._level = 0
        self._next_rid = 0
        self._input_spec: Optional[List[tuple]] = None
        self._batch_spec: Any = None
        self._est_s = 0.0           # EMA of flush wall seconds
        self._lat_ms: deque = deque(maxlen=STATS_WINDOW)
        self._stage_ms = {s: deque(maxlen=STATS_WINDOW) for s in STAGES}
        self._pad_slots = 0
        self._total_slots = 0
        self._rung_flushes: Dict[int, int] = {r: 0 for r in self.rungs}
        self._counts = {"served": 0, "shed": 0, "deadline_missed": 0,
                        "expired": 0, "failed": 0, "flushes": 0,
                        "served_samples": 0, "degraded": 0,
                        "recovered": 0}

    @property
    def streaming_state(self):
        """The streaming state every flush reads (``None`` without
        streaming tables)."""
        return self._streaming_state

    @streaming_state.setter
    def streaming_state(self, value) -> None:
        self._streaming_state = value

    def _forward(self, cats, batch):
        if self._streaming_cfg is None:
            return self._eval(self.state, cats, batch)
        return self._eval(self.state, cats, batch, self._streaming_state)

    # ------------------------------------------------------------ intake

    def _normalize(self, req: Request, now: float) -> Request:
        """Derive ``n``, validate shapes against the (template-derived)
        input spec, stamp rid and deadline."""
        if len(req.cats) != len(self.de.strategy.input_table_map):
            raise ValueError(
                f"request has {len(req.cats)} categorical inputs, the "
                f"model takes {len(self.de.strategy.input_table_map)}")
        spec = self._spec_of(req.cats, req.batch)
        if self._input_spec is None:
            self._input_spec, self._batch_spec = spec
        if spec[0] != self._input_spec:
            raise ValueError(
                f"request input spec {spec[0]} does not match the "
                f"warmed-up spec {self._input_spec} — one ladder serves "
                "one input layout")
        if spec[1] != self._batch_spec:
            # reject HERE, while nothing is queued: a malformed batch
            # that only failed at pack time would fail the whole flush
            raise ValueError(
                f"request batch spec {spec[1]} does not match the "
                f"warmed-up spec {self._batch_spec}")
        cats = [np.asarray(c) for c in req.cats]
        n = None
        for i, c in enumerate(cats):
            if n is None:
                n = int(c.shape[0])
            elif n != c.shape[0]:
                raise ValueError(
                    f"input {i} has {c.shape[0]} samples, input 0 has {n}")
        if not n:
            raise ValueError("empty request")
        if n > self.rungs[-1]:
            raise ValueError(
                f"request of {n} samples exceeds the largest rung "
                f"{self.rungs[-1]} — split it client-side")
        req.cats = cats
        req.n = int(n)
        req.rid = self._next_rid
        self._next_rid += 1
        req.t_submit = now
        dl = (req.deadline_ms if req.deadline_ms is not None
              else self.config.deadline_ms)
        req.deadline_ms = float(dl)
        req.deadline = now + dl / 1e3
        return req

    def _spec_of(self, cats, batch) -> tuple:
        spec = []
        for c in cats:
            if isinstance(c, (list, tuple)):
                raise NotImplementedError(
                    "ragged (list-of-lists) requests are not ported yet: "
                    "ROADMAP A12")
            a = np.asarray(c)
            if a.ndim == 1:
                spec.append(("d", 1))
            elif a.ndim == 2:
                spec.append(("d", int(a.shape[1])))
            else:
                raise ValueError(
                    f"categorical input rank {a.ndim} unsupported")
        return spec, _batch_spec(batch)

    def submit(self, req: Request,
               now: Optional[float] = None) -> Optional[Overloaded]:
        """Admit one request. Returns ``None`` (queued — the answer
        arrives from a later :meth:`poll`) or a typed
        :class:`Overloaded` when the admission controller sheds it."""
        now = self._clock() if now is None else now
        req = self._normalize(req, now)
        q = self._queued_samples
        shed_at = self.config.shed_frac * self.config.max_queue
        reason = None
        if q + req.n > self.config.max_queue:
            reason = "queue_full"
        elif q >= shed_at and req.priority <= 0:
            reason = "load_shed"
        if reason is not None:
            self._counts["shed"] += 1
            self._update_level()
            return Overloaded(rid=req.rid, latency_ms=0.0, reason=reason,
                              level=self._level, queue_samples=q,
                              spans={"queue_wait_ms": 0.0})
        self._queue.append(req)
        self._queued_samples += req.n
        self._update_level()
        return None

    @property
    def queued_samples(self) -> int:
        return self._queued_samples

    @property
    def level(self) -> int:
        """Current degradation-ladder level (0 healthy, 1 pressure,
        2 shed)."""
        return self._level

    # ------------------------------------------------- degradation ladder

    def _target_level(self, q: int) -> int:
        if q >= self.config.shed_frac * self.config.max_queue:
            return 2
        if q >= self.rungs[-1]:
            return 1
        return 0

    def _update_level(self) -> None:
        q = self._queued_samples
        new, old = self._target_level(q), self._level
        if new == old:
            return
        self._level = new
        if new > old:
            self._counts["degraded"] += 1
            logger.warning("serving degraded to %s (queue %d samples)",
                           LEVELS[new], q)
        else:
            self._counts["recovered"] += 1
            logger.info("serving recovered to %s (queue %d samples)",
                        LEVELS[new], q)

    # ----------------------------------------------------------- packing

    def _rung_for(self, n: int) -> int:
        for r in self.rungs:
            if r >= n:
                return r
        return self.rungs[-1]

    def _pack(self, reqs: List[Request], rung: int):
        """Coalesce ``reqs`` (total samples <= rung) into one padded
        rung-shaped input set on the tables' device. Padding samples are
        whole fake rows: id 0 everywhere, zero dense features."""
        offsets = []
        off = 0
        for r in reqs:
            offsets.append(off)
            off += r.n
        cats_out = []
        for i, (_, hot) in enumerate(self._input_spec):
            shape = (rung,) if hot == 1 else (rung, hot)
            buf = np.zeros(shape, np.int32)
            for r, o in zip(reqs, offsets):
                a = np.asarray(r.cats[i], np.int32)
                buf[o:o + r.n] = a if hot > 1 or a.ndim == 1 \
                    else a.reshape(r.n)
            cats_out.append(torch.from_numpy(buf).to(self.device))
        batch_out = None
        if self._batch_spec is not None:
            trailing, dtype = self._batch_spec
            buf = np.zeros((rung,) + trailing, np.dtype(dtype))
            for r, o in zip(reqs, offsets):
                buf[o:o + r.n] = np.asarray(r.batch)
            batch_out = torch.from_numpy(buf).to(self.device)
        return cats_out, batch_out, offsets

    # ----------------------------------------------------------- serving

    def warmup(self, template) -> int:
        """Run one all-padding flush per rung from a ``(cats, batch)``
        template (one representative request's inputs), so the first
        served request pays no kernel build or first-launch cost.
        Returns the number of warmup flushes."""
        cats, batch = template
        self._input_spec, self._batch_spec = self._spec_of(cats, batch)
        for rung in self.rungs:
            c, b, _ = self._pack([], rung)
            _to_host(self._forward(c, b))
        return len(self.rungs)

    def _run_flush(self, reqs: List[Request], rung: int) -> List[Served]:
        t0 = self._clock()
        cats, batch, offsets = self._pack(reqs, rung)
        t_pack = self._clock()
        pending = self._forward(cats, batch)
        t_disp = self._clock()
        preds = _to_host(pending)  # device compute + host fetch
        t_dev = self._clock()
        slices = [preds[o:o + r.n] for r, o in zip(reqs, offsets)]
        t1 = self._clock()
        self._est_s = (t_dev - t0 if not self._est_s
                       else 0.7 * self._est_s + 0.3 * (t_dev - t0))
        n = sum(r.n for r in reqs)
        self._pad_slots += rung - n
        self._total_slots += rung
        self._counts["flushes"] += 1
        self._rung_flushes[rung] = self._rung_flushes.get(rung, 0) + 1
        # the flush-level spans are shared by every coalesced request;
        # queue wait is per request. The five sum to each latency
        coalesce_ms = (t_pack - t0) * 1e3
        dispatch_ms = (t_disp - t_pack) * 1e3
        device_ms = (t_dev - t_disp) * 1e3
        reply_ms = (t1 - t_dev) * 1e3
        out = []
        for r, pred in zip(reqs, slices):
            lat = (t1 - r.t_submit) * 1e3
            missed = t1 > r.deadline
            spans = {"queue_wait_ms": (t0 - r.t_submit) * 1e3,
                     "coalesce_ms": coalesce_ms,
                     "dispatch_ms": dispatch_ms,
                     "device_compute_ms": device_ms,
                     "reply_slice_ms": reply_ms}
            self._lat_ms.append(lat)
            for stage, v in zip(STAGES, spans.values()):
                self._stage_ms[stage].append(v)
            self._counts["served"] += 1
            self._counts["served_samples"] += r.n
            if missed:
                self._counts["deadline_missed"] += 1
            out.append(Served(rid=r.rid, latency_ms=lat, predictions=pred,
                              rung=rung, deadline_missed=missed,
                              spans=spans))
        return out

    def poll(self, now: Optional[float] = None) -> List[ServeResult]:
        """Run the scheduler once: expire dead requests, flush every due
        batch, update the degradation level. Returns the completed
        results (:class:`Served` / :class:`Expired` / :class:`Failed`);
        cheap when nothing is due."""
        out: List[ServeResult] = []
        explicit = now is not None
        while True:
            t = now if explicit else self._clock()
            # requests strictly past their deadline are dropped (typed)
            # rather than spending rung slots on them
            keep = []
            for r in self._queue:
                if r.deadline < t:
                    self._queued_samples -= r.n
                    self._counts["expired"] += 1
                    self._counts["deadline_missed"] += 1
                    lat = (t - r.t_submit) * 1e3
                    out.append(Expired(rid=r.rid, latency_ms=lat,
                                       deadline_ms=r.deadline_ms,
                                       spans={"queue_wait_ms": lat}))
                else:
                    keep.append(r)
            self._queue = keep
            if not self._queue:
                break
            oldest = self._queue[0]
            full = self._queued_samples >= self.rungs[-1]
            # level 1: under pressure the batching delay shrinks to zero
            wait_s = (0.0 if self._level >= 1
                      else self.config.max_wait_ms / 1e3)
            timed_out = t >= oldest.t_submit + wait_s
            # flush early when the TIGHTEST queued deadline would be
            # missed by waiting any longer (the flush itself costs ~est_s)
            tightest = min(r.deadline for r in self._queue)
            deadline_due = t + self._est_s >= tightest
            if not (full or timed_out or deadline_due):
                break
            out.extend(self._flush_picked())
        self._update_level()
        return out

    def _flush_picked(self) -> List[ServeResult]:
        """Pop one rung's worth of requests FIFO and run the flush; a
        flush that raises answers its requests with typed :class:`Failed`
        instead of losing every co-batched request."""
        picked: List[Request] = []
        total = 0
        while self._queue and total + self._queue[0].n <= self.rungs[-1]:
            r = self._queue.pop(0)
            picked.append(r)
            total += r.n
        self._queued_samples -= total
        try:
            return self._run_flush(picked, self._rung_for(total))
        except Exception as e:  # noqa: BLE001 - the serving loop survives
            self._counts["failed"] += len(picked)
            logger.exception("serve flush failed (%d request(s) answered "
                             "Failed)", len(picked))
            t = self._clock()
            return [Failed(rid=r.rid, latency_ms=(t - r.t_submit) * 1e3,
                           reason=repr(e),
                           spans={"queue_wait_ms": (t - r.t_submit) * 1e3})
                    for r in picked]

    def flush(self, now: Optional[float] = None) -> List[ServeResult]:
        """Force every queued request out (drain), regardless of the
        batching delay — shutdown / test helper."""
        del now  # kept for signature symmetry with poll()
        out: List[ServeResult] = []
        while self._queue:
            out.extend(self._flush_picked())
        self._update_level()
        return out

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Counts, latency percentiles over served requests
        (``np.percentile(..., method="lower")``), per-stage latency
        summaries, the aggregate padding fraction and flushes per
        rung."""
        def pct(xs, p):
            return (float(np.percentile(np.asarray(xs), p, method="lower"))
                    if len(xs) else None)

        stages = {}
        for stage in STAGES:
            xs = self._stage_ms[stage]
            if xs:
                stages[stage] = {"p50": pct(xs, 50), "p95": pct(xs, 95),
                                 "p99": pct(xs, 99),
                                 "mean": float(np.mean(xs)),
                                 "sum": float(np.sum(xs)),
                                 "count": len(xs)}
        return {
            **self._counts,
            "level": self._level,
            "level_name": LEVELS[self._level],
            "queued_samples": self._queued_samples,
            "latency_p50_ms": pct(self._lat_ms, 50),
            "latency_p95_ms": pct(self._lat_ms, 95),
            "latency_p99_ms": pct(self._lat_ms, 99),
            "latency_stages_ms": stages,
            "p99_dominant_stage": (max(stages,
                                       key=lambda s: stages[s]["p99"])
                                   if stages else None),
            "pad_fraction": (self._pad_slots / self._total_slots
                             if self._total_slots else 0.0),
            "rung_flushes": {str(k): v
                             for k, v in sorted(self._rung_flushes.items())
                             if v},
        }


# ---------------------------------------------------- load gen + driving


def synthetic_request(rng: np.random.Generator, table_sizes: Sequence[int],
                      n: int, *, numerical: int = 0, alpha: float = 1.05,
                      id_offset: int = 0, priority: int = 0) -> Request:
    """One seeded Zipfian request: ``n`` samples of power-law ids per
    table, plus an ``[n, numerical]`` dense block when ``numerical`` >
    0. Draws from ``rng`` in the same order as the JAX package's
    ``synthetic_request``, so one seed gives both the same stream."""
    cats: List[Any] = [
        np.asarray(power_law_ids(rng, v, (n,), alpha=alpha) + id_offset,
                   np.int32) for v in table_sizes]
    batch = (np.asarray(rng.normal(size=(n, numerical)), np.float32)
             if numerical else None)
    return Request(cats=cats, batch=batch, priority=priority)


def drive(rt: ServingRuntime, make_request: Callable[[int], Request],
          qps: float, duration_s: float, *,
          drain_s: float = 10.0) -> List[ServeResult]:
    """Real-time open-loop load on the calling thread: submit
    ``make_request(i)`` at a fixed ``qps`` for ``duration_s`` seconds,
    polling between arrivals, then drain for up to ``drain_s``. Returns
    every result."""
    clock = rt._clock
    results: List[ServeResult] = []
    start = clock()
    next_t, i = 0.0, 0
    while next_t < duration_s:
        now = clock() - start
        while next_t <= now and next_t < duration_s:
            rej = rt.submit(make_request(i))
            if rej is not None:
                results.append(rej)
            i += 1
            next_t += 1.0 / qps
        results.extend(rt.poll())
        wait = next_t - (clock() - start)
        if wait > 0:
            time.sleep(min(0.0005, wait))  # poll tick, 0.5 ms cap
    deadline = clock() + drain_s
    while rt.queued_samples and clock() < deadline:
        results.extend(rt.poll())
        time.sleep(0.0005)
    results.extend(rt.poll())
    return results
