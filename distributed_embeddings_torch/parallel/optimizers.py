"""Sparse embedding optimizers over width-grouped table slabs, and the
dense half's optimizers (counterpart of
``distributed_embeddings_tpu/parallel/optimizers.py`` and of the
``optax.sgd`` / ``optax.adagrad`` the JAX trainer takes for the dense
parameters).

The optimizers update only the rows a step looked up, IN PLACE on the
slab (and on its slab-shaped state):

* :class:`SparseSGD` through the scatter kernel K3
  (``ops/scatter_add.py``), or K18 for a bfloat16 slab under a tensor
  lr (a schedule: JAX's promoted float32 scatter). Duplicate ids
  scatter-add directly (the update is linear in the gradient, so no
  dedup pass), and ids at or past the slab's rows (the dropped-row
  sentinel included) train nothing. ``DETPU_SGD_DEDUP=1`` forces the
  dedup pass (K5) in first, as in JAX, to compare the two.
* :class:`SparseAdagrad` with slab-shaped accumulators, in one of two
  regimes: dense-apply (K3 scatter-sums the stream into a zero gradient
  slab, then K7 runs the transition over the whole slab) or sparse (K5
  dedups the stream, then K6 updates the unique rows).
* :class:`SparseMomentum` (K5, then K12 on the unique rows) and
  :class:`SparseAdam` (K5, then K11) with LAZY slab-shaped state: only
  the rows a step touches update their trace or moments; an untouched
  row's state neither decays nor moves its row (the reference's Keras
  sparse path, and every production embedding trainer). A row is
  touched exactly when its id is in the dedup's segment set: the port's
  slabs are logical ``[rows, w]``, so no lane mask is needed (the JAX
  package's lane-packed physical rows need one, ``needs_touch_mask``).
  A touched row with a zero gradient still decays. Adam's bias
  correction uses the slab's global step count (LazyAdam).

The dense half's optimizers follow ``optax``'s ``init``/``update``
contract: :class:`SGD` (``optax.sgd``, with ``momentum``/``nesterov``),
:class:`Adagrad` (``optax.adagrad``) and :class:`Adam` (``optax.adam``);
``update`` returns the updates and a NEW state, so the non-finite
guard can keep the old one bitwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..ops.adagrad import adagrad_dense, adagrad_rows
from ..ops.adam import adam_rows, bias_powers
from ..ops.momentum import momentum_rows
from ..ops.scatter_add import Lr, sgd_scatter
from ..ops.sparse_grad import dedup_sparse_grad
from ..utils import envvars

SGD_DEDUP_ENV = "DETPU_SGD_DEDUP"


class SparseSGD:
    """Plain SGD on slab rows: ``slab[ids] -= lr * vals`` in the slab
    dtype, with JAX's rounding chain (see ``ops/scatter_add.py``)."""

    needs_dedup = False
    #: streaming moment hygiene: SGD carries no slab state to reset
    fresh_row_fill = 0.0

    def init(self, params):
        """An empty state per slab."""
        return {k: () for k in params}

    def apply_rows(self, slab: torch.Tensor, state, ids: torch.Tensor,
                   vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` in place from the stream ``ids [n]``,
        ``vals [n, w]``; ids outside ``[-R, R)`` are dropped, negative
        ones count from the end (JAX's indexing). Returns
        ``(slab, state)``."""
        if envvars.enabled(SGD_DEDUP_ENV):
            # the A/B hatch: pre-sum duplicate rows as the stateful
            # optimizers do (K5), then scatter the unique rows with JAX's
            # (-lr * uvals).astype(slab.dtype) (K3's cast_vals=False)
            rows = slab.shape[0]
            ids, vals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                          max_unique=rows + 1)
            sgd_scatter(slab, ids, vals, lr, cast_vals=False)
        else:
            sgd_scatter(slab, ids, vals, lr)
        return slab, state


class SparseAdagrad:
    """Adagrad with slab-shaped accumulators; ``optax.adagrad`` numerics
    (accumulator init 0.1, ``slab -= lr * g * rsqrt(acc_new + eps)``),
    the accumulators in the dtype ``init`` gives them (the slab's).

    Two regimes, chosen per call as in JAX: dense-apply when
    ``n * dense_apply_ratio > slab.shape[0]`` (``n`` the stream's ids),
    sparse otherwise; ``dense_apply_ratio=None`` always takes the sparse
    one. The port's ``slab.shape[0]`` counts LOGICAL rows (the JAX
    package's counts lane-packed physical rows, ``128 // w`` times
    fewer), so a slab the JAX step applies densely may run sparse here.
    The two regimes give the same numbers up to summation order: an
    untouched row sees ``g = 0``, and ``acc + 0 == acc``,
    ``slab - 0 == slab``.

    * dense-apply: K3 scatter-sums the stream into a zero gradient slab
      in the accumulator dtype (with lr -1, exactly), then K7 runs the
      transition elementwise over the whole slab;
    * sparse: K5 sorts and sums duplicate ids (vocab bound: at most
      ``rows + 1`` distinct ids, the sentinel included), then K6 updates
      each unique row.
    """

    needs_dedup = True

    def __init__(self, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, dense_apply_ratio: float = 6.0):
        self.initial_accumulator_value = initial_accumulator_value
        # streaming moment hygiene: a freshly admitted row's accumulator
        # resets to the value a fresh table init gives it
        self.fresh_row_fill = initial_accumulator_value
        self.eps = eps
        self.dense_apply_ratio = dense_apply_ratio

    def init(self, params):
        """One accumulator per slab, ``full_like(slab, 0.1)`` (the slab's
        shape, dtype and device)."""
        return {k: torch.full_like(v, self.initial_accumulator_value)
                for k, v in params.items()}

    def dense_apply(self, rows: int, n: int) -> bool:
        """Whether a stream of ``n`` ids into ``rows`` logical slab rows
        runs the dense-apply regime."""
        return (self.dense_apply_ratio is not None
                and n * self.dense_apply_ratio > rows)

    def apply_rows(self, slab: torch.Tensor, accum: torch.Tensor,
                   ids: torch.Tensor, vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` and ``accum [R, w]`` in place from the
        stream ``ids [n]``, ``vals [n, w]``. Returns ``(slab, accum)``.

        ``vals`` are cast to the accumulator dtype first: with bf16
        tables and fp32 accumulators, ``g * g`` squares in fp32. Ids past
        the slab train nothing; a negative id counts from the end once
        where the row is written (in the sparse regime the accumulator is
        read at row 0 for it, JAX's clip)."""
        vals = vals.to(accum.dtype)
        rows = slab.shape[0]
        if self.dense_apply(rows, ids.shape[0]):
            g = torch.zeros(slab.shape, dtype=accum.dtype,
                            device=slab.device)
            sgd_scatter(g, ids, vals, -1.0)
            adagrad_dense(slab, accum, g, lr, self.eps)
            return slab, accum
        uids, uvals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                        max_unique=rows + 1)
        adagrad_rows(slab, accum, uids, uvals, lr, self.eps)
        return slab, accum


class SparseMomentum:
    """Heavy-ball SGD with lazy row-wise momentum; ``optax.sgd(momentum=m)``
    (``optax.trace``) numerics: ``trace = g + m * trace``, ``slab -= lr *
    trace`` (``nesterov``: ``lr * (g + m * trace_new)``), the trace in
    the dtype ``init`` gives it (the slab's).

    ``needs_dedup=True``: the trace is read-modify-written per row, so
    K5 sums duplicate ids first (at most ``rows + 1`` distinct ids, the
    sentinel included), then K12 updates each unique row."""

    needs_dedup = True
    #: the JAX package lane-masks packed physical rows; logical rows need
    #: no mask (a row is touched exactly when its id is in the dedup's
    #: segment set)
    needs_touch_mask = False
    #: streaming moment hygiene: momentum traces init (and reset) to zero
    fresh_row_fill = 0.0

    def __init__(self, momentum: float = 0.9, nesterov: bool = False):
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params):
        """One zero trace per slab (the slab's shape, dtype and device)."""
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def apply_rows(self, slab: torch.Tensor, trace: torch.Tensor,
                   ids: torch.Tensor, vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` and ``trace [R, w]`` in place from the
        stream ``ids [n]``, ``vals [n, w]`` (cast to the trace dtype
        first). Returns ``(slab, trace)``."""
        vals = vals.to(trace.dtype)
        rows = slab.shape[0]
        uids, uvals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                        max_unique=rows + 1)
        momentum_rows(slab, trace, uids, uvals, lr, self.momentum,
                      self.nesterov)
        return slab, trace


class SparseAdam:
    """Adam with lazy row-wise moments; ``optax.adam`` numerics
    (``mu = b1*mu + (1-b1)*g``, ``nu = b2*nu + (1-b2)*g^2``, corrected by
    the slab's global step count: the LazyAdam convention).

    State per width slab: ``(mu, nu, count)``, the moments in the slab's
    dtype and ``count`` a float32 ``[S, 1, 1]`` for a stacked ``[S, R,
    w]`` slab (``[1, 1]`` for a 2-D one), so it strips and re-adds the
    world axis with the slabs (``DistributedEmbedding.local_view``). The
    count advances once per ``apply_rows`` call, in place, even when the
    whole stream is the dropped-row sentinel (a guarded step restores
    it, ``parallel/trainer.py``). K5 sums duplicate ids, then K11 updates
    each unique row, reading the count on the card."""

    needs_dedup = True
    #: as :class:`SparseMomentum`: logical rows need no lane mask
    needs_touch_mask = False
    #: streaming moment hygiene: mu/nu init (and reset) to zero; the
    #: non-slab step count is never touched
    fresh_row_fill = 0.0

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root

    def init(self, params):
        """``(zeros_like(slab), zeros_like(slab), count 0)`` per slab."""
        def one(p):
            shape = (p.shape[0], 1, 1) if p.dim() == 3 else (1, 1)
            return (torch.zeros_like(p), torch.zeros_like(p),
                    torch.zeros(shape, dtype=torch.float32,
                                device=p.device))
        return {k: one(v) for k, v in params.items()}

    def apply_rows(self, slab: torch.Tensor, state, ids: torch.Tensor,
                   vals: torch.Tensor, lr: Lr):
        """Update ``slab [R, w]`` and its ``(mu, nu, count)`` in place from
        the stream ``ids [n]``, ``vals [n, w]`` (cast to the moments'
        dtype first). Returns ``(slab, (mu, nu, count))``."""
        mu, nu, count = state
        vals = vals.to(mu.dtype)
        rows = slab.shape[0]
        uids, uvals = dedup_sparse_grad(ids, vals, pad_id=rows,
                                        max_unique=rows + 1)
        count.add_(1.0)
        adam_rows(slab, mu, nu, count, uids, uvals, lr, self.b1, self.b2,
                  self.eps, self.eps_root)
        return slab, (mu, nu, count)


Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class TraceState(NamedTuple):
    """``optax.trace``'s state: one trace per parameter."""
    trace: Tuple[torch.Tensor, ...]


class ScheduleState(NamedTuple):
    """``optax.scale_by_schedule``'s state: the int32 count the
    schedule is evaluated at (0 first)."""
    count: torch.Tensor


class AdamState(NamedTuple):
    """``optax.scale_by_adam``'s state: the int32 update count and one
    ``mu``, ``nu`` per parameter."""
    count: torch.Tensor
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


def _schedule_init(learning_rate: Schedule, params):
    """``(ScheduleState,)`` for a callable lr, ``()`` for a constant."""
    if not callable(learning_rate):
        return ()
    dev = params[0].device if params else None
    return (ScheduleState(torch.zeros((), dtype=torch.int32, device=dev)),)


def _scale_by_lr(learning_rate: Schedule, updates, sched):
    """``optax.scale_by_learning_rate``: ``-lr * u`` with a constant lr
    (rounded to each update's dtype); with a schedule, ``-lr(count)``
    cast to each update's dtype times ``u``, and the count advanced.
    Returns ``(updates, sched)``."""
    if not callable(learning_rate):
        return [u * -learning_rate for u in updates], sched
    (st,) = sched
    step_size = -learning_rate(st.count)
    return ([step_size.to(u.dtype) * u for u in updates],
            (ScheduleState(st.count + 1),))


class SGD:
    """Counterpart of ``optax.sgd(learning_rate, momentum, nesterov)``
    for the dense parameters. ``learning_rate`` is a float or a ``count
    -> lr`` schedule (a 0-d float32 tensor on the count's device, e.g.
    ``models/schedules.py``). The state is optax's chain without its
    empty parts: ``()`` for plain SGD, a :class:`TraceState` when
    ``momentum`` is set, then a :class:`ScheduleState` for a schedule.
    ``update`` returns the updates (``trace = g + m * trace``; the step
    is the trace, or ``g + m * trace_new`` with ``nesterov``; times
    ``-lr``) and a NEW state."""

    def __init__(self, learning_rate: Schedule,
                 momentum: Optional[float] = None, nesterov: bool = False):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Sequence[torch.Tensor]):
        params = list(params)
        state = ()
        if self.momentum is not None:
            state = (TraceState(tuple(torch.zeros_like(p.detach())
                                      for p in params)),)
        return state + _schedule_init(self.learning_rate, params)

    def update(self, grads: Sequence[torch.Tensor], state, params=None):
        grads = list(grads)
        head = ()
        if self.momentum is not None:
            m = self.momentum
            trace = tuple(g + m * t for g, t in zip(grads, state[0].trace))
            grads = ([g + m * t for g, t in zip(grads, trace)]
                     if self.nesterov else list(trace))
            head, state = (TraceState(trace),), state[1:]
        updates, sched = _scale_by_lr(self.learning_rate, grads, state)
        return updates, head + tuple(sched)


class Adagrad:
    """Counterpart of ``optax.adagrad(learning_rate)`` for the dense
    parameters (``scale_by_rss`` then ``-learning_rate``): the state is
    one sum of squares per parameter, initialized to
    ``initial_accumulator_value``; ``update`` returns the updates
    ``-lr * g * rsqrt(s + eps)`` (0 where ``s`` is 0) and a NEW state,
    so a skipped step can keep the old one bitwise."""

    def __init__(self, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.learning_rate = float(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]):
        return tuple(torch.full_like(p.detach(),
                                     self.initial_accumulator_value)
                     for p in params)

    def update(self, grads: Sequence[torch.Tensor], state, params=None):
        new_state = tuple(g * g + s for g, s in zip(grads, state))
        updates = [torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0) * g
                   * -self.learning_rate for g, s in zip(grads, new_state)]
        return updates, new_state



class Adam:
    """Counterpart of ``optax.adam(learning_rate, b1, b2, eps,
    eps_root)`` for the dense parameters (``scale_by_adam``, then
    ``-learning_rate``; a float or a schedule as :class:`SGD` takes).
    The state is ``(AdamState(count, mu, nu),)``, then a
    :class:`ScheduleState` for a schedule; ``update`` computes, in
    optax's order, ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g^2 +
    b2*nu``, the int32 count advanced, ``u = (mu / (1 - b1**count)) /
    (sqrt(nu / (1 - b2**count) + eps_root) + eps)`` and the lr scaling,
    and returns the updates and a NEW state."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root

    def init(self, params: Sequence[torch.Tensor]):
        params = list(params)
        dev = params[0].device if params else None
        zeros = tuple(torch.zeros_like(p.detach()) for p in params)
        return (AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros, tuple(torch.zeros_like(z) for z in zeros)),
                ) + _schedule_init(self.learning_rate, params)

    def update(self, grads: Sequence[torch.Tensor], state, params=None):
        st = state[0]
        b1, b2 = self.b1, self.b2
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, st.mu))
        nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, st.nu))
        count = st.count + 1
        bc = 1.0 - bias_powers(count, b1, b2)
        updates = [(m / bc[0].to(m.dtype))
                   / (torch.sqrt(v / bc[1].to(v.dtype) + self.eps_root)
                      + self.eps) for m, v in zip(mu, nu)]
        updates, sched = _scale_by_lr(self.learning_rate, updates,
                                      state[1:])
        return updates, (AdamState(count, mu, nu),) + tuple(sched)
