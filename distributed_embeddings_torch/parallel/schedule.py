"""The explicit step schedule: named phases, declared ordering, declared
overlap (the port's copy of ``distributed_embeddings_tpu/parallel/
schedule.py``, kept line for line so both packages name the same phases
and declare the same schedules).

The hybrid step is a fixed chain of phases: id exchange, lookup, output
exchange, dense forward/backward, gradient exchange, sparse apply. Each
phase has a **name** that doubles as its :func:`~..utils.obs.scope`
label (``detpu/<name>`` in a ``torch.profiler`` trace), and a
:class:`StepSchedule` declares, per phase, what it must run **after**
and what it claims to **overlap** with. In the JAX package a schedule
auditor checks the declared overlaps against the compiled program; the
port has no compiled program to audit, so here the declarations are
data: the trainer reads the microbatch count, the executors take their
scope names from the constants below, and the tests hold the
declarations to the JAX package's.

:func:`default_schedule` is the serialized step (every collective
declares ``overlaps=()``); :func:`pipelined_schedule` is the
K-microbatch step of :func:`~.trainer._pipelined_local_step`, whose
exchanges stay in flight under other microbatches' lookups and dense
compute.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from ..utils import envvars

# ---------------------------------------------------------------- phase names
# These strings ARE the obs.scope labels of the step (``detpu/<name>``
# in a profiler trace). Globs (trailing ``*``) name phase FAMILIES that
# expand per width group when the step runs.

#: dp→mp id all-to-all (block assembly + the collective)
PHASE_ID_EXCHANGE = "id_all_to_all"
#: per-(width, kind) gather+combine groups — ``lookup_w{w}_{kind}``
PHASE_LOOKUP = "lookup_*"
#: mp→dp activation all-to-all
PHASE_OUT_EXCHANGE = "out_all_to_all"
#: the dense model's forward + backward (trainer scope)
PHASE_DENSE = "dense_forward_backward"
#: reverse (cotangent) all-to-all
PHASE_GRAD_EXCHANGE = "grad_all_to_all"
#: per-width optimizer scatter streams — ``sparse_apply`` and
#: ``sparse_apply_w{k}``
PHASE_APPLY = "sparse_apply*"
#: streaming-vocab admission staging — the count-min fold + claim
#: resolution chain (``streaming_admit_w{w}``), consumed only at commit,
#: so it depends on neither the out nor the grad exchange
PHASE_STREAM_ADMIT = "streaming_admit_*"
#: streaming-vocab commit — post-apply slot-map select + claimed-row
#: scrub (``streaming_commit`` / ``streaming_commit_w{w}``)
PHASE_STREAM_COMMIT = "streaming_commit*"
#: per-microbatch slot-map SERVE remap of the pipelined streaming step
#: (``streaming_serve_w{w}_mb{k}``) — read-only against the carried
#: slot map, so each microbatch's lookup depends only on its own id
#: exchange, never on the admission staging
PHASE_STREAM_SERVE = "streaming_serve_*"

#: scope-name suffix of microbatch ``k``'s phase instances in a
#: pipelined step (``id_all_to_all_mb0``, ``lookup_w8_d_mb1``, ...)
MICROBATCH_TAG = "_mb{k}"


def microbatch_tag(k: int) -> str:
    """The scope suffix the executors append for microbatch ``k``."""
    return MICROBATCH_TAG.format(k=k)


def mb_phase(name: str, k: int) -> str:
    """Microbatch ``k``'s instance of a phase name. Glob families keep
    their trailing ``*`` AFTER the suffix (``lookup_*`` ->
    ``lookup_*_mb0``) so ``lookup_w8_d_mb0`` still matches."""
    tag = microbatch_tag(k)
    if name.endswith("*"):
        return name.rstrip("*") + "*" + tag
    return name + tag


class ScheduleError(ValueError):
    """An inconsistent :class:`StepSchedule` declaration."""


@dataclasses.dataclass(frozen=True)
class PhaseDecl:
    """One named phase of the step schedule.

    ``name`` is the ``obs.scope`` label (an ``fnmatch`` glob for phase
    families like ``lookup_*``). ``kind`` is ``"collective"`` (pays ICI
    bandwidth) or ``"compute"`` (pays HBM bandwidth). ``after`` lists the
    phases that must have produced this phase's inputs — the declared
    dependency order. ``overlaps`` lists the phases this one CLAIMS to
    run concurrently with (in the port, data the tests hold to the JAX
    package's declaration)."""

    name: str
    kind: str = "compute"
    after: Tuple[str, ...] = ()
    overlaps: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.kind not in ("collective", "compute"):
            raise ScheduleError(
                f"phase {self.name!r}: kind must be 'collective' | "
                f"'compute', got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """A named, ordered set of :class:`PhaseDecl`\\ s.

    Declaration order is execution order for the serialized portions of
    the step; ``validate()`` (run on construction) checks the references
    and rejects ordering cycles, self-overlap, and overlap claims that
    contradict the declared ``after`` chain (a phase cannot overlap a
    phase it depends on)."""

    name: str
    phases: Tuple[PhaseDecl, ...]
    #: microbatch count the trainer splits the step into (1 = the
    #: serialized, unpipelined step). Carried on the schedule so the
    #: one ``schedule=`` selection drives both the declaration and the
    #: step the trainer runs.
    microbatches: int = 1

    def __post_init__(self) -> None:
        if int(self.microbatches) < 1:
            raise ScheduleError(
                f"schedule {self.name!r}: microbatches must be >= 1, got "
                f"{self.microbatches}")
        self.validate()

    # -- introspection ----------------------------------------------------
    def by_name(self) -> Dict[str, PhaseDecl]:
        return {p.name: p for p in self.phases}

    def phase(self, name: str) -> PhaseDecl:
        try:
            return self.by_name()[name]
        except KeyError:
            raise ScheduleError(
                f"schedule {self.name!r} declares no phase {name!r} "
                f"(has: {[p.name for p in self.phases]})") from None

    def collectives(self) -> Tuple[PhaseDecl, ...]:
        return tuple(p for p in self.phases if p.kind == "collective")

    def declared_overlaps(self) -> Tuple[Tuple[str, str], ...]:
        """Every (phase, partner) overlap claim, in declaration order."""
        return tuple((p.name, q) for p in self.phases for q in p.overlaps)

    def depends_on(self, name: str, other: str) -> bool:
        """Whether phase ``name`` transitively runs after ``other``."""
        decls = self.by_name()
        seen = set()
        stack = [name]
        while stack:
            cur = stack.pop()
            if cur in seen or cur not in decls:
                continue
            seen.add(cur)
            for dep in decls[cur].after:
                if dep == other:
                    return True
                stack.append(dep)
        return False

    # -- validation -------------------------------------------------------
    def validate(self) -> "StepSchedule":
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ScheduleError(
                f"schedule {self.name!r}: duplicate phase name(s) {dup}")
        known = set(names)
        for p in self.phases:
            for ref in p.after + p.overlaps:
                if ref not in known:
                    raise ScheduleError(
                        f"schedule {self.name!r}: phase {p.name!r} "
                        f"references undeclared phase {ref!r}")
            if p.name in p.overlaps:
                raise ScheduleError(
                    f"schedule {self.name!r}: phase {p.name!r} cannot "
                    "overlap itself")
        # cycle check over the `after` relation (iterative DFS)
        decls = self.by_name()
        color: Dict[str, int] = {}  # 0 in-stack, 1 done

        def visit(root: str) -> None:
            stack = [(root, iter(decls[root].after))]
            color[root] = 0
            while stack:
                node, it = stack[-1]
                dep = next(it, None)
                if dep is None:
                    color[node] = 1
                    stack.pop()
                    continue
                c = color.get(dep)
                if c == 0:
                    chain = [n for n, _ in stack] + [dep]
                    raise ScheduleError(
                        f"schedule {self.name!r}: ordering cycle "
                        f"{' -> '.join(chain)}")
                if c is None:
                    color[dep] = 0
                    stack.append((dep, iter(decls[dep].after)))

        for n in names:
            if n not in color:
                visit(n)
        # an overlap claim against a phase this phase (transitively)
        # depends on is self-contradictory: the data dependency forces
        # serialization regardless of what the compiler does
        for p in self.phases:
            for q in p.overlaps:
                if self.depends_on(p.name, q) or self.depends_on(q, p.name):
                    raise ScheduleError(
                        f"schedule {self.name!r}: phase {p.name!r} "
                        f"declares overlap with {q!r} but the `after` "
                        "chain orders them — a data dependency cannot "
                        "overlap")
        return self


def default_schedule() -> StepSchedule:
    """The serialized schedule of the hybrid step.

    The three all-to-alls sit strictly between their producers and
    consumers, and no phase claims overlap: what the unpipelined step
    does."""
    return StepSchedule(
        name="serialized-v1",
        phases=(
            PhaseDecl(PHASE_ID_EXCHANGE, kind="collective"),
            PhaseDecl(PHASE_LOOKUP, kind="compute",
                      after=(PHASE_ID_EXCHANGE,)),
            PhaseDecl(PHASE_OUT_EXCHANGE, kind="collective",
                      after=(PHASE_LOOKUP,)),
            PhaseDecl(PHASE_DENSE, kind="compute",
                      after=(PHASE_OUT_EXCHANGE,)),
            PhaseDecl(PHASE_GRAD_EXCHANGE, kind="collective",
                      after=(PHASE_DENSE,)),
            PhaseDecl(PHASE_APPLY, kind="compute",
                      after=(PHASE_GRAD_EXCHANGE,)),
        ))


def streaming_schedule() -> StepSchedule:
    """The serialized streaming-vocab schedule, with the one overlap
    the serialized step has: the admission-staging chain (count-min fold
    + claim resolution, ``streaming_admit_w*``) branches off the received
    ids and is consumed only at commit, so it depends on neither the out
    nor the grad exchange. The lookup's dependency on the SERVE half of
    the remap (the slot-map reads feeding the remapped ids) is not
    declared, as in the JAX package."""
    return StepSchedule(
        name="streaming-serialized-v1",
        phases=(
            PhaseDecl(PHASE_ID_EXCHANGE, kind="collective"),
            PhaseDecl(PHASE_STREAM_ADMIT, kind="compute",
                      after=(PHASE_ID_EXCHANGE,)),
            PhaseDecl(PHASE_LOOKUP, kind="compute",
                      after=(PHASE_ID_EXCHANGE,)),
            PhaseDecl(PHASE_OUT_EXCHANGE, kind="collective",
                      after=(PHASE_LOOKUP,),
                      overlaps=(PHASE_STREAM_ADMIT,)),
            PhaseDecl(PHASE_DENSE, kind="compute",
                      after=(PHASE_OUT_EXCHANGE,)),
            PhaseDecl(PHASE_GRAD_EXCHANGE, kind="collective",
                      after=(PHASE_DENSE,),
                      overlaps=(PHASE_STREAM_ADMIT,)),
            PhaseDecl(PHASE_APPLY, kind="compute",
                      after=(PHASE_GRAD_EXCHANGE,)),
            PhaseDecl(PHASE_STREAM_COMMIT, kind="compute",
                      after=(PHASE_APPLY, PHASE_STREAM_ADMIT)),
        ))


def resolve_microbatches(k: Optional[int] = None) -> int:
    """The microbatch count: an explicit ``k`` wins, else
    ``DETPU_MICROBATCH`` (declared default 2: only pipelined-schedule
    opt-ins resolve through here, and asking for a pipeline must build
    one; ``DETPU_MICROBATCH=1`` or an explicit ``k=1`` selects the
    serialized schedule)."""
    if k is None:
        k = envvars.get_int("DETPU_MICROBATCH")
    k = int(k)
    if k < 1:
        raise ScheduleError(f"microbatches must be >= 1, got {k}")
    return k


def pipelined_schedule(microbatches: Optional[int] = None,
                       streaming: bool = False) -> StepSchedule:
    """The K-microbatch pipelined schedule.

    The per-rank batch splits into K microbatches; each runs its own id
    exchange -> lookup -> out exchange -> dense fwd/bwd chain (phase
    instances suffixed ``_mb{k}``), gradients accumulate across
    microbatches, and ONE sparse apply runs at the end, so the applied
    update is the serialized step's up to float summation order while
    the K chains share no data until the accumulation point. That
    independence is what the declared overlaps claim:

    * microbatch ``k``'s id and out exchanges overlap the other
      microbatches' lookups and dense forward/backward;
    * microbatch ``k``'s grad exchange overlaps the same (drain
      cotangents under later compute);
    * with ``streaming=True`` the out and grad exchanges also overlap the
      one admission-staging pass.

    ``microbatches=None`` resolves K from ``DETPU_MICROBATCH``; K == 1
    returns the serialized schedule unchanged (the trainer then runs the
    serialized step, launch for launch). ``streaming=True`` adds the
    streaming-vocab phases: per-microbatch read-only slot-map serves
    (``streaming_serve_*_mb{k}``), ONE admission-staging pass over the
    concatenated id streams (the serialized staging decisions), and the
    post-apply commit."""
    K = resolve_microbatches(microbatches)
    if K == 1:
        return streaming_schedule() if streaming else default_schedule()

    def dense(k: int) -> str:
        return mb_phase(PHASE_DENSE, k)

    def chain(j: int) -> Tuple[str, str]:
        """Microbatch ``j``'s hideable compute: its lookup gathers and
        its dense forward/backward."""
        return (mb_phase(PHASE_LOOKUP, j), dense(j))

    phases = []
    for k in range(K):
        id_k = mb_phase(PHASE_ID_EXCHANGE, k)
        lookup_k = mb_phase(PHASE_LOOKUP, k)
        out_k = mb_phase(PHASE_OUT_EXCHANGE, k)
        grad_k = mb_phase(PHASE_GRAD_EXCHANGE, k)
        # the partners a collective hides under: every OTHER
        # microbatch's lookup + dense chain (none of it shares data with
        # this microbatch's exchanges before the accumulation point)
        others = tuple(p for j in range(K) if j != k for p in chain(j))
        fwd_partner = others
        bwd_partner = others
        admit = (PHASE_STREAM_ADMIT,) if streaming else ()
        lookup_after = (id_k,)
        phases.append(PhaseDecl(id_k, kind="collective",
                                overlaps=fwd_partner))
        if streaming:
            serve_k = mb_phase(PHASE_STREAM_SERVE, k)
            phases.append(PhaseDecl(serve_k, kind="compute",
                                    after=(id_k,)))
            lookup_after = (id_k, serve_k)
        phases.append(PhaseDecl(lookup_k, kind="compute",
                                after=lookup_after))
        phases.append(PhaseDecl(out_k, kind="collective",
                                after=(lookup_k,),
                                overlaps=fwd_partner + admit))
        phases.append(PhaseDecl(dense(k), kind="compute",
                                after=(out_k,)))
        phases.append(PhaseDecl(grad_k, kind="collective",
                                after=(dense(k),),
                                overlaps=bwd_partner + admit))
    if streaming:
        phases.append(PhaseDecl(
            PHASE_STREAM_ADMIT, kind="compute",
            after=tuple(mb_phase(PHASE_ID_EXCHANGE, k)
                        for k in range(K))))
    phases.append(PhaseDecl(
        PHASE_APPLY, kind="compute",
        after=tuple(mb_phase(PHASE_GRAD_EXCHANGE, k) for k in range(K))))
    if streaming:
        phases.append(PhaseDecl(
            PHASE_STREAM_COMMIT, kind="compute",
            after=(PHASE_APPLY, PHASE_STREAM_ADMIT)))
    return StepSchedule(
        name=f"pipelined-k{K}" + ("-streaming" if streaming else ""),
        phases=tuple(phases), microbatches=K)


def without_streaming(schedule: StepSchedule) -> StepSchedule:
    """The non-streaming twin of a schedule that declares streaming
    phases: what a step built WITHOUT ``dynamic=`` on a
    streaming-capable layer runs. Schedules without streaming
    declarations pass through unchanged."""
    streamy = (PHASE_STREAM_ADMIT, PHASE_STREAM_COMMIT,
               PHASE_STREAM_SERVE)
    if not any(p.name in streamy or p.name.startswith("streaming_serve")
               for p in schedule.phases):
        return schedule
    if schedule.microbatches > 1:
        return pipelined_schedule(schedule.microbatches, streaming=False)
    return default_schedule()


def resolve_schedule(spec: Union[None, str, StepSchedule] = None,
                     streaming: bool = False) -> StepSchedule:
    """Normalize :class:`~.dist_embedding.DistributedEmbedding`'s
    ``schedule=`` argument: ``None``/``"serialized"`` is the serialized
    schedule (the streaming declaration included when the layer has
    dynamic tables), ``"pipelined"`` builds :func:`pipelined_schedule`
    with ``DETPU_MICROBATCH``'s K, and a :class:`StepSchedule` passes
    through as it is."""
    if spec is None or spec == "serialized":
        return streaming_schedule() if streaming else default_schedule()
    if spec == "pipelined":
        return pipelined_schedule(streaming=streaming)
    if isinstance(spec, StepSchedule):
        return spec
    raise ScheduleError(
        f"schedule= takes None | 'serialized' | 'pipelined' | a "
        f"StepSchedule, got {spec!r}")
