"""The K-microbatch pipelined hybrid step of the port against the JAX
package (the port of ``tests/test_pipeline.py``).

* **The schedule**: ``parallel/schedule.py``'s declarations (phase names,
  kinds, ``after``, ``overlaps``, the microbatch count) equal the JAX
  package's for K in {1, 2, 4}, streaming on and off; ``resolve_schedule``
  takes each of its forms; ``DETPU_MICROBATCH`` picks K; ``mb_phase``
  globs. Control: one overlap dropped fails the comparison.
* **``_microbatch_inputs``** on JAX's ragged case (and a ``SparseIds``
  twin): bitwise JAX's slices; ``ValueError`` at K = 3. Control: the
  row splits left unrebased fail the comparison.
* **The A/B matrix**: JAX's ten cases (dense, ragged, row-sliced and
  streaming tables; world 1 and world 8; SGD, Adagrad and Adam; metrics
  and telemetry on and off). Each runs the port's pipelined K = 2 step
  against (a) JAX's pipelined K = 2 step on the same numpy tables, dense
  weights and ids and (b) the port's serialized step: losses and tables
  within JAX's rtol 2e-5 / atol 2e-6, the telemetry and streaming state
  and the integer metrics bitwise. World 8 runs in eight gloo ranks
  (``torch_dist_worker.py``, one group for the file) against JAX's
  8-device CPU mesh. Controls: the sparse apply scaled by ``1/world``
  (not ``1/(world K)``) fails the float bound; the admission stage given
  only the last microbatch's streaming stream fails the integer bound.
  Staged in reversed microbatch order, the state keeps every bit (K16's
  claims do not depend on the stream's order).
* **Exact accumulation**: integer tables, a duplicate id across the
  microbatch boundary: K = 2 bitwise the serialized step and JAX's.
  Control: the ``1/world`` scale.
* **K = 1** (``pipelined_schedule(1)``) is the serialized step: the same
  phases, the same kernel call sites called as often, bitwise the same
  state. ``dp_input=False`` with a pipelined schedule raises
  ``NotImplementedError``.
* **The order of work** (the port's phase scopes, ``obs.phase_log``):
  microbatch 1's id and out exchanges start before microbatch 0's dense
  forward/backward and are waited for after it; every grad exchange is
  in flight across the telemetry fold, the admission stage and the
  all-reduce. Control: the exchanges waited for as they start.
"""

import fnmatch
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.ops.embedding_lookup import Ragged as JRagged
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import schedule as jsched
from distributed_embeddings_tpu.parallel import streaming as jstream
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdagrad as JAdagrad, SparseAdam as JAdam, SparseSGD as JSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    _microbatch_inputs as jax_microbatch_inputs, make_hybrid_train_step)

from distributed_embeddings_torch.ops.embedding_lookup import (
    Ragged, SparseIds)
from distributed_embeddings_torch.parallel import DistributedEmbedding
from distributed_embeddings_torch.parallel import schedule as tsched
from distributed_embeddings_torch.parallel import trainer as ttrainer
from distributed_embeddings_torch.utils import envvars

from torch_dist_worker import RankGroup, pipe_loss, pipeline_run  # noqa

torch.set_num_threads(1)

WORLD = 8
RTOL, ATOL = 2e-5, 2e-6  # JAX's bounds (tests/test_pipeline.py)


# ------------------------------------------------------------- schedules


def _decl(sched):
    return (sched.name, sched.microbatches,
            tuple((p.name, p.kind, p.after, p.overlaps)
                  for p in sched.phases))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("streaming", [False, True])
def test_schedule_equals_jax(K, streaming):
    want = _decl(jsched.pipelined_schedule(K, streaming=streaming))
    assert _decl(tsched.pipelined_schedule(K, streaming=streaming)) == want
    # the control: one declared overlap dropped must fail the comparison
    p = tsched.pipelined_schedule(K, streaming=streaming)
    phases = list(p.phases)
    i = next((j for j, ph in enumerate(phases) if ph.overlaps), None)
    if i is None:  # K = 1 without streaming declares none: drop a phase
        phases.pop()
    else:
        phases[i] = tsched.PhaseDecl(phases[i].name, phases[i].kind,
                                     phases[i].after, phases[i].overlaps[1:])
    bad = tsched.StepSchedule(p.name, tuple(phases), p.microbatches)
    assert _decl(bad) != want
    for fn in ("default_schedule", "streaming_schedule"):
        assert _decl(getattr(tsched, fn)()) == _decl(getattr(jsched, fn)())
    assert (_decl(tsched.without_streaming(
        tsched.pipelined_schedule(K, streaming=True)))
        == _decl(jsched.without_streaming(
            jsched.pipelined_schedule(K, streaming=True))))


def test_schedule_forms_env_and_globs(monkeypatch):
    assert tsched.pipelined_schedule(1).name == tsched.default_schedule().name
    assert (tsched.pipelined_schedule(1, streaming=True).name
            == tsched.streaming_schedule().name)
    assert tsched.resolve_schedule(None).name == "serialized-v1"
    assert (tsched.resolve_schedule("serialized", streaming=True).name
            == "streaming-serialized-v1")
    sched = tsched.pipelined_schedule(2)
    assert tsched.resolve_schedule(sched) is sched
    with pytest.raises(tsched.ScheduleError):
        tsched.resolve_schedule("bogus")
    monkeypatch.delenv("DETPU_MICROBATCH", raising=False)
    assert envvars.get("DETPU_MICROBATCH") == "2"  # the declared default
    assert tsched.resolve_schedule("pipelined").microbatches == 2
    monkeypatch.setenv("DETPU_MICROBATCH", "4")
    assert tsched.pipelined_schedule().microbatches == 4
    configs = [{"input_dim": 32, "output_dim": 4, "combiner": "sum"}] * 8
    assert DistributedEmbedding(configs, WORLD,
                                schedule="pipelined").schedule.microbatches \
        == 4
    # the plain default stays serialized whatever the variable says
    assert DistributedEmbedding(configs, WORLD).schedule.microbatches == 1
    monkeypatch.setenv("DETPU_MICROBATCH", "0")
    with pytest.raises(tsched.ScheduleError):
        tsched.pipelined_schedule()
    assert tsched.mb_phase("lookup_*", 0) == "lookup_*_mb0"
    assert tsched.mb_phase(tsched.PHASE_ID_EXCHANGE, 3) == \
        "id_all_to_all_mb3"
    assert fnmatch.fnmatchcase("lookup_w8_d_mb0", "lookup_*_mb0")
    assert not fnmatch.fnmatchcase("lookup_w8_d_mb10", "lookup_*_mb1")
    with pytest.raises(tsched.ScheduleError, match="cycle"):
        tsched.StepSchedule("c", (tsched.PhaseDecl("a", after=("b",)),
                                  tsched.PhaseDecl("b", after=("a",))))


# ------------------------------------------------------ microbatch slicing


def _mb_equal(port, want):
    """Whether the port's microbatches equal JAX's bit for bit."""
    if len(port) != len(want):
        return False
    for (pc, pb), (wc, wb) in zip(port, want):
        for p, w in zip(pc, wc):
            if isinstance(w, JRagged):
                for a, b in ((p.values, w.values),
                             (p.row_splits, w.row_splits),
                             (p.weights, w.weights)):
                    if (a is None) != (b is None) or (
                            a is not None and not np.array_equal(
                                a.numpy(), np.asarray(b))):
                        return False
            elif not np.array_equal(p.numpy(), np.asarray(w)):
                return False
        if not all(np.array_equal(a.numpy(), np.asarray(b))
                   for a, b in zip(pb, wb)):
            return False
    return True


def test_microbatch_inputs_bitwise_jax():
    splits = np.asarray([0, 2, 3, 3, 6], np.int32)
    values = np.asarray([10, 11, 20, 30, 31, 32, 0, 0], np.int32)
    weights = np.linspace(0.5, 4.0, 8).astype(np.float32)
    dense = np.arange(4, dtype=np.int32)
    batch = (np.arange(8, dtype=np.float32).reshape(4, 2),
             np.arange(4, dtype=np.float32))
    want = jax_microbatch_inputs(
        [JRagged(values=jnp.asarray(values), row_splits=jnp.asarray(splits),
                 weights=jnp.asarray(weights)), jnp.asarray(dense)],
        tuple(jnp.asarray(b) for b in batch), 2)
    got = ttrainer._microbatch_inputs(
        [Ragged(values=torch.from_numpy(values),
                row_splits=torch.from_numpy(splits),
                weights=torch.from_numpy(weights)),
         torch.from_numpy(dense)],
        tuple(torch.from_numpy(b) for b in batch), 2)
    assert _mb_equal(got, want)
    np.testing.assert_array_equal(got[1][0][0].row_splits, [0, 0, 3])
    np.testing.assert_array_equal(got[1][0][0].values[:3], [30, 31, 32])
    # a COO batch goes to CSR first (row_to_split), as JAX's does
    rows = np.repeat(np.arange(4), np.diff(splits)).astype(np.int32)
    coo = SparseIds(indices=torch.from_numpy(rows),
                    values=torch.from_numpy(values[:6]), dense_shape=(4, 3))
    from distributed_embeddings_tpu.ops.embedding_lookup import (
        SparseIds as JSparseIds)
    jcoo = JSparseIds(indices=jnp.asarray(rows),
                      values=jnp.asarray(values[:6]), dense_shape=(4, 3))
    assert _mb_equal(
        ttrainer._microbatch_inputs([coo], (torch.from_numpy(batch[0]),),
                                    2),
        jax_microbatch_inputs([jcoo], (jnp.asarray(batch[0]),), 2))
    # the control: row splits left unrebased must fail the comparison
    (r1, d1), b1 = got[1]
    bad = list(got)
    bad[1] = ([Ragged(values=r1.values,
                      row_splits=r1.row_splits + int(splits[2]),
                      weights=r1.weights), d1], b1)
    assert not _mb_equal(bad, want)
    with pytest.raises(ValueError, match="divide"):
        ttrainer._microbatch_inputs([torch.from_numpy(dense)], batch, 3)


# --------------------------------------------------------- the A/B matrix


def _case_configs(name):
    """``tests/test_pipeline.py:_build_case``: ``(kwargs, configs,
    streaming)``."""
    if name == "dense":
        configs = [{"input_dim": 20 + 6 * i, "output_dim": 4,
                    "combiner": ["sum", None, "mean"][i % 3]}
                   for i in range(10)]
        return {}, configs, False
    if name == "ragged":
        configs = [{"input_dim": 40 + 7 * i, "output_dim": 8,
                    "combiner": "sum" if i % 2 else "mean"}
                   for i in range(8)]
        return {}, configs, False
    if name == "row_sliced":
        configs = [{"input_dim": 100 if i % 3 == 0 else 20 + i,
                    "output_dim": 8,
                    "combiner": [None, "sum", "mean"][i % 3]}
                   for i in range(9)]
        return {"row_slice": 100 * 8 // 4 + 1}, configs, False
    configs = [{"input_dim": 20 + 6 * i, "output_dim": 4,
                "combiner": ["sum", None, "mean"][i % 3]} for i in range(9)]
    configs.append({"input_dim": 512 + 64, "output_dim": 4,
                    "combiner": "sum",
                    "streaming": {"capacity": 512, "buckets": 64}})
    return {}, configs, True


def make_spec(name, world, opt, metrics, telemetry=False, batch=64,
              steps=3):
    """One A/B case as numpy (``tests/test_pipeline.py:_make_inputs``'s
    draws, in its order), plus the tables both packages start from."""
    kwargs, configs, streaming = _case_configs(name)
    rng = np.random.default_rng(7)
    local_b = batch // world
    inputs = []
    for cfg in configs:
        if name == "ragged":
            vals_all, splits_all = [], []
            cap = local_b * 4
            for _ in range(world):
                hots = rng.integers(0, 5, size=local_b)
                splits = np.zeros(local_b + 1, np.int32)
                np.cumsum(hots, out=splits[1:])
                vals = np.zeros(cap, np.int32)
                nnz = int(splits[-1])
                vals[:nnz] = rng.integers(0, cfg["input_dim"], size=nnz)
                vals_all.append(vals)
                splits_all.append(splits)
            inputs.append(("ragged", vals_all, splits_all, None))
            continue
        hot = 1 if cfg["combiner"] is None else 3
        shape = (batch,) if hot == 1 else (batch, hot)
        hi = (16 * cfg["streaming"]["capacity"] if "streaming" in cfg
              else cfg["input_dim"])
        inputs.append(rng.integers(0, hi, size=shape).astype(np.int32))
    n = rng.normal(size=(batch, 13)).astype(np.float32)
    y = rng.normal(size=(batch, 1)).astype(np.float32)
    cols = sum(c["output_dim"] for c in configs)
    w = (rng.normal(size=(cols, 1)) * 0.1).astype(np.float32)
    v = (rng.normal(size=(13, 1)) * 0.1).astype(np.float32)
    trng = np.random.default_rng(11)
    tables = [trng.uniform(-0.05, 0.05, size=(c["input_dim"],
                                              c["output_dim"]))
              .astype(np.float32) for c in configs]
    return dict(configs=configs, row_slice=kwargs.get("row_slice"),
                streaming=streaming, telemetry=telemetry, metrics=metrics,
                opt=opt, tables=tables, inputs=inputs, n=n, y=y, w=w, v=v,
                lr=0.3, dense_lr=0.5, steps=steps)


@functools.lru_cache(maxsize=None)
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _jax_inputs(spec):
    out = []
    for x in spec["inputs"]:
        if isinstance(x, tuple):
            out.append(JRagged(values=jnp.asarray(np.concatenate(x[1])),
                               row_splits=jnp.asarray(np.concatenate(x[2]))))
        else:
            out.append(jnp.asarray(x))
    return out


def _jax_loss(dp, emb_outs, b):
    n, y = b
    x = jnp.concatenate([e.reshape(e.shape[0], -1) for e in emb_outs],
                        axis=1)
    return jnp.mean((x @ dp["w"] + n @ dp["v"] - y) ** 2)


def jax_pipelined(spec, world):
    """JAX's pipelined K = 2 run of a spec (its ``_run``, the state set
    from the spec's tables): losses, tables, the telemetry and streaming
    states (``[world, ...]``) and the last metrics, as numpy."""
    mesh = _mesh() if world > 1 else None
    jde = JaxDE(spec["configs"], world_size=world,
                row_slice=spec["row_slice"],
                schedule=jsched.pipelined_schedule(
                    2, streaming=spec["streaming"]))
    params = jde.set_weights(spec["tables"], mesh=mesh)
    opt = {"sgd": JSGD, "adagrad": JAdagrad, "adam": JAdam}[spec["opt"]]()
    tx = optax.sgd(spec["dense_lr"])
    dp = {"w": jnp.asarray(spec["w"]), "v": jnp.asarray(spec["v"])}
    state = JaxState(params, opt.init(params), dp, tx.init(dp),
                     jnp.zeros((), jnp.int32))
    tcfg = jtel.TelemetryConfig() if spec["telemetry"] else None
    scfg = (jstream.StreamingConfig(admit_min_count=1)
            if spec["streaming"] else None)
    aux = []
    if tcfg:
        aux.append(jtel.init_telemetry(jde, tcfg, mesh=mesh))
    if scfg:
        aux.append(jstream.init_streaming(jde, scfg, mesh=mesh))
    step = make_hybrid_train_step(
        jde, _jax_loss, tx, opt, mesh=mesh, lr_schedule=spec["lr"],
        with_metrics=spec["metrics"], nan_guard=True,
        telemetry=tcfg if tcfg else False, dynamic=scfg if scfg else False)
    cats = _jax_inputs(spec)
    bt = (jnp.asarray(spec["n"]), jnp.asarray(spec["y"]))
    losses, metrics = [], None
    for _ in range(spec["steps"]):
        out = step(state, cats, bt, *aux)
        state = out[1]
        losses.append(float(out[0]))
        rest = list(out[2:])
        if spec["metrics"]:
            metrics = jax.tree.map(np.array, rest.pop(0))
        aux = rest
    return {"losses": losses, "tables": jde.get_weights(state.emb_params),
            "aux": [jax.tree.map(np.array, a) for a in aux],
            "metrics": metrics}


INT_METRICS = ("ids_routed", "invalid_id_count", "id_overflow",
               "skipped_steps")


def _float_ok(got, want):
    """Losses and tables within (RTOL, ATOL) (the tables where both
    sides hold them: a world-8 rank other than 0 returns none)."""
    tables = (() if got["tables"] is None or want["tables"] is None
              else zip(got["tables"], want["tables"]))
    return (np.allclose(got["losses"], want["losses"], rtol=RTOL, atol=ATOL)
            and all(np.allclose(a, b, rtol=RTOL, atol=ATOL)
                    for a, b in tables))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _int_ok(got, want, rank=None):
    """The telemetry and streaming state (integer leaves bitwise, float
    counters within 1e-6) and the integer metrics bitwise; ``rank``: the
    port's ``[1, ...]`` rows against row ``rank`` of JAX's ``[world,
    ...]`` states (None: the same layout on both sides)."""
    for a, b in zip(_leaves(got["aux"]), _leaves(want["aux"])):
        if rank is not None:
            b = b[rank:rank + 1]
        if a.shape != b.shape:
            return False
        if np.issubdtype(a.dtype, np.integer):
            if not np.array_equal(a, b):
                return False
        elif not np.allclose(a, b, rtol=1e-6, atol=1e-6):
            return False
    if got["metrics"] is not None:
        for k in INT_METRICS:
            if not np.array_equal(np.asarray(got["metrics"][k]),
                                  np.asarray(want["metrics"][k])):
                return False
    return True


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_pipeline"))
    yield g
    g.close()


CASES = [
    # JAX's four named tests, then its six cross cases
    ("dense", WORLD, "adagrad", True, False),
    ("ragged", 1, "sgd", False, False),
    ("row_sliced", WORLD, "adam", False, False),
    ("streaming", WORLD, "adagrad", True, True),
    ("dense", 1, "adam", False, False),
    ("dense", WORLD, "sgd", False, False),
    ("ragged", WORLD, "adagrad", True, False),
    ("row_sliced", 1, "adagrad", True, False),
    ("streaming", 1, "sgd", False, False),
    ("streaming", WORLD, "adam", False, True),
]
#: the world-8 case whose ranks also run the controls
CONTROL_CASE = ("streaming", WORLD, "adagrad", True, True)
CONTROLS = ("stream_reversed", "stream_dropped", "no_inv_k",
            "serialized_order")


@functools.lru_cache(maxsize=None)
def _ab(case, group):
    name, world, opt, metrics, telemetry = case
    spec = make_spec(name, world, opt, metrics, telemetry)
    if world == 1:
        got = {"serialized": pipeline_run(spec, 1),
               "pipelined": pipeline_run(spec, 2)}
        if case == ("dense", 1, "adam", False, False):
            got["no_inv_k"] = pipeline_run(spec, 2, control="no_inv_k")
        return got, jax_pipelined(spec, 1)
    if case == CONTROL_CASE:
        spec["controls"] = CONTROLS
    group.submit("pipeline", spec)
    want = jax_pipelined(spec, world)
    return group.collect(), want


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_ab_pipelined_matches_jax_and_serialized(case, group):
    got, want = _ab(case, group)
    world = case[1]
    ranks = [got] if world == 1 else got
    for r, res in enumerate(ranks):
        pipe, ser = res["pipelined"], res["serialized"]
        rank = None if world == 1 else r
        # (a) JAX's pipelined step; (b) the port's serialized step
        assert _float_ok(pipe, ser), (r, pipe["losses"], ser["losses"])
        assert _int_ok(pipe, ser), r
        assert _int_ok(pipe, want, rank), r
        if r == 0:
            assert _float_ok(pipe, want), (pipe["losses"], want["losses"])
        assert pipe["losses"] == ranks[0]["pipelined"]["losses"]
    if case[0] == "streaming":
        # the case admits ids and claims slots: the integer bound has teeth
        assert want["aux"][-1]["admitted"].sum() > 0


def test_controls_fail_their_bounds(group):
    """The sparse apply scaled by ``1/world`` (not ``1/(world K)``) fails
    the float bound at world 1 and 8; the admission stage given only the
    last microbatch's streaming stream fails the integer bound on the
    ranks holding the streaming table (their sketch and slot map differ
    from JAX's). The stage given the microbatches in reversed order keeps
    every bit: K16's claim goes to the highest estimate, then the highest
    fingerprint, and only then to a position among one id's own
    duplicates, so the staged state does not depend on the stream's
    order (as the JAX package's note on its staging says)."""
    got, want = _ab(("dense", 1, "adam", False, False), group)
    assert not _float_ok(got["no_inv_k"], want)
    assert not _float_ok(got["no_inv_k"], got["serialized"])
    ranks, want = _ab(CONTROL_CASE, group)
    assert not _float_ok(ranks[0]["no_inv_k"], want)
    owners = [r for r, res in enumerate(ranks)  # the streaming table's
              if res["pipelined"]["aux"][-1]["admitted"].sum() > 0]
    assert owners
    for r, res in enumerate(ranks):
        assert _int_ok(res["stream_reversed"], want, r), r
        assert _int_ok(res["stream_dropped"], want, r) == (r not in owners)
    for r in owners:  # the slot maps themselves, not only the sketch
        assert not np.array_equal(
            ranks[r]["stream_dropped"]["aux"][-1]["w4"]["slot_fp"],
            want["aux"][-1]["w4"]["slot_fp"][r:r + 1])


# ------------------------------------------------------------ the order


def _order_ok(names, K=2):
    """The pipelined step's issue order in one step's phase log: each
    microbatch k+1's id and out exchanges start before microbatch k's
    dense forward/backward (and are first waited for after microbatch k's
    lookup or dense work), and every grad exchange starts before the
    telemetry fold, the admission stage and the all-reduce and is first
    waited for after them."""

    def at(name):
        return names.index(name)

    try:
        for k in range(K - 1):
            tag, nxt = f"_mb{k}", f"_mb{k + 1}"
            dense = at("dense_forward_backward" + tag)
            if not (at("id_all_to_all" + nxt) < at(
                    "id_all_to_all" + tag + "_wait") and at(
                    "out_all_to_all" + nxt) < dense < at(
                    "out_all_to_all" + nxt + "_wait")):
                return False
            lookups = [i for i, n in enumerate(names)
                       if fnmatch.fnmatchcase(n, "lookup_*" + tag)]
            if not at("id_all_to_all" + nxt) < lookups[0] < at(
                    "id_all_to_all" + nxt + "_wait"):
                return False
        # (a rank holding no streaming slot stages nothing)
        middle = [at("telemetry"), at("dense_all_reduce")] + [
            i for i, n in enumerate(names)
            if n.startswith("streaming_admit_w")]
        for k in range(K):
            g = "grad_all_to_all" + f"_mb{k}"
            if not at(g) < min(middle) <= max(middle) < at(g + "_wait"):
                return False
    except (ValueError, IndexError):
        return False
    return True


def test_pipelined_order_from_phase_scopes(group):
    ranks, _ = _ab(CONTROL_CASE, group)
    assert any("streaming_admit_w4" in res["pipelined"]["phases"]
               for res in ranks)
    for r, res in enumerate(ranks):
        assert _order_ok(res["pipelined"]["phases"]), (
            r, res["pipelined"]["phases"])
        # the control: every exchange waited for as it starts
        assert not _order_ok(res["serialized_order"]["phases"]), r
        # the control still trains the same step
        assert _float_ok(res["serialized_order"], res["pipelined"])
    # the serialized step's log carries the schedule's untagged names
    ser = ranks[0]["serialized"]["phases"]
    assert ser.index("id_all_to_all") < ser.index(
        "dense_forward_backward") < ser.index("grad_all_to_all")


# ------------------------------------------------------- exact arithmetic


def _exact_spec():
    configs = [{"input_dim": 16, "output_dim": 4, "combiner": "sum"}
               for _ in range(2)]
    tables = [(np.arange(64, dtype=np.float32).reshape(16, 4) % 8)
              for _ in configs]
    return dict(
        configs=configs, row_slice=None, streaming=False, telemetry=False,
        metrics=False, opt="sgd", tables=tables,
        inputs=[np.asarray([[1, 1], [2, 3], [1, 2], [3, 3]], np.int32),
                np.asarray([[0, 5], [5, 5], [5, 0], [2, 2]], np.int32)],
        n=np.zeros((4, 13), np.float32),
        y=np.asarray([[1.0], [-2.0], [4.0], [-8.0]], np.float32),
        w=np.ones((8, 1), np.float32), v=np.zeros((13, 1), np.float32),
        lr=0.5, dense_lr=0.0, steps=2)


def test_grad_accumulation_exact_bitwise():
    """Integer tables and cotangents, duplicate ids straddling the
    microbatch boundary: the K = 2 step equals the serialized step and
    JAX's pipelined step bit for bit (nan_guard on: JAX's test runs it
    off, the arithmetic is the same)."""
    spec = _exact_spec()
    ser, pipe = pipeline_run(spec, 1), pipeline_run(spec, 2)
    want = jax_pipelined(spec, 1)

    def same(a, b):
        return a["losses"] == b["losses"] and all(
            np.array_equal(x, y) for x, y in zip(a["tables"], b["tables"]))

    assert same(pipe, ser)
    assert same(pipe, want)
    assert not same(pipeline_run(spec, 2, control="no_inv_k"), want)


# ------------------------------------------------------------ K = 1, mp


def test_k1_pipelined_schedule_is_the_serialized_step(monkeypatch):
    """``pipelined_schedule(1)`` runs the serialized body: the same phase
    log, the same call sites called as often, bitwise the same state."""
    from distributed_embeddings_torch.parallel import (exchange, lookup,
                                                       optimizers)

    sites = ((lookup, "gather_combine"), (exchange, "pack_ids"),
             (exchange, "pack_columns"), (optimizers, "sgd_scatter"),
             (optimizers, "dense_update"), (ttrainer, "grad_health"))
    calls = {}
    for mod, name in sites:
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(ttrainer, "_pipelined_local_step", None)
    spec = make_spec("dense", 1, "sgd", True)
    runs = {}
    for label in ("none", "k1"):
        calls.clear()
        if label == "k1":
            real_init = DistributedEmbedding.__init__

            def init(self, *a, schedule=None, **kw):
                real_init(self, *a, schedule=tsched.pipelined_schedule(1),
                          **kw)

            monkeypatch.setattr(DistributedEmbedding, "__init__", init)
        runs[label] = (pipeline_run(spec, 1), dict(calls))
    (a, ca), (b, cb) = runs["none"], runs["k1"]
    assert ca == cb and ca["gather_combine"] > 0
    assert a["phases"] == b["phases"]
    assert a["losses"] == b["losses"]
    assert all(np.array_equal(x, y) for x, y in zip(a["tables"],
                                                    b["tables"]))
    assert all(np.array_equal(x, y) for x, y in zip(
        _leaves(a["metrics"]), _leaves(b["metrics"])))


def test_pipelined_rejects_mp_input():
    """``dp_input=False`` with a pipelined schedule raises
    ``NotImplementedError`` as JAX's step does (model-parallel input has
    no id exchange to hide), before any collective."""
    from distributed_embeddings_torch.parallel import (
        SGD, HybridTrainState, SparseSGD, make_hybrid_train_step)

    configs = [{"input_dim": 32, "output_dim": 4, "combiner": "sum"}] * 8
    de = DistributedEmbedding(configs, WORLD, dp_input=False,
                              schedule=tsched.pipelined_schedule(2))
    step = make_hybrid_train_step(de, pipe_loss, SGD(0.1), SparseSGD(),
                                  nan_guard=False)
    with pytest.raises(NotImplementedError, match="pipelined"):
        step(HybridTrainState(emb_params={}), None, None)
