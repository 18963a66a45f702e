"""Streaming vocabularies in the port against the JAX package: the hashes,
``remap_width`` and ``commit`` (on the CPU, the plain versions of K16,
K13 and K17), the train step and loop with ``dynamic=`` over dense and
ragged inputs (with telemetry alongside), the read-only eval step and
``ServingRuntime(streaming=)``, the host functions and the converters,
on the same numpy ids and weights.

Tolerances: the streaming state (slot maps, sketches, step counts) is
integer arithmetic and its counters float32 sums of counts below 2^24,
so it is held bit for bit, and so are ``remap_width``'s and
``commit``'s outputs on shared inputs (a claimed row's reset is one
IEEE add; a NaN equals a NaN). Over the train-step trajectories the
floats (losses, slabs, accumulators, dense weights) are held to
``rtol=2e-5, atol=1e-6``: XLA's CPU ``rsqrt`` in ``SparseAdagrad`` is an
approximation (an ulp off for ~1 float32 in 7, see
``test_torch_adagrad.py``) and the two packages' dense matmuls sum in
other orders, so the slabs drift by ulps a step; every claimed row's
reset is exact in both. JAX builds are made once per module.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.ops.embedding_lookup import (
    Ragged as JRagged)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel import streaming as js
from distributed_embeddings_tpu.parallel import optimizers as jopt
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_eval_step as jax_eval_step,
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.ops import Ragged
from distributed_embeddings_torch.ops import streaming as sops
from distributed_embeddings_torch.ops.packed_slab import unpack_rows_np
from distributed_embeddings_torch.parallel import (
    SGD, DistributedEmbedding, HybridTrainState, ServeConfig, Request,
    Served, ServingRuntime, SparseAdagrad, SparseAdam, SparseMomentum,
    SparseSGD, StreamingConfig, init_streaming, make_hybrid_eval_step,
    make_hybrid_train_loop, make_hybrid_train_step)
from distributed_embeddings_torch.parallel import streaming as ts
from distributed_embeddings_torch.utils.convert import (
    streaming_state_from_jax, streaming_state_to_numpy,
    telemetry_state_to_numpy)

torch.set_num_threads(1)

CFG = StreamingConfig(admit_min_count=2, evict_margin=1, depth=3,
                      buckets=61)
JCFG = js.StreamingConfig(*CFG)
TCFG = tel.TelemetryConfig(depth=2, buckets=31, topk=4, candidates=8)
B, LR, RTOL, ATOL = 24, 0.1, 2e-5, 1e-6
EXT = 10 ** 6  # external ids start far above every table's input_dim
M32 = 0xFFFFFFFF


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _equal(got, want, what=""):
    """Bitwise equal (NaN equals NaN), dtypes included."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _state_equal(got, want, what=""):
    g, w = streaming_state_to_numpy(got), jax.tree.map(np.asarray, want)
    assert sorted(g) == sorted(w), what
    for k in g:
        if isinstance(g[k], dict):
            _state_equal(got[k], want[k], f"{what}{k}/")
        else:
            assert g[k].dtype == w[k].dtype, (what, k)
            _equal(g[k], w[k], f"{what}{k}")


# ----------------------------------------------------------------- hashes


def _mix_np(ids, salt, mult):
    """numpy transcription of ``streaming.py:_mix`` for int64 ids (the
    high word folded in first)."""
    x = ids.astype(np.int64)
    u = (x ^ (x >> 32)).astype(np.uint64) & M32
    h = (u ^ ((salt.astype(np.uint64) * js._H_SALT.item()) & M32)) & M32
    h = (h * int(mult)) & M32
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & M32
    h ^= h >> 13
    return h


def test_hashes_match_jax_on_int32_ids():
    rng = np.random.default_rng(0)
    ids = np.concatenate([[0, 1, -1, 2 ** 31 - 1, -(2 ** 31)],
                          rng.integers(-2 ** 31, 2 ** 31 - 1, 4000)]
                         ).astype(np.int32)
    tid = rng.integers(0, 40, ids.size).astype(np.int32)
    cap = rng.integers(0, 5000, ids.size).astype(np.int32)
    nb = rng.integers(0, 300, ids.size).astype(np.int32)
    ji, jt = jnp.asarray(ids), jnp.asarray(tid)
    ti, tt = torch.from_numpy(ids), torch.from_numpy(tid)
    for mult in (js._H_SLOT, js._H_BUCKET, js._H_FP):
        _equal(sops.mix_plain(ti, tt, int(mult)),
               np.asarray(js._mix(ji, jt, mult)).astype(np.int64))
    _equal(sops.fingerprint_plain(ti, tt), js._fingerprint(ji, jt))
    _equal(ts.sketch_key(ti, tt), js.sketch_key(ji, jt))
    slot, bucket = sops.slot_bucket_plain(ti, tt, torch.from_numpy(cap),
                                          torch.from_numpy(nb))
    jslot = (js._mix(ji, jt, js._H_SLOT) % jnp.maximum(
        jnp.asarray(cap), 1).astype(jnp.uint32)).astype(jnp.int32)
    jbucket = (js._mix(ji, jt, js._H_BUCKET) % jnp.maximum(
        jnp.asarray(nb), 1).astype(jnp.uint32)).astype(jnp.int32)
    _equal(slot, jslot)
    _equal(bucket, jbucket)


def test_hashes_of_int64_ids_fold_the_high_word():
    """Ids at or above 2^31, and pairs congruent mod 2^32, against the
    numpy transcription; ids below 2^31 hash alike as int32 and int64."""
    rng = np.random.default_rng(1)
    low = rng.integers(0, 2 ** 31 - 1, 500)
    ids = np.concatenate([low, low + 2 ** 32, low + 2 ** 40,
                          [2 ** 31, 2 ** 32, 2 ** 63 - 1]]).astype(np.int64)
    tid = rng.integers(0, 9, ids.size).astype(np.int32)
    t64, tt = torch.from_numpy(ids), torch.from_numpy(tid)
    for mult in (js._H_SLOT, js._H_BUCKET, js._H_FP):
        _equal(sops.mix_plain(t64, tt, int(mult)),
               _mix_np(ids, tid, mult).astype(np.int64))
    fp = sops.fingerprint_plain(t64, tt).numpy()
    n = low.size
    assert (fp[:n] != fp[n:2 * n]).mean() > 0.99  # congruent ids differ
    _equal(fp[:n], sops.fingerprint_plain(
        torch.from_numpy(low.astype(np.int32)), tt[:n]))
    assert fp.min() >= 0


# ------------------------------------------------------------ remap_width


def _case_stream(case, rng, step):
    """One step's width stream ``(ext, live, cap, nb, tid, roff)`` of a
    case, over two streaming tables (rows [4, 24) and [24, 30) of a
    32-row slab), as numpy."""
    if case == "cold_buckets":  # many distinct cold ids share buckets
        ext = EXT + rng.integers(0, 10 ** 5, 60)
    elif case == "below_gate":  # each id once a step
        ext = EXT + 1000 * step + np.arange(60)
    elif case == "lfu_eviction":  # one slot a table: 9 evicts 3, then
        # both are served (slot and bucket); the other table's id hits
        first = [[3], [9], [9], [3, 9], [3, 9], [9, 3]][step]
        ext = EXT + np.concatenate([np.repeat(first, 30 // len(first)),
                                    np.full(30, 5)])
    elif case == "duplicate_claims":  # an id many times in one batch
        ext = EXT + np.repeat(rng.integers(0, 6, 10), 6)
    elif case == "colliding_claims":  # distinct ids, few slots
        ext = EXT + rng.integers(0, 40, 60)
    else:  # "dead_negative" and "read_only": mixed, with dead positions
        ext = EXT + (rng.zipf(1.3, 60) % 30)
        ext[::7] = -rng.integers(1, 5, ext[::7].size)
    n = ext.size
    live = np.ones(n, bool)
    if case in ("dead_negative", "read_only"):
        live[::5] = False
    first = np.arange(n) < n // 2
    small = case in ("lfu_eviction", "colliding_claims")
    cap = np.where(first, 1 if small else 20, 1 if small else 4)
    nb = np.where(first, 3, 2)
    tid = np.where(first, 5, 9)
    roff = np.where(first, 4, 24)
    return (ext.astype(np.int32), live,
            *(a.astype(np.int32) for a in (cap, nb, tid, roff)))


REMAP_CASES = ["cold_buckets", "below_gate", "lfu_eviction",
               "duplicate_claims", "colliding_claims", "dead_negative",
               "read_only"]


@pytest.mark.parametrize("case", REMAP_CASES)
def test_remap_width_matches_jax(case):
    """Six steps of one width: local rows, the staged slot map and
    sketch, the claimed rows and the counts bitwise after each; the
    state carried as JAX's commit would (enabled)."""
    rng = np.random.default_rng(REMAP_CASES.index(case))
    rows_cap = 32
    cfg = CFG._replace(admit_min_count={"lfu_eviction": 1,
                                        "below_gate": 100}.get(case, 2))
    jw = {"slot_fp": jnp.full((rows_cap,), -1, jnp.int32),
          "slot_freq": jnp.zeros((rows_cap,), jnp.int32),
          "cms": jnp.zeros((cfg.depth, cfg.buckets), jnp.int32)}
    if case == "read_only":  # an occupied map to read
        fp0 = np.full(rows_cap, -1, np.int32)
        s = _case_stream(case, np.random.default_rng(9), 0)
        slot, _ = sops.slot_bucket_plain(*(torch.from_numpy(a) for a in (
            s[0], s[4], s[2], s[3])))
        rows = (s[5] + slot.numpy())[s[1] & (s[0] >= 0)][:10]
        fp0[rows] = sops.fingerprint_plain(
            torch.from_numpy(s[0]), torch.from_numpy(s[4])).numpy()[
            s[1] & (s[0] >= 0)][:10]
        jw["slot_fp"] = jnp.asarray(fp0)
    tw = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    update = case != "read_only"
    totals = {k: 0.0 for k in ts.COUNTERS}
    for step in range(6):
        arrays = _case_stream(case, rng, step)
        jl, jp = js.remap_width(
            jw, js.WidthStream(*(jnp.asarray(a) for a in arrays)), rows_cap,
            js.StreamingConfig(*cfg), update=update)
        tl, tp = ts.remap_width(
            tw, ts.WidthStream(*(torch.from_numpy(a.copy())
                                 for a in arrays)), rows_cap, cfg,
            update=update)
        _equal(tl, jl, f"{case} step {step}: local_rows")
        if not update:
            assert jp is None and tp is None
            hit = _np(tl) < arrays[2]
            assert hit[arrays[1] & (arrays[0] >= 0)].any()
            continue
        jnew, jscrub, jstats = jp
        _equal(tp[1].scrub_rows, jscrub, f"{case} step {step}: scrub_rows")
        tnew = ts.staged_wstate(tw, tp, rows_cap)
        for k in ("slot_fp", "slot_freq", "cms"):
            _equal(tnew[k], jnew[k], f"{case} step {step}: {k}")
        for k, v in ts.step_stats(tp).items():
            _equal(v, jstats[k], f"{case} step {step}: {k}")
            totals[k] += float(v[0])
        # the carried sketch is only read
        _equal(tw["cms"], jw["cms"])
        jw, tw = jnew, tnew
    if case == "below_gate":
        assert totals["admitted"] == 0 and totals["bucket_ids"] == 6 * 60
    elif case == "lfu_eviction":
        assert totals["evicted"] > 0 and totals["hit_ids"] > 0
    elif update:
        assert totals["admitted"] > 0


# ------------------------------------------------------------------ commit

COMMIT_CONFIGS = [{"input_dim": 50, "output_dim": 8},
                  {"input_dim": 16 + 4, "output_dim": 8,
                   "streaming": {"capacity": 16, "buckets": 4}},
                  {"input_dim": 9 + 3, "output_dim": 8,
                   "streaming": {"capacity": 9, "buckets": 3}}]


def _commit_opts(name):
    """``(JAX optimizer, port optimizer, slab dtype, leaf dtype)``."""
    return {"sgd": (jopt.SparseSGD(), SparseSGD(), "float32", None),
            "adagrad": (jopt.SparseAdagrad(), SparseAdagrad(), "float32",
                        "float32"),
            "adagrad_bf16": (jopt.SparseAdagrad(), SparseAdagrad(),
                             "bfloat16", "float32"),
            "momentum": (jopt.SparseMomentum(0.9), SparseMomentum(0.9),
                         "float32", "float32"),
            "adam": (jopt.SparseAdam(), SparseAdam(), "float32",
                     "float32")}[name]


def _unpack(a, w):
    """A JAX ``[1, phys, 128]`` slab-shaped array as logical rows."""
    return unpack_rows_np(np.asarray(a)[0], w)


@pytest.mark.parametrize("enable", [True, False, None])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adagrad_bf16",
                                 "momentum", "adam"])
def test_commit_matches_jax(opt, enable):
    """One remap and commit from a warmed slot map (so claims evict and
    hit), with random slab and optimizer rows and an Inf in the slab:
    slab, every leaf, the streaming state and the totals bitwise."""
    jo, to, sdt, ldt = _commit_opts(opt)
    jde = JaxDE(COMMIT_CONFIGS, world_size=1)
    tde = DistributedEmbedding(COMMIT_CONFIGS, world_size=1)
    rng = np.random.default_rng(3)
    w, rows_cap = 8, tde.rows_cap[8]
    slab = rng.normal(size=(rows_cap, w)).astype(np.float32)
    if sdt == "bfloat16":
        slab = np.asarray(torch.from_numpy(slab).bfloat16().float())
    slab[:60:7, 3] = np.inf  # some claimed rows hold an Inf
    jslab = jnp.asarray(slab, jnp.dtype(sdt))
    jparams = {"w8": jde.stacked_view({"w8": _pack(jslab)})["w8"]}
    jstate_opt = jo.init(jparams)
    jstate_opt = jax.tree.map(
        lambda v: (jnp.asarray(rng.uniform(0.1, 2, v.shape), v.dtype)
                   if v.shape == jparams["w8"].shape else v), jstate_opt)
    if ldt is not None and sdt == "bfloat16":
        jstate_opt = jax.tree.map(
            lambda v: v.astype(jnp.float32)
            if v.shape == jparams["w8"].shape else v, jstate_opt)
    tparams = {"w8": torch.from_numpy(slab.copy()).to(
        getattr(torch, sdt))[None]}
    tstate_opt = {"w8": jax.tree.map(
        lambda v: (torch.from_numpy(_unpack(v, w).copy())[None]
                   if v.shape == jparams["w8"].shape
                   else torch.from_numpy(np.array(v, np.float32))),
        jstate_opt["w8"])}
    # warm the slot map: two remaps committed without an optimizer
    jss = js.init_streaming(jde, JCFG)
    tss = init_streaming(tde, CFG, device="cpu")
    ext = [EXT + np.repeat(rng.integers(0, 12, 8), 3) for _ in range(3)]
    for k in range(3):
        cats = [np.zeros(B, np.int32), ext[k].astype(np.int32),
                (EXT + rng.integers(0, 6, B)).astype(np.int32)]
        _, _, jpend = jde.forward_with_residuals(
            jparams, [jnp.asarray(c) for c in cats],
            streaming=(JCFG, js.local_state(jss)))
        _, _, tpend = tde.forward_with_residuals(
            tparams, [torch.from_numpy(c.copy()) for c in cats],
            streaming=(CFG, ts.local_state(tss)))
        last = k == 2
        jen = None if (enable is None or not last) else jnp.asarray(enable)
        ten = None if (enable is None or not last) else torch.tensor(enable)
        jout = js.commit(jde, jde.local_view(jparams), jpend,
                         js.local_state(jss), enable=jen,
                         opt_state=jde.local_view(jstate_opt) if last
                         else None, optimizer=jo if last else None)
        if last:
            jp, jopt_new, jnew, jtot = jout
        else:
            jp, jnew, jtot = jout
        jparams = jde.stacked_view(jp)
        jss = js.stacked_state(jnew)
        ttot = ts.commit(tde, tde.local_view(tparams), tpend,
                         ts.local_state(tss), enable=ten,
                         opt_state=tde.local_view(tstate_opt) if last
                         else None, optimizer=to if last else None)
        _state_equal(tss, jss, f"commit {k}: ")
        for name in ts.COUNTERS:
            _equal(ttot[name], jtot[name], f"commit {k}: {name}")
    jstate_opt = jde.stacked_view(jopt_new)
    _equal(tparams["w8"][0], _unpack(jparams["w8"], w), "slab")
    for got, want in zip(jax.tree.leaves(tstate_opt["w8"]),
                         jax.tree.leaves(jstate_opt["w8"])):
        if want.shape == jparams["w8"].shape:
            want = _unpack(want, w)[None]
        _equal(got, want, f"{opt} leaf")
    admitted = float(tss["admitted"][0, 0])
    assert admitted > 0 and int(tss["steps"][0, 0]) == (2 if enable is False
                                                        else 3)


def _pack(slab):
    """A logical ``[rows, w]`` slab in JAX's lane-packed layout."""
    from distributed_embeddings_tpu.ops import packed_slab as jps
    return jps.pack_rows(slab, slab.shape[1])


# ---------------------------------------------- through the train step

#: a static and a streaming one-hot table in one width-8 group, a
#: streaming multi-hot sum table (hot 3) and a streaming width-16 table
D_CONFIGS = [{"input_dim": 50, "output_dim": 8},
             {"input_dim": 16 + 4, "output_dim": 8,
              "streaming": {"capacity": 16, "buckets": 4}},
             {"input_dim": 10 + 5, "output_dim": 8, "combiner": "sum",
              "streaming": {"capacity": 10, "buckets": 5}},
             {"input_dim": 12 + 3, "output_dim": 16,
              "streaming": {"capacity": 12, "buckets": 3}}]
#: ragged tables of one width: a static sum feature and a weighted mean
#: streaming feature
R_CONFIGS = [{"input_dim": 40, "output_dim": 8, "combiner": "sum"},
             {"input_dim": 24 + 6, "output_dim": 8, "combiner": "mean",
              "streaming": {"capacity": 24, "buckets": 6}}]
R_CAP = 3 * B


def _configs(kind):
    return R_CONFIGS if kind == "r" else D_CONFIGS


def _ext(rng, shape, vocab=30):
    ids = EXT + (rng.zipf(1.3, shape) - 1) % vocab
    dead = rng.random(shape) < 0.1
    return np.where(dead, -rng.integers(1, 5, shape), ids)


def _batch(kind, rng, nan=False):
    """One step's inputs as numpy: per input ``ids`` (dense) or ``(values,
    splits, weights)`` (ragged), and the labels."""
    if kind != "r":
        cats = [(rng.zipf(1.4, B) - 1) % 50, _ext(rng, B),
                _ext(rng, (B, 3)), _ext(rng, B, vocab=20)]
        dt = np.int64 if kind == "d64" else np.int32
        cats = [c.astype(dt) for c in cats]
    else:
        cats = []
        for t, cfg in enumerate(R_CONFIGS):
            hots = rng.integers(0, 5, B)
            hots[-1] = R_CAP // 2 if t == 0 else 0
            splits = np.zeros(B + 1, np.int32)
            np.cumsum(hots, out=splits[1:])
            vals = ((rng.zipf(1.3, R_CAP) - 1) % cfg["input_dim"] if t == 0
                    else _ext(rng, R_CAP))
            w = (rng.uniform(0.5, 2, R_CAP).astype(np.float32) if t == 1
                 else None)
            cats.append((vals.astype(np.int32), splits, w))
    y = rng.normal(size=B).astype(np.float32)
    if nan:
        y[3] = np.nan
    return cats, y


def _jax_inputs(kind, cats):
    if kind != "r":  # JAX runs without x64: its blocks are int32
        return [jnp.asarray(c.astype(np.int32)) for c in cats]
    return [JRagged(values=jnp.asarray(v), row_splits=jnp.asarray(s),
                    weights=None if w is None else jnp.asarray(w))
            for v, s, w in cats]


def _torch_inputs(kind, cats):
    if kind != "r":
        return [torch.from_numpy(c.copy()) for c in cats]
    return [Ragged(values=torch.from_numpy(v.copy()),
                   row_splits=torch.from_numpy(s.copy()),
                   weights=None if w is None else torch.from_numpy(w.copy()))
            for v, s, w in cats]


def _width(kind):
    return sum(c["output_dim"] for c in _configs(kind))


def _jloss(dp, outs, y):
    x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], axis=1)
    return jnp.mean((x @ dp["w"])[:, 0] - y) ** 2


def _jpred(dp, outs, y):
    x = jnp.concatenate([o.reshape(o.shape[0], -1) for o in outs], axis=1)
    return (x @ dp["w"])[:, 0]


class _Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _tloss(m, outs, y):
    x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)
    return torch.mean((x @ m.w)[:, 0] - y) ** 2


def _tpred(m, outs, y):
    x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)
    return (x @ m.w)[:, 0]


@functools.lru_cache(maxsize=None)
def _jax_model(kind, telemetry):
    """The JAX layer, its jitted guarded streaming step, the eval step
    and the initial state as host arrays (the step donates)."""
    jde = JaxDE(_configs(kind), world_size=1)
    rng = np.random.default_rng(5)
    weights = [rng.normal(size=(c["input_dim"], c["output_dim"])
                          ).astype(np.float32) for c in _configs(kind)]
    params = jde.set_weights(weights)
    dp = {"w": jnp.asarray(rng.normal(size=(_width(kind), 1)) * 0.3,
                           jnp.float32)}
    tx = optax.sgd(LR)
    opt = jopt.SparseAdagrad()
    state = JaxState(params, opt.init(params), dp, tx.init(dp),
                     jnp.zeros((), jnp.int32))
    step = jax_train_step(jde, _jloss, tx, opt, lr_schedule=LR,
                          with_metrics=False, nan_guard=True,
                          telemetry=jtel.TelemetryConfig(*TCFG)
                          if telemetry else None, dynamic=JCFG)
    ev = jax_eval_step(jde, _jpred, dynamic=JCFG)
    return jde, step, ev, jax.tree.map(np.asarray, state), weights


def _models(kind, telemetry):
    jde, jstep, jev, host, weights = _jax_model("d" if kind == "d64"
                                                else kind, telemetry)
    jstate = jax.tree.map(jnp.asarray, host)
    tde = DistributedEmbedding(_configs(kind), world_size=1)
    params = tde.set_weights(weights, device="cpu")
    dense = _Dense(np.asarray(host.dense_params["w"]))
    opt = SparseAdagrad()
    tstate = HybridTrainState(params, opt.init(params), dense,
                              SGD(LR).init(list(dense.parameters())),
                              torch.zeros((), dtype=torch.int32))
    return (jde, jstate, jstep, jev), (tde, tstate)


def _tstep(tde, telemetry, loop=False):
    build = make_hybrid_train_loop if loop else make_hybrid_train_step
    return build(tde, _tloss, SGD(LR), SparseAdagrad(), lr_schedule=LR,
                 nan_guard=True, telemetry=TCFG if telemetry else None,
                 dynamic=CFG)


def _snapshot(tstate, tss):
    return [t.detach().clone() for t in (
        list(tstate.emb_params.values())
        + list(tstate.emb_opt_state.values())
        + list(tstate.dense_params.parameters()))] + [
        t.clone() for t in jax.tree.leaves(tss)]


def _held(tde, tstate, jstate, w_keys):
    """The port's slabs, accumulators and dense weights within the
    stated tolerance of JAX's."""
    for k in w_keys:
        w = int(k[1:])
        for got, want in ((tstate.emb_params[k], jstate.emb_params[k]),
                          (tstate.emb_opt_state[k],
                           jstate.emb_opt_state[k])):
            np.testing.assert_allclose(_np(got)[0], _unpack(want, w),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(_np(tstate.dense_params.w),
                               np.asarray(jstate.dense_params["w"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,telemetry", [("d", False), ("d", True),
                                            ("d64", False), ("r", False)])
def test_streaming_train_step_matches_jax(kind, telemetry):
    """Six guarded steps (the fifth a NaN batch) of SparseAdagrad with
    the streaming tables: after each, the streaming state bitwise, the
    losses, slabs, accumulators and dense weights within the stated
    tolerance; the skipped step leaves everything (its sketch fold
    included) bitwise unchanged; the loop carries one state to the same
    end; then the read-only eval step and ``ServingRuntime`` agree with
    JAX's eval step and leave the state alone."""
    (jde, jstate, jstep, jev), (tde, tstate) = _models(kind, telemetry)
    tstep = _tstep(tde, telemetry)
    want_params = ["state", "cat_inputs", "batch"] + (
        ["telem"] if telemetry else []) + ["stream"]
    assert list(inspect.signature(tstep).parameters) == want_params
    jss = js.init_streaming(jde, JCFG)
    tss = init_streaming(tde, CFG, device="cpu")
    jaux, taux = (), ()
    if telemetry:
        jaux = (jtel.init_telemetry(jde, jtel.TelemetryConfig(*TCFG)),)
        taux = (tel.init_telemetry(tde, TCFG, device="cpu"),)
    # the loop's run, from a copy of the same start
    (_, _, _, _), (lde, lstate) = _models(kind, telemetry)
    lss = init_streaming(lde, CFG, device="cpu")
    laux = (tel.init_telemetry(lde, TCFG, device="cpu"),) if telemetry \
        else ()
    rng = np.random.default_rng(21)
    batches = [_batch(kind, rng, nan=step == 4) for step in range(6)]
    w_keys = sorted(tstate.emb_params)
    for step, (cats, y) in enumerate(batches):
        nan = step == 4
        before = _snapshot(tstate, tss)
        jloss, jstate, *jout = jstep(jstate, _jax_inputs(kind, cats),
                                     jnp.asarray(y), *jaux, jss)
        jss, jaux = jout[-1], tuple(jout[:-1])
        tloss, tstate, *tout = tstep(tstate, _torch_inputs(kind, cats),
                                     torch.from_numpy(y), *taux, tss)
        assert tout[-1] is tss
        _state_equal(tss, jss, f"{kind} step {step}: ")
        if telemetry:
            g = telemetry_state_to_numpy(taux[0])
            for k, v in jax.tree.map(np.asarray, jaux[0]).items():
                if not isinstance(v, dict):
                    _equal(g[k], v, k)
        assert np.isfinite(float(tloss)) != nan
        if nan:
            after = _snapshot(tstate, tss)
            for a, b in zip(before, after):
                assert torch.equal(a, b)
            continue
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                                   atol=ATOL)
        _held(tde, tstate, jstate, w_keys)
    occ = ts.occupancy(tde, tss)
    assert occ == js.occupancy(jde, jss)
    # the skipped step does not count
    assert occ["admitted"] > 0 and occ["hit_ids"] > 0 and occ["steps"] == 5
    if kind != "r":
        assert occ["evicted"] > 0
    # the loop: one call over the six stacked steps, the same end
    loop = _tstep(lde, telemetry, loop=True)
    cat_stacks = _stack_inputs(kind, [c for c, _ in batches])
    losses, lstate, *lout = loop(lstate, cat_stacks, torch.from_numpy(
        np.stack([y for _, y in batches])), *laux, lss)
    assert lout[-1] is lss and losses.shape == (6,)
    for a, b in zip(_snapshot(lstate, lss), _snapshot(tstate, tss)):
        assert torch.equal(a, b)
    # read-only eval and serving: JAX's predictions, the state untouched
    cats, _ = _batch(kind, np.random.default_rng(77))
    before = _snapshot(tstate, tss)
    tev = make_hybrid_eval_step(tde, _tpred, dynamic=CFG)
    assert list(inspect.signature(tev).parameters) == [
        "state", "cat_inputs", "batch", "stream"]
    got = tev(tstate, _torch_inputs(kind, cats), None, tss)
    want = jev(jstate, _jax_inputs(kind, cats), None, jss)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if kind == "d":
        rt = ServingRuntime(tde, _tpred, tstate,
                            config=ServeConfig(max_batch=8, rungs=(8,),
                                               max_queue=64),
                            streaming=(CFG, tss), clock=lambda: 0.0)
        assert rt.streaming_state is tss
        reqs = [[c[i:i + 4] for c in cats] for i in range(0, 16, 4)]
        rt.warmup((reqs[0], None))
        for r in reqs:
            assert rt.submit(Request(cats=r), now=0.0) is None
        served = rt.flush(now=0.0)
        assert len(served) == 4 and all(isinstance(s, Served)
                                        for s in served)
        np.testing.assert_array_equal(
            np.concatenate([s.predictions for s in served]),
            _np(got)[:16])
    for a, b in zip(before, _snapshot(tstate, tss)):
        assert torch.equal(a, b)


def _stack_inputs(kind, steps):
    if kind != "r":
        return [torch.from_numpy(np.stack([s[i] for s in steps]))
                for i in range(len(steps[0]))]
    out = []
    for i in range(len(steps[0])):
        vals = np.stack([s[i][0] for s in steps])
        splits = np.stack([s[i][1] for s in steps])
        w = (None if steps[0][i][2] is None
             else torch.from_numpy(np.stack([s[i][2] for s in steps])))
        out.append(Ragged(values=torch.from_numpy(vals),
                          row_splits=torch.from_numpy(splits), weights=w))
    return out


# ------------------------------------------------------- host functions


def test_host_functions_match_jax():
    """``encode_state`` key for key (and value for value), the
    ``decode_state`` round trip, a capacity-drift input, ``occupancy``
    and the converters, on a state the step evolved."""
    (jde, jstate, jstep, _), (tde, tstate) = _models("d", False)
    jss = js.init_streaming(jde, JCFG)
    rng = np.random.default_rng(4)
    for _ in range(3):
        cats, y = _batch("d", rng)
        _, jstate, jss = jstep(jstate, _jax_inputs("d", cats),
                               jnp.asarray(y), jss)
    host = jax.tree.map(np.asarray, jss)
    tss = streaming_state_from_jax(host, device="cpu")
    _state_equal(tss, jss)
    back = streaming_state_to_numpy(tss)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype
        _equal(a, b, "converter round trip")
    enc, jenc = ts.encode_state(tde, tss), js.encode_state(jde, jss)
    assert sorted(enc) == sorted(jenc)
    for k in enc:
        assert enc[k].dtype == np.asarray(jenc[k]).dtype, k
        _equal(enc[k], jenc[k], k)
    template = init_streaming(tde, CFG, device="cpu")
    dec = ts.decode_state(tde, template, enc)
    _state_equal(dec, jss)
    _state_equal(template, js.init_streaming(jde, JCFG))  # untouched
    assert ts.occupancy(tde, dec) == js.occupancy(jde, jss)
    drift = dict(enc, t1_fp=enc["t1_fp"][:-1])
    _state_equal(ts.decode_state(tde, template, drift),
                 js.decode_state(jde, js.init_streaming(jde, JCFG), drift))
    _state_equal(ts.decode_state(tde, template, None),
                 js.init_streaming(jde, JCFG))
    fresh = ts.fresh_like(tss)
    assert int(fresh["w8"]["slot_fp"].max()) == ts.SLOT_FREE
    assert float(fresh["admitted"].sum()) == 0


# --------------------------------------------------------------- contracts


def test_streaming_contracts():
    assert ts.resolve_config(None) is None
    assert ts.resolve_config(False) is None
    assert ts.resolve_config(CFG) is CFG
    assert ts.resolve_config(True) == ts.config_from_env()
    assert tuple(ts.config_from_env()) == tuple(js.config_from_env())
    for bad in ("yes", 1, {"depth": 2}):
        with pytest.raises(TypeError, match="StreamingConfig"):
            ts.resolve_config(bad)
    with pytest.raises(ValueError, match="capacity"):
        DistributedEmbedding([COMMIT_CONFIGS[0],
                              {"input_dim": 99, "output_dim": 8,
                               "streaming": {"capacity": 16,
                                             "buckets": 4}}], world_size=1)
    static = DistributedEmbedding([COMMIT_CONFIGS[0]] * 2, world_size=1)
    with pytest.raises(ValueError, match="init_streaming"):
        init_streaming(static, CFG, device="cpu")
    params = static.init(torch.Generator().manual_seed(0), device="cpu")
    dense = _Dense(np.ones((16, 1), np.float32))
    state = HybridTrainState(params, SparseSGD().init(params), dense,
                             SGD(LR).init(list(dense.parameters())),
                             torch.zeros((), dtype=torch.int32))
    step = make_hybrid_train_step(static, _tloss, SGD(LR), SparseSGD(),
                                  dynamic=True)
    with pytest.raises(ValueError, match="streaming"):
        step(state, [torch.zeros(4, dtype=torch.int32)] * 2,
             torch.zeros(4), {})
    de = DistributedEmbedding(COMMIT_CONFIGS, world_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_streaming(de, CFG)
    st = init_streaming(de, CFG, device="cpu")
    _state_equal(st, js.init_streaming(JaxDE(COMMIT_CONFIGS, world_size=1),
                                       JCFG))
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(st))
    assert de.streaming_tables == {1: (16, 4), 2: (9, 3)}


def test_streaming_wrappers_run_plain_on_the_cpu_and_refuse_other_devices():
    n, rows_cap = 6, 8
    ext = torch.tensor([EXT, EXT, EXT + 1, -2, EXT + 1, EXT],
                       dtype=torch.int32)
    live = torch.tensor([True, True, True, True, False, True])
    meta = [torch.full((n,), v, dtype=torch.int32) for v in (4, 2, 3, 2)]
    slot_fp = torch.full((rows_cap,), -1, dtype=torch.int32)
    slot_freq = torch.zeros(rows_cap, dtype=torch.int32)
    cms = torch.zeros((2, 7), dtype=torch.int32)
    counts0 = (sops.remap_stage.launches, sops.commit_rows.launches)
    r = sops.remap_stage(ext, live, *meta, slot_fp, slot_freq, cms, 2, 1)
    assert r.counts.tolist() == [1, 0, 4, 0] and int(cms.sum()) == 8
    slab = torch.randn(rows_cap, 4)
    totals = torch.zeros(4)
    counters = [torch.zeros(1) for _ in range(4)]
    steps = torch.zeros(1, dtype=torch.int32)
    staged = cms.clone()
    carried = torch.zeros_like(cms)
    sops.commit_rows(slab, [], r, slot_fp, slot_freq, carried, staged,
                     totals, counters, steps)
    row = int(r.scrub_rows[r.scrub_rows < rows_cap][0])
    assert slab[row].abs().sum() == 0 and int(slot_fp[row]) >= 0
    assert torch.equal(carried, staged) and int(steps) == 1
    assert [float(c) for c in counters] == [1, 0, 4, 0]
    assert (sops.remap_stage.launches, sops.commit_rows.launches) == counts0
    dev = torch.empty(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sops.remap_stage(dev, live, *meta, slot_fp, slot_freq, cms, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        sops.commit_rows(slab.to("meta"), [], r, slot_fp, slot_freq,
                         carried, staged, totals, counters, steps)
