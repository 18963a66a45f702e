"""Access telemetry in the port against the JAX package: the sketch math
(``_buckets_of``, ``cms_update``, ``cms_query``, ``record_ids``; on the
CPU, the plain versions of K13-K15), ``update_telemetry`` through the
world-1 train step and loop, the host summaries, and the ``.npz`` state
files, on the same numpy ids.

Tolerances: none. The telemetry state is integer arithmetic and float32
sums of counts below 2^24, so every leaf is held bit for bit. JAX builds
(the layers and the jitted steps) are made once per module.
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
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    make_hybrid_train_step as jax_train_step)

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.ops import Ragged, record_ids_plain
from distributed_embeddings_torch.parallel import (
    SGD, DistributedEmbedding, HybridTrainState, SparseSGD,
    make_hybrid_train_loop, make_hybrid_train_step)
from distributed_embeddings_torch.utils.convert import (
    telemetry_state_from_jax, telemetry_state_to_numpy)

torch.set_num_threads(1)

CFG = tel.TelemetryConfig(depth=3, buckets=61, topk=6, candidates=10)
JCFG = jtel.TelemetryConfig(*CFG)
B, LR = 24, 0.1


def _assert_state_equal(got, want, what=""):
    """Every leaf of a port state equals the JAX state's, bit for bit."""
    g, w = telemetry_state_to_numpy(got), jax.tree.map(np.asarray, want)
    assert sorted(g) == sorted(w)
    for k in g:
        if isinstance(g[k], dict):
            _assert_state_equal(got[k], want[k], f"{what}{k}/")
            continue
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}{k}")


# ------------------------------------------------------------ sketch math


@pytest.mark.parametrize("depth", range(1, 11))
def test_buckets_of_matches_jax(depth):
    """Depths past 8 reuse the multipliers xor-folded with the depth;
    bucket counts that are not powers of two; ids up to 2^31 - 1 (and
    negative ones, which wrap to uint32)."""
    rng = np.random.default_rng(depth)
    ids = np.concatenate([
        [0, 1, 2 ** 31 - 1, 2 ** 31 - 2, -1, -(2 ** 31)],
        rng.integers(-2 ** 31, 2 ** 31 - 1, size=500)]).astype(np.int32)
    for buckets in (3, 2047, 2048):
        want = np.asarray(jtel._buckets_of(jnp.asarray(ids), depth, buckets))
        got = tel._buckets_of(torch.from_numpy(ids), depth, buckets)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,buckets", [(4, 2048), (9, 3), (2, 2047)])
def test_cms_update_and_query_match_jax(depth, buckets):
    rng = np.random.default_rng(buckets)
    cms = rng.integers(0, 50, size=(depth, buckets)).astype(np.int32)
    ids = (rng.zipf(1.3, size=700) % 1000).astype(np.int32)
    ids[::7] = rng.integers(-5, 2 ** 31 - 1, size=ids[::7].size)
    live = rng.random(700) < 0.8
    want = jtel.cms_update(jnp.asarray(cms), jnp.asarray(ids),
                           jnp.asarray(live))
    tcms = torch.from_numpy(cms.copy())
    got = tel.cms_update(tcms, torch.from_numpy(ids), torch.from_numpy(live))
    assert got is tcms  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = np.concatenate([ids, [-3, 2 ** 31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        tel.cms_query(got, torch.from_numpy(q)).numpy(),
        np.asarray(jtel.cms_query(want, jnp.asarray(q))))


I32_MIN, PAD = -2 ** 31, 2 ** 31 - 1


def _stream(kind, rng, step):
    """``(ids, live)`` of one step of a stream built to tie, or to reach
    an edge of the candidate pool."""
    if kind == "ties":  # many ids of one count: the order decides
        ids = np.repeat(rng.permutation(40)[:30], 3)
        live = np.ones(ids.size, bool)
    elif kind == "short":  # n < candidates
        ids = rng.integers(0, 9, size=7)
        live = rng.random(7) < 0.7
    elif kind == "all_dead":
        ids = rng.integers(0, 100, size=50)
        live = np.zeros(50, bool)
    elif kind == "hot":  # carried ids that stay hot beside fresh low counts
        ids = np.concatenate([np.repeat([3, 17, 90], 6 + step),
                              rng.integers(100, 400, size=60)])
        live = rng.random(ids.size) < 0.9
    elif kind == "negative":  # negative live ids all score id 0's count
        ids = np.concatenate([-rng.integers(1, 30, size=40),
                              rng.integers(0, 20, size=40)])
        live = rng.random(ids.size) < 0.85
    elif kind == "live_pad":  # INT32_MAX, live and dead, hot enough to
        # take a pool place when its first pad-valued position is live
        ids = np.concatenate([np.full(12, PAD), rng.integers(0, 60, 60)])
        live = rng.random(ids.size) < 0.8
        perm = rng.permutation(ids.size)
        ids, live = ids[perm], live[perm]
        first = int(np.flatnonzero(~live | (ids == PAD))[0])
        ids[first], live[first] = (PAD, True) if step % 2 == 0 else \
            (ids[first], False)
        return ids.astype(np.int32), live
    elif kind == "tie_boundary":  # one count across the pool's boundary
        ids = np.concatenate([np.repeat(rng.permutation(300)[:6], 9),
                              np.repeat(300 + rng.permutation(300)[:14], 5)])
        live = np.ones(ids.size, bool)
    elif kind == "k_above":  # n > candidates > distinct live ids
        ids = rng.integers(0, 4, size=40)
        live = rng.random(40) < 0.9
    elif kind == "n1":
        ids = rng.integers(0, 5, size=1)
        live = np.array([step != 2])
    elif kind == "int32_ends":  # ids at both ends of int32, and the pad
        ends = np.array([I32_MIN, I32_MIN + 1, I32_MIN + 2, -1, 0,
                         PAD - 2, PAD - 1, PAD])
        ids = np.concatenate([rng.choice(ends, 40),
                              rng.integers(I32_MIN, PAD, 20)])
        live = rng.random(ids.size) < 0.9
    else:  # "zipf19": Zipfian, ~19 positions a distinct live id
        ids = (rng.zipf(1.8, size=1500) - 1) % 10 ** 6
        live = rng.random(ids.size) < 0.95
    perm = rng.permutation(ids.size)
    return ids[perm].astype(np.int32), live[perm]


KINDS = ["ties", "short", "all_dead", "hot", "negative", "live_pad",
         "tie_boundary", "k_above", "n1", "int32_ends", "zipf19"]


@pytest.mark.parametrize("kind", KINDS)
def test_record_ids_matches_jax(kind, monkeypatch):
    """Five steps of one width's fold, every leaf bitwise after each; and
    each step's candidate pool (``topk_pool_plain`` on the updated
    sketch) bitwise JAX's, read where JAX passes it to ``jnp.unique``."""
    from distributed_embeddings_torch.ops import topk_pool_plain

    pools = []
    unique = jnp.unique

    def spy(x, *args, **kw):
        pools.append(np.asarray(x))
        return unique(x, *args, **kw)

    monkeypatch.setattr(jnp, "unique", spy)
    rng = np.random.default_rng(11)
    zeros = {"cms": np.zeros((CFG.depth, CFG.buckets), np.int32),
             "topk_ids": np.full(CFG.topk, -1, np.int32),
             "topk_est": np.zeros(CFG.topk, np.int32),
             "ids": np.zeros(1, np.float32)}
    jw = jax.tree.map(jnp.asarray, zeros)
    tw = telemetry_state_from_jax(zeros, device="cpu")
    pw = telemetry_state_from_jax(zeros, device="cpu")
    for step in range(5):
        ids, live = _stream(kind, rng, step)
        jw = jtel.record_ids(jw, jnp.asarray(ids), jnp.asarray(live), JCFG)
        out = tel.record_ids(tw, torch.from_numpy(ids),
                             torch.from_numpy(live), CFG)
        assert out is tw
        _assert_state_equal(tw, jw, f"{kind} step {step}: ")
        k_pool = min(CFG.candidates, ids.size)
        pool = topk_pool_plain(tw["cms"], torch.from_numpy(ids),
                               torch.from_numpy(live), k_pool)
        assert len(pools) == step + 1 and pools[-1].dtype == np.int32
        np.testing.assert_array_equal(pool.numpy(), pools[-1],
                                      err_msg=f"{kind} step {step} pool")
        # the three plain versions in a row, as one function
        record_ids_plain(pw, torch.from_numpy(ids), torch.from_numpy(live),
                         CFG.candidates)
        _assert_state_equal(pw, jw, f"{kind} step {step} (plain): ")
    if kind != "all_dead":
        assert (tw["topk_ids"] >= 0).sum() > 0


@pytest.mark.parametrize("topk,candidates", [(2048, 4 * 2048), (32, 16384)],
                         ids=["topk2048", "cand16384"])
def test_record_ids_at_sizes_past_the_tile_matches_jax(topk, candidates,
                                                       monkeypatch):
    """The sizes the card's shared memory does not hold (K14's pool
    past 8192, K15's merge past 8192 of topk + candidates), which the
    kernels run in device memory: ``topk`` 2048 with its default
    ``4 * topk`` candidates, and 16384 candidates. Three steps of a
    Zipfian stream over a uniform tail, with more distinct ids than
    candidates; every leaf and each step's pool bitwise JAX's."""
    from distributed_embeddings_torch.ops import topk_pool_plain

    pools = []
    unique = jnp.unique

    def spy(x, *args, **kw):
        pools.append(np.asarray(x))
        return unique(x, *args, **kw)

    monkeypatch.setattr(jnp, "unique", spy)
    cfg = tel.TelemetryConfig(depth=4, buckets=2048, topk=topk,
                              candidates=candidates)
    jcfg = jtel.TelemetryConfig(*cfg)
    rng = np.random.default_rng(23)
    zeros = {"cms": np.zeros((cfg.depth, cfg.buckets), np.int32),
             "topk_ids": np.full(topk, -1, np.int32),
             "topk_est": np.zeros(topk, np.int32),
             "ids": np.zeros(1, np.float32)}
    jw = jax.tree.map(jnp.asarray, zeros)
    tw = telemetry_state_from_jax(zeros, device="cpu")
    for step in range(3):
        ids = np.concatenate([(rng.zipf(1.3, size=30_000) - 1) % 10 ** 6,
                              rng.integers(0, 10 ** 6, size=40_000)])
        ids = rng.permutation(ids).astype(np.int32)
        live = rng.random(ids.size) < 0.95
        assert np.unique(ids[live]).size > candidates
        jw = jtel.record_ids(jw, jnp.asarray(ids), jnp.asarray(live), jcfg)
        tel.record_ids(tw, torch.from_numpy(ids), torch.from_numpy(live),
                       cfg)
        _assert_state_equal(tw, jw, f"step {step}: ")
        pool = topk_pool_plain(tw["cms"], torch.from_numpy(ids),
                               torch.from_numpy(live), candidates)
        np.testing.assert_array_equal(pool.numpy(), pools[-1],
                                      err_msg=f"step {step} pool")
    assert (tw["topk_ids"] >= 0).sum() == topk


# ---------------------------------------------- through the train step

#: tables of two widths: two width-8 groups (one-hot; multi-hot with a
#: combiner) and a width-16 group
D_CONFIGS = [{"input_dim": 50, "output_dim": 8},
             {"input_dim": 7, "output_dim": 8, "combiner": "sum"},
             {"input_dim": 33, "output_dim": 16}]
#: ragged tables of one width: a plain and a weighted feature ("r" and
#: "rw" groups)
R_CONFIGS = [{"input_dim": 40, "output_dim": 8, "combiner": "sum"},
             {"input_dim": 25, "output_dim": 8, "combiner": "mean"}]
R_CAP = 3 * B


def _configs(kind):
    return D_CONFIGS if kind == "d" else R_CONFIGS


def _bad(rng, ids, vocab):
    flip = rng.random(ids.shape) < 0.15
    return np.where(flip, np.where(rng.random(ids.shape) < 0.5,
                                   -rng.integers(1, 5, ids.shape),
                                   vocab + rng.integers(0, 5, ids.shape)),
                    ids).astype(np.int32)


def _batch(kind, rng, nan=False):
    """One step's inputs as numpy: per input ``ids`` (dense) or ``(values,
    splits, weights)`` (ragged), and the labels."""
    cats = []
    if kind == "d":
        cats = [_bad(rng, (rng.zipf(1.4, B) - 1) % 50, 50),
                _bad(rng, rng.integers(0, 7, (B, 3)), 7),
                _bad(rng, (rng.zipf(1.2, B) - 1) % 33, 33)]
    else:
        for t, cfg in enumerate(R_CONFIGS):
            hots = rng.integers(0, 5, B)
            # input 0 claims past its capacity (every position live),
            # input 1 leaves a dead tail
            hots[-1] = R_CAP // 2 if t == 0 else 0
            splits = np.zeros(B + 1, np.int32)
            np.cumsum(hots, out=splits[1:])
            vals = _bad(rng, (rng.zipf(1.3, R_CAP) - 1) % cfg["input_dim"],
                        cfg["input_dim"])
            w = (rng.uniform(0.5, 2, R_CAP).astype(np.float32) if t == 1
                 else None)
            cats.append((vals, splits, w))
    y = rng.normal(size=B).astype(np.float32)
    if nan:
        y[3] = np.nan
    return cats, y


def _jax_inputs(kind, cats):
    if kind == "d":
        return [jnp.asarray(c) for c in cats]
    return [JRagged(values=jnp.asarray(v), row_splits=jnp.asarray(s),
                    weights=None if w is None else jnp.asarray(w))
            for v, s, w in cats]


def _torch_inputs(kind, cats):
    if kind == "d":
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


class _Dense(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _tloss(m, outs, y):
    x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], dim=1)
    return torch.mean((x @ m.w)[:, 0] - y) ** 2


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    """The JAX layer, its jitted guarded step with telemetry, and the
    initial state as host arrays (the step donates its inputs)."""
    jde = JaxDE(_configs(kind), world_size=1)
    rng = np.random.default_rng(5)
    weights = [rng.normal(size=(c["input_dim"], c["output_dim"])
                          ).astype(np.float32) for c in _configs(kind)]
    params = jde.set_weights(weights)
    dp = {"w": jnp.asarray(rng.normal(size=(_width(kind), 1)), jnp.float32)}
    tx = optax.sgd(LR)
    state = JaxState(params, JaxSparseSGD().init(params), dp, tx.init(dp),
                     jnp.zeros((), jnp.int32))
    step = jax_train_step(jde, _jloss, tx, JaxSparseSGD(), lr_schedule=LR,
                          with_metrics=False, nan_guard=True, telemetry=JCFG)
    host = jax.tree.map(np.asarray, state)
    return jde, step, host, weights


def _models(kind):
    """Both packages' (layer, state, telemetry state) from one state, and
    the JAX step."""
    jde, jstep, host, weights = _jax_model(kind)
    jstate = jax.tree.map(jnp.asarray, host)
    jtelem = jtel.init_telemetry(jde, JCFG)
    tde = DistributedEmbedding(_configs(kind), world_size=1)
    params = tde.set_weights(weights, device="cpu")
    dense = _Dense(np.asarray(host.dense_params["w"]))
    tstate = HybridTrainState(params, SparseSGD().init(params), dense,
                              SGD(LR).init(list(dense.parameters())),
                              torch.zeros((), dtype=torch.int32))
    ttelem = tel.init_telemetry(tde, CFG, device="cpu")
    return (jde, jstate, jtelem, jstep), (tde, tstate, ttelem)


def _tstep(tde, **kw):
    return make_hybrid_train_step(tde, _tloss, SGD(LR), SparseSGD(),
                                  lr_schedule=LR, nan_guard=True, **kw)


@pytest.mark.parametrize("kind", ["d", "r"])
def test_update_telemetry_through_step_matches_jax(kind):
    """Three guarded steps with bad ids, then a NaN batch: after each,
    every telemetry leaf equals JAX's. The skipped step still folds its
    ids (as in JAX) and leaves the port's train state bitwise
    unchanged."""
    (jde, jstate, jtelem, jstep), (tde, tstate, ttelem) = _models(kind)
    tstep = _tstep(tde, telemetry=CFG)
    rng = np.random.default_rng(21)
    for step in range(4):
        nan = step == 3
        cats, y = _batch(kind, rng, nan=nan)
        before = [p.detach().clone() for p in tstate.emb_params.values()]
        loss, jstate, jtelem = jstep(jstate, _jax_inputs(kind, cats),
                                     jnp.asarray(y), jtelem)
        tloss, tstate, out = tstep(tstate, _torch_inputs(kind, cats),
                                   torch.from_numpy(y), ttelem)
        assert out is ttelem
        _assert_state_equal(ttelem, jtelem, f"step {step}: ")
        assert np.isfinite(float(tloss)) != nan
        if nan:
            for p, q in zip(tstate.emb_params.values(), before):
                assert torch.equal(p, q)
    assert int(ttelem["steps"][0, 0]) == 4
    assert float(ttelem["ids_total"][0, 0]) > 0
    assert sorted(k for k in ttelem if k.startswith("w")) == (
        ["w16", "w8"] if kind == "d" else ["w8"])


def test_telemetry_on_and_off_train_the_same_bitwise():
    """The train state with telemetry on equals the state with it off,
    bit for bit, over three steps (the port's twin of the JAX package's
    own test)."""
    runs = []
    for on in (False, True):
        _, (tde, tstate, ttelem) = _models("d")
        step = _tstep(tde, telemetry=CFG if on else None)
        rng = np.random.default_rng(4)
        for _ in range(3):
            cats, y = _batch("d", rng)
            args = (tstate, _torch_inputs("d", cats), torch.from_numpy(y))
            tstate = (step(*args, ttelem) if on else step(*args))[1]
        runs.append(tstate)
    a, b = runs
    for k in a.emb_params:
        assert torch.equal(a.emb_params[k], b.emb_params[k])
    for p, q in zip(a.dense_params.parameters(), b.dense_params.parameters()):
        assert torch.equal(p, q)
    assert int(a.step) == int(b.step) == 3


def test_train_loop_carries_one_telemetry_state():
    """``make_hybrid_train_loop`` over K stacked steps folds each step's
    ids into one telemetry state: equal to K JAX steps, bitwise."""
    K = 3
    (jde, jstate, jtelem, jstep), (tde, tstate, ttelem) = _models("d")
    rng = np.random.default_rng(9)
    batches = [_batch("d", rng) for _ in range(K)]
    for cats, y in batches:
        _, jstate, jtelem = jstep(jstate, _jax_inputs("d", cats),
                                  jnp.asarray(y), jtelem)
    loop = make_hybrid_train_loop(tde, _tloss, SGD(LR), SparseSGD(),
                                  lr_schedule=LR, nan_guard=True,
                                  telemetry=CFG)
    stacks = [torch.from_numpy(np.stack([b[0][t] for b in batches]))
              for t in range(len(D_CONFIGS))]
    losses, tstate, out = loop(tstate, stacks, torch.from_numpy(
        np.stack([b[1] for b in batches])), ttelem)
    assert losses.shape == (K,) and out is ttelem
    _assert_state_equal(ttelem, jtelem)


# ------------------------------------------------------------- host half


def _trained_states():
    """A telemetry state after a few steps, in both packages."""
    (jde, jstate, jtelem, jstep), (tde, tstate, ttelem) = _models("d")
    tstep = _tstep(tde, telemetry=CFG)
    rng = np.random.default_rng(33)
    for _ in range(3):
        cats, y = _batch("d", rng)
        _, jstate, jtelem = jstep(jstate, _jax_inputs("d", cats),
                                  jnp.asarray(y), jtelem)
        _, tstate, ttelem = tstep(tstate, _torch_inputs("d", cats),
                                  torch.from_numpy(y), ttelem)
    return jde, jtelem, tde, ttelem


def test_host_summaries_match_jax():
    jde, jtelem, tde, ttelem = _trained_states()
    assert tel.hot_rows(tde, ttelem) == jtel.hot_rows(jde, jtelem)
    assert tel.hot_rows(tde, ttelem, topk=2) == jtel.hot_rows(jde, jtelem,
                                                              topk=2)
    assert tel.load_balance(ttelem) == jtel.load_balance(jtelem)
    got = tel.summarize_telemetry(tde, ttelem)
    assert got == jtel.summarize_telemetry(jde, jtelem)
    assert got["tables"] and got["steps"] == 3
    assert tel.table_loads_from_summary(got, 3) == \
        jtel.table_loads_from_summary(got, 3)
    assert tel.zipf_alpha([9, 5, 3, 2]) == jtel.zipf_alpha([9, 5, 3, 2])


def test_npz_state_files_interchange(tmp_path):
    """A port save restores in JAX and a JAX save in the port; a drifted
    config restores the fresh state."""
    jde, jtelem, tde, ttelem = _trained_states()
    port_file, jax_file = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tel.save_telemetry_state(port_file, ttelem)
    jtel.save_telemetry_state(jax_file, jtelem)
    back = jtel.restore_telemetry_state(port_file,
                                        jtel.init_telemetry(jde, JCFG))
    _assert_state_equal(ttelem, back)
    got = tel.restore_telemetry_state(
        jax_file, tel.init_telemetry(tde, CFG, device="cpu"))
    _assert_state_equal(got, jtelem)
    fresh = tel.init_telemetry(tde, CFG._replace(topk=CFG.topk + 1),
                               device="cpu")
    assert tel.restore_telemetry_state(jax_file, fresh) is fresh


def test_resolve_config_and_init_device():
    assert tel.resolve_config(None) is None
    assert tel.resolve_config(False) is None
    assert tel.resolve_config(CFG) is CFG
    assert tel.resolve_config(True) == tel.config_from_env()
    assert tuple(tel.config_from_env()) == tuple(jtel.config_from_env())
    for bad in ("on", 1, {"depth": 4}):
        with pytest.raises(TypeError, match="TelemetryConfig"):
            tel.resolve_config(bad)
    tde = DistributedEmbedding(D_CONFIGS, world_size=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tel.init_telemetry(tde, CFG)
    st = tel.init_telemetry(tde, CFG, device="cpu")
    want = jax.tree.map(np.asarray, jtel.init_telemetry(
        JaxDE(D_CONFIGS, world_size=1), JCFG))
    _assert_state_equal(st, want)
    # streaming rides after telemetry: the step takes both states
    both = _tstep(tde, telemetry=CFG, dynamic=True)
    assert list(inspect.signature(both).parameters) == [
        "state", "cat_inputs", "batch", "telem", "stream"]


def test_sketch_wrappers_run_plain_on_the_cpu_and_refuse_other_devices():
    """CPU tensors take the plain versions (no launch counted); a tensor
    on another device raises rather than falling back."""
    from distributed_embeddings_torch.ops import sketch as sk

    cms = torch.zeros((2, 5), dtype=torch.int32)
    ids = torch.tensor([1, 2, 2, 9], dtype=torch.int32)
    live = torch.tensor([True, True, True, False])
    counts0 = [f.launches for f in (sk.cms_update, sk.cms_query,
                                    sk.topk_pool, sk.topk_merge)]
    counts = sk.cms_update(cms, ids, live)
    pool = sk.topk_pool(cms, ids, live, 4)
    tids = torch.full((2,), -1, dtype=torch.int32)
    test = torch.zeros(2, dtype=torch.int32)
    acc = torch.zeros(1)
    assert float(sk.topk_merge(cms, pool, counts, tids, test, acc, 4)) == 3
    assert tids.tolist() == [2, 1] and test.tolist() == [2, 1]
    assert sk.cms_query(cms, ids).tolist() == [1, 2, 2, 0]
    assert [f.launches for f in (sk.cms_update, sk.cms_query, sk.topk_pool,
                                 sk.topk_merge)] == counts0
    meta = torch.empty((2, 5), dtype=torch.int32, device="meta")
    for call in (lambda: sk.cms_update(meta, ids, live),
                 lambda: sk.cms_query(meta, ids),
                 lambda: sk.topk_pool(meta, ids, live, 2),
                 lambda: sk.topk_merge(meta, pool, counts, tids, test, acc,
                                       4)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
