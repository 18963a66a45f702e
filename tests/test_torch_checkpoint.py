"""The port's full train-state checkpoint codec (``utils/checkpoint.py``,
``utils/msgpack_state.py``) against itself and against the JAX
package's ``utils/checkpoint.py``, on a small DLRM (10 tables, width 8).

What is held, with its tolerance:
  - port save -> port restore: every tensor of the state bitwise, the
    dtypes as saved (bf16 tables over fp32 accumulators kept), and a
    resumed trajectory bitwise equal to an uninterrupted one (SparseSGD
    under a schedule, SparseAdagrad, SparseAdam with its counts);
  - the files themselves: a bf16 table file byte-identical to the JAX
    package's ``np.save`` of the same table, ``dense.msgpack`` byte-
    identical to flax's ``to_bytes`` of the same state, each decoding
    with the other package's reader;
  - JAX save -> port restore and port save -> JAX ``restore_train_state``:
    the restored state bitwise, then the same steps in both packages
    within the train-step tolerance (float32: atol 1e-5, the MLP
    summation order; the first steps of ``tests/test_torch_train_step``);
  - a JAX checkpoint from the 8-device CPU mesh restores at world 1 under
    ``on_mismatch="reshard"`` (tables bitwise, Adam counts from their
    consensus) and is refused under ``"error"``;
  - the fault cases of ``tests/test_checkpoint_atomic.py`` and
    ``tests/test_train_state_checkpoint.py``: CRC, torn files, the
    ``.prev`` fallback, ``die:checkpoint_write``, ``corrupt@ckpt``, the
    ring, ``CheckpointMismatch``.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.sharding import Mesh

from distributed_embeddings_tpu.models.dlrm import (
    DLRMConfig as JaxConfig, DLRMDense as JaxDense,
    bce_with_logits as jax_bce)
from distributed_embeddings_tpu.models.schedules import (
    warmup_poly_decay_schedule as jax_schedule)
from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDE, HybridTrainState as JaxState)
from distributed_embeddings_tpu.parallel.optimizers import (
    SparseAdam as JaxSparseAdam, SparseSGD as JaxSparseSGD)
from distributed_embeddings_tpu.parallel.trainer import (
    init_hybrid_state as jax_init_state,
    make_hybrid_train_step as jax_train_step)
from distributed_embeddings_tpu.utils import checkpoint as jax_ckpt

from distributed_embeddings_torch.models import (DLRMConfig, DLRMDense,
                                                 bce_with_logits)
from distributed_embeddings_torch.models.schedules import (
    warmup_poly_decay_schedule)
from distributed_embeddings_torch.parallel import (
    SGD, Adagrad, Adam, DistributedEmbedding, SparseAdagrad, SparseAdam,
    SparseSGD, StreamingConfig, init_hybrid_state, init_streaming,
    make_hybrid_train_step)
from distributed_embeddings_torch.parallel import streaming as smod
from distributed_embeddings_torch.utils import checkpoint as ckpt
from distributed_embeddings_torch.utils import msgpack_state, obs, runtime
from distributed_embeddings_torch.utils.convert import hybrid_state_from_jax

from torch_parity import to_np

torch.set_num_threads(1)

SIZES = [50, 37, 64, 29, 50, 41, 23, 58, 33, 45]  # >= 8: the mesh test
DIM, NUM, B = 8, 4, 64
KW = dict(table_sizes=SIZES, embedding_dim=DIM, num_numerical_features=NUM,
          bottom_mlp_dims=(16, DIM), top_mlp_dims=(16, 1))
SCHED = (2.0, 4, 8, 6)  # base lr, warmup, decay start, decay steps


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cats = [rng.integers(0, s, size=(B,)).astype(np.int32)
                for s in SIZES]
        num = rng.normal(size=(B, NUM)).astype(np.float32)
        lab = (rng.random((B, 1)) < 0.3).astype(np.float32)
        out.append((cats, num, lab))
    return out


BATCHES = _batches(6)


# ------------------------------------------------------------ the port


def _port_opt(name):
    """(sparse optimizer, dense optimizer, sparse lr) of the port."""
    if name == "sgd":
        sched = warmup_poly_decay_schedule(*SCHED)
        return SparseSGD(), SGD(sched), sched
    if name == "adagrad":
        return SparseAdagrad(), Adagrad(0.1), 0.05
    return SparseAdam(), Adam(1e-3), 0.01


def _port(name, dtype=torch.float32, seed=0):
    """The port's (layer, dense module, state, step) at world 1."""
    cfg = DLRMConfig(**KW)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    emb_opt, tx, lr = _port_opt(name)
    gen = torch.Generator().manual_seed(seed)
    dense = DLRMDense(cfg, device="cpu", generator=gen)
    state = init_hybrid_state(de, emb_opt, dense, tx, generator=gen,
                              dtype=dtype, device="cpu")

    def loss(m, outs, batch):
        n, y = batch
        return bce_with_logits(m(n, outs), y)

    step = make_hybrid_train_step(de, loss, tx, emb_opt, lr_schedule=lr)
    return de, dense, state, step


def _run(step, state, batches):
    losses = []
    for cats, num, lab in batches:
        loss, state = step(state, [torch.from_numpy(c) for c in cats],
                           (torch.from_numpy(num), torch.from_numpy(lab)))
        losses.append(float(loss))
    return losses, state


def _flat(state, de):
    """Every tensor of a port state, host copies, in a fixed order: the
    slab-shaped leaves as their logical tables (a checkpoint holds no
    rows between or after the tables)."""
    n = len(de.strategy.global_configs)
    out = [("step", state.step)]
    out += [(f"emb/{t}", de._table_tensor(state.emb_params, t))
            for t in range(n)]
    opt = state.emb_opt_state
    leaves = next(iter(opt.values()))
    comps = ([opt] if isinstance(leaves, torch.Tensor) else
             [{k: v[i] for k, v in opt.items()} for i in range(len(leaves))])
    for i, comp in enumerate(comps):
        if all(v.shape == state.emb_params[k].shape
               for k, v in comp.items()):
            out += [(f"opt{i}/{t}", de._table_tensor(comp, t))
                    for t in range(n)]
        else:
            out += [(f"opt{i}/{k}", v) for k, v in sorted(comp.items())]
    out += [(f"dense/{i}", p) for i, p in
            enumerate(state.dense_params.parameters())]
    leaves = torch.utils._pytree.tree_leaves(state.dense_opt_state)
    out += [(f"dense_opt/{i}", t) for i, t in enumerate(leaves)]
    return [(n, t.detach().cpu().clone()) for n, t in out]


def assert_states_bitwise(a, b, de):
    fa, fb = _flat(a, de), _flat(b, de)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), n


def _fresh_dense(seed=9):
    return DLRMDense(DLRMConfig(**KW), device="cpu",
                     generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name,dtype", [
    ("sgd", torch.float32), ("sgd", torch.bfloat16),
    ("adagrad", torch.float32), ("adam", torch.float32)])
def test_port_roundtrip_resumes_bitwise(tmp_path, name, dtype):
    """3 steps, save, restore into a fresh layer and module, 3 more:
    bitwise equal to 6 uninterrupted steps, and the restored state is
    the saved one bit for bit."""
    de, _, ref, step = _port(name, dtype)
    ref_losses, ref = _run(step, ref, BATCHES)
    de, _, st, step = _port(name, dtype)
    losses, st = _run(step, st, BATCHES[:3])
    saved = _flat(st, de)
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    de2, dense2, _, step2 = _port(name, dtype, seed=4)
    emb_opt, tx, _ = _port_opt(name)
    st2 = ckpt.restore_train_state(path, de2, emb_opt, dense2, tx,
                                   device="cpu")
    assert st2.dense_params is dense2
    assert [n for n, _ in _flat(st2, de2)] == [n for n, _ in saved]
    for (n, x), (_, y) in zip(_flat(st2, de2), saved):
        assert x.dtype == y.dtype and torch.equal(x.float(), y.float()), n
    more, st2 = _run(step2, st2, BATCHES[3:])
    assert losses + more == ref_losses
    assert_states_bitwise(st2, ref, de)
    meta = ckpt.verify_checkpoint(path)
    assert meta["step"] == 3 and meta["num_tables"] == len(SIZES)
    assert meta["dtypes"]["tables"] == str(dtype)[6:]


def test_mixed_dtypes_kept_and_overridden(tmp_path):
    """bf16 tables over fp32 Adagrad accumulators restore with the same
    mixed dtypes; an explicit per-component dtype wins."""
    de, dense, st, _ = _port("adagrad")
    st = st._replace(emb_params={k: v.to(torch.bfloat16)
                                 for k, v in st.emb_params.items()})
    path = str(tmp_path / "mixed")
    ckpt.save_train_state(path, de, st)
    emb_opt, tx, _ = _port_opt("adagrad")
    st2 = ckpt.restore_train_state(path, de, emb_opt, _fresh_dense(), tx,
                                   device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in st2.emb_params.values())
    assert all(v.dtype == torch.float32
               for v in st2.emb_opt_state.values())
    st3 = ckpt.restore_train_state(path, de, emb_opt, _fresh_dense(), tx,
                                   device="cpu",
                                   dtype={"tables": torch.float32})
    assert all(v.dtype == torch.float32 for v in st3.emb_params.values())
    for k in st.emb_params:
        assert torch.equal(st3.emb_params[k], st.emb_params[k].float())


def test_streaming_aux_state_rides_the_checkpoint(tmp_path):
    """A streaming state saved through ``aux_states`` (``encode_state``)
    comes back bitwise through ``load_aux_state`` + ``decode_state``."""
    cfgs = [{"input_dim": 40 + 8, "output_dim": 8,
             "streaming": {"capacity": 40, "buckets": 8}},
            {"input_dim": 30, "output_dim": 8}]
    de = DistributedEmbedding(cfgs, world_size=1)
    scfg = StreamingConfig(buckets=64)
    ss = init_streaming(de, scfg, device="cpu")
    rng = np.random.default_rng(1)
    for k, v in ss.items():
        if isinstance(v, dict):
            for name, t in v.items():
                t.copy_(torch.from_numpy(rng.integers(
                    0, 50, size=tuple(t.shape))).to(t.dtype))
    dense = _fresh_dense()
    st = init_hybrid_state(de, SparseSGD(), dense, SGD(0.1), device="cpu")
    path = str(tmp_path / "stream")
    ckpt.save_train_state(path, de, st,
                          aux_states={"streaming": smod.encode_state(de,
                                                                     ss)})
    assert ckpt.verify_checkpoint(path)["aux_states"] == ["streaming"]
    loaded = ckpt.load_aux_state(path, "streaming")
    want = smod.encode_state(de, ss)
    assert sorted(loaded) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k])
    back = smod.decode_state(de, init_streaming(de, scfg, device="cpu"),
                             loaded)
    got = smod.encode_state(de, back)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert ckpt.load_aux_state(path, "telemetry") is None


# ------------------------------------------------------- the JAX package


@functools.lru_cache(maxsize=None)
def _jax_parts(name, world=1):
    """JAX (layer, dense module, sparse opt, optax tx, step, mesh)."""
    cfg = JaxConfig(**KW)
    jde = JaxDE(cfg.embedding_configs(), world_size=world,
                strategy="memory_balanced" if world > 1 else "basic")
    jdense = JaxDense(cfg)
    if name == "sgd":
        sched = jax_schedule(*SCHED)
        emb_opt, tx, lr = JaxSparseSGD(), optax.sgd(sched), sched
    else:
        emb_opt, tx, lr = JaxSparseAdam(), optax.adam(1e-3), 0.01
    mesh = (Mesh(np.array(jax.devices()[:world]), ("data",))
            if world > 1 else None)

    def loss(p, outs, batch):
        n, y = batch
        return jax_bce(jdense.apply(p, n, outs), y)

    step = (jax_train_step(jde, loss, tx, emb_opt, lr_schedule=lr,
                           with_metrics=False, telemetry=False)
            if world == 1 else None)
    return jde, jdense, emb_opt, tx, step, mesh


def _jax_state(name, dtype=jnp.float32, world=1):
    jde, jdense, emb_opt, tx, _, mesh = _jax_parts(name, world)
    dp = jdense.init(jax.random.key(1), jnp.zeros((2, NUM)),
                     [jnp.zeros((2, DIM))] * len(SIZES))
    st = jax_init_state(jde, emb_opt, dp, tx, jax.random.key(2), mesh=mesh,
                        dtype=dtype)
    return st._replace(dense_params=jax.tree.map(lambda a: a + 0,
                                                 st.dense_params))


def _jax_run(name, st, batches):
    step = _jax_parts(name)[4]
    losses = []
    for cats, num, lab in batches:
        loss, st = step(st, [jnp.asarray(c) for c in cats],
                        (jnp.asarray(num), jnp.asarray(lab)))
        losses.append(float(loss))
    return losses, st


def _compare(jde, jst, tde, tst, atol):
    for t, (w, g) in enumerate(zip(jde.get_weights(jst.emb_params),
                                   tde.get_weights(tst.emb_params))):
        np.testing.assert_allclose(g, to_np(w), atol=atol, rtol=0,
                                   err_msg=f"table {t}")
    tree = jst.dense_params["params"]
    for i, lin in enumerate(tst.dense_params.linears()):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(tree[f"Dense_{i}"]["kernel"]).T,
                                   atol=atol, rtol=0)
    assert int(tst.step) == int(jst.step)


@pytest.mark.parametrize("name,dtype", [("sgd", "float32"),
                                        ("sgd", "bfloat16"),
                                        ("adam", "float32")])
def test_jax_save_port_restore(tmp_path, name, dtype):
    """JAX trains 2 steps and saves; the port restores it (every array
    bitwise equal to JAX's state), then both take the same 3 steps."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jde, _, emb_opt, tx, _, _ = _jax_parts(name)
    _, jst = _jax_run(name, _jax_state(name, jdt), BATCHES[:2])
    path = str(tmp_path / "jax_ck")
    jax_ckpt.save_train_state(path, jde, jst)
    host = jax.tree.map(np.asarray, jst)
    tde, dense, _, tstep = _port(name, getattr(torch, dtype))
    temb, ttx, _ = _port_opt(name)
    tst = ckpt.restore_train_state(path, tde, temb, dense, ttx,
                                   device="cpu")
    # the restored state is JAX's, bit for bit (carried over the
    # in-memory converter for the comparison)
    want = hybrid_state_from_jax(
        tde, _fresh_dense(), jde.get_weights(host.emb_params),
        host.dense_params, host.step, emb_opt_state=host.emb_opt_state,
        dense_opt_state=host.dense_opt_state, dtype=getattr(torch, dtype),
        device="cpu", emb_optimizer=temb, dense_tx=ttx)
    assert_states_bitwise(tst, want, tde)
    jl, jst = _jax_run(name, jst, BATCHES[2:5])
    tl, tst = _run(tstep, tst, BATCHES[2:5])
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        _compare(jde, jst, tde, tst, 1e-5)
    else:  # bf16 tables: a few bf16 ulps of the table scale
        np.testing.assert_allclose(tl, jl, atol=2e-3, rtol=0)
        _compare(jde, jst, tde, tst, 8 * 2.0 ** -7 * 0.2)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_port_save_jax_restore(tmp_path, name):
    """The port trains 2 steps and saves; JAX's ``restore_train_state``
    loads it (tables, optimizer state, dense tree and step equal to the
    port's), then both take the same 3 steps."""
    tde, _, tst, tstep = _port(name)
    _, tst = _run(tstep, tst, BATCHES[:2])
    path = str(tmp_path / "port_ck")
    ckpt.save_train_state(path, tde, tst)
    jde, jdense, emb_opt, tx, _, _ = _jax_parts(name)
    template = _jax_state(name)
    jst = jax_ckpt.restore_train_state(path, jde, emb_opt,
                                       template.dense_params, tx)
    assert int(jst.step) == 2
    for w, g in zip(jde.get_weights(jst.emb_params),
                    tde.get_weights(tst.emb_params)):
        np.testing.assert_array_equal(to_np(w), g)
    _compare(jde, jst, tde, tst, 0.0)
    jl, jst = _jax_run(name, jst, BATCHES[2:5])
    tl, tst = _run(tstep, tst, BATCHES[2:5])
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _compare(jde, jst, tde, tst, 1e-5)


def test_table_file_and_dense_msgpack_bytes_match_jax(tmp_path):
    """The port's bf16 table file is byte-identical to JAX's ``np.save``
    of the same table (``'<V2'``), and ``dense.msgpack`` to flax's
    ``to_bytes`` of the same dense state; each decodes with the other
    package's reader."""
    jde, _, _, tx, _, _ = _jax_parts("sgd")
    jst = _jax_state("sgd", jnp.bfloat16)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jax_ckpt.save_train_state(jpath, jde, jst)
    tde, dense, _, _ = _port("sgd", torch.bfloat16)
    temb, ttx, _ = _port_opt("sgd")
    tst = ckpt.restore_train_state(jpath, tde, temb, dense, ttx,
                                   device="cpu")
    ckpt.save_train_state(tpath, tde, tst)
    for rel in ["tables/table_000.npy", "tables/table_003.npy",
                "dense.msgpack"]:
        with open(os.path.join(jpath, rel), "rb") as a, \
                open(os.path.join(tpath, rel), "rb") as b:
            assert a.read() == b.read(), rel
    jmeta, tmeta = (json.load(open(os.path.join(p, "meta.json")))
                    for p in (jpath, tpath))
    assert jmeta["files"] == tmeta["files"]
    assert {k: v for k, v in jmeta.items() if k != "files"} == \
        {k: v for k, v in tmeta.items() if k != "files"}
    with open(os.path.join(tpath, "dense.msgpack"), "rb") as f:
        raw = f.read()
    flax_tree = serialization.msgpack_restore(raw)
    ours = msgpack_state.unpackb(raw)
    assert jax.tree.structure(flax_tree) == jax.tree.structure(
        jax.tree.map(np.asarray, ours))
    for a, b in zip(jax.tree.leaves(flax_tree), jax.tree.leaves(ours)):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))


def test_jax_mesh8_checkpoint_reshards_at_world_1(tmp_path):
    """A JAX checkpoint of the 8-device CPU mesh (memory_balanced plan,
    SparseAdam with per-rank counts): refused under
    ``on_mismatch="error"``; under ``"reshard"`` the tables restore
    bitwise, the counts from their consensus, and the event is
    recorded."""
    jde, _, emb_opt, tx, _, mesh = _jax_parts("adam", world=8)
    jst = _jax_state("adam", world=8)
    rng = np.random.default_rng(3)
    tables = [rng.normal(size=(s, DIM)).astype(np.float32) for s in SIZES]
    jst = jst._replace(
        emb_params=jde.set_weights(tables, mesh=mesh),
        emb_opt_state={k: (mu, nu, jnp.full_like(c, 3.0))
                       for k, (mu, nu, c) in jst.emb_opt_state.items()})
    path = str(tmp_path / "mesh8")
    jax_ckpt.save_train_state(path, jde, jst)
    tde, dense, _, _ = _port("adam")
    temb, ttx, _ = _port_opt("adam")
    with pytest.raises(runtime.CheckpointMismatch, match="sharding plan"):
        ckpt.restore_train_state(path, tde, temb, dense, ttx, device="cpu")
    obs.drain_events()
    tst = ckpt.restore_train_state(path, tde, temb, dense, ttx,
                                   device="cpu", on_mismatch="reshard")
    for want, got in zip(tables, tde.get_weights(tst.emb_params)):
        np.testing.assert_array_equal(got, want)
    for k, (_, _, count) in tst.emb_opt_state.items():
        assert count.shape == (1, 1, 1) and float(count) == 3.0
    ev = obs.drain_events("checkpoint_reshard")
    assert len(ev) == 1 and ev[0]["diff"]["world_size"] == [8, 1]


# ------------------------------------------------------------ faults


def _small_state():
    de, dense, st, _ = _port("sgd")
    return de, st


def _restore(path, de, **kw):
    emb_opt, tx, _ = _port_opt("sgd")
    return ckpt.restore_train_state(path, de, emb_opt, _fresh_dense(), tx,
                                    device="cpu", **kw)


def test_crc_torn_file_and_prev_fallback(tmp_path):
    """Two saves leave the first at ``.prev``; a flipped byte or a torn
    file in the newest fails its CRC and restore falls back to ``.prev``
    (recording the event), or raises with ``fallback=False``."""
    de, st = _small_state()
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    first = _flat(st, de)
    st = st._replace(step=st.step + 5)
    ckpt.save_train_state(path, de, st)
    assert os.path.isdir(ckpt.previous_checkpoint_path(path))
    assert [s for s, _ in ckpt.rollback_candidates(path)] == [5, 0]
    fp = os.path.join(path, "tables", "table_002.npy")
    with open(fp, "r+b") as f:
        f.truncate(os.path.getsize(fp) - 7)  # torn
    with pytest.raises(runtime.CheckpointCorrupt, match="CRC mismatch"):
        ckpt.verify_checkpoint(path)
    with pytest.raises(runtime.CheckpointCorrupt):
        _restore(path, de, fallback=False)
    obs.drain_events()
    back = _restore(path, de)
    assert int(back.step) == 0
    for (n, a), (_, b) in zip(_flat(back, de), first):
        assert torch.equal(a, b), n
    assert len(obs.drain_events("checkpoint_prev_fallback")) == 1
    os.remove(os.path.join(path, "meta.json"))
    with pytest.raises(runtime.CheckpointCorrupt, match="missing meta"):
        ckpt.verify_checkpoint(path)


def test_corrupt_ckpt_fault_is_caught(tmp_path, monkeypatch):
    de, st = _small_state()
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    monkeypatch.setenv("DETPU_FAULT", "corrupt@ckpt")
    ckpt.save_train_state(path, de, st._replace(step=st.step + 1))
    monkeypatch.delenv("DETPU_FAULT")
    with pytest.raises(runtime.CheckpointCorrupt, match="table_000"):
        ckpt.verify_checkpoint(path)
    assert int(_restore(path, de).step) == 0  # the .prev generation


def test_die_during_checkpoint_write_leaves_old_checkpoint(tmp_path):
    """``DETPU_FAULT=die:checkpoint_write`` kills a child mid-save (exit
    17): the old checkpoint stays whole and restorable, only a staging
    directory is left, and the next save replaces it."""
    de, st = _small_state()
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    code = (
        "import sys, torch; sys.path[:0] = [{root!r}, {tests!r}];"
        "import test_torch_checkpoint as t;"
        "from distributed_embeddings_torch.utils import checkpoint as c;"
        "de, st = t._small_state();"
        "c.save_train_state({path!r}, de, st._replace(step=st.step + 9))"
    ).format(root=os.path.dirname(os.path.dirname(__file__)),
             tests=os.path.dirname(__file__), path=path)
    env = dict(os.environ, DETPU_FAULT="die:checkpoint_write",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 17, r.stderr.decode()[-2000:]
    assert os.path.isdir(path + ".staging")
    assert int(ckpt.verify_checkpoint(path)["step"]) == 0
    assert int(_restore(path, de).step) == 0
    ckpt.save_train_state(path, de, st._replace(step=st.step + 2))
    assert not os.path.isdir(path + ".staging")
    assert int(_restore(path, de).step) == 2


def test_raise_fault_on_checkpoint_read(tmp_path, monkeypatch):
    """``DETPU_FAULT=raise:checkpoint_read:1`` fails the first restore
    with ``FaultInjected`` (counted) and lets the next one through."""
    de, st = _small_state()
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    runtime.reset_fault_counts()
    monkeypatch.setenv("DETPU_FAULT", "raise:checkpoint_read:1")
    before = obs.counters().get("fault_injections.checkpoint_read", 0)
    with pytest.raises(runtime.FaultInjected, match="checkpoint_read"):
        _restore(path, de)
    assert int(_restore(path, de).step) == 0
    assert obs.counters()["fault_injections.checkpoint_read"] == before + 1
    runtime.reset_fault_counts()


def test_ring_keeps_the_newest_generations(tmp_path):
    de, st = _small_state()
    path = str(tmp_path / "ck")
    for s in range(5):
        ckpt.save_train_state(path, de, st._replace(step=st.step + s),
                              keep_last_n=2)
    assert [s for s, _ in ckpt.ring_entries(path)] == [2, 1]
    assert [s for s, _ in ckpt.rollback_candidates(path)] == [4, 3, 2, 1]
    ckpt.prune_ring(path, 1)
    assert [s for s, _ in ckpt.ring_entries(path)] == [2]


def test_mismatched_model_is_refused(tmp_path):
    """A checkpoint of other table shapes or another table count raises
    ``CheckpointMismatch`` before any data streams."""
    de, st = _small_state()
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, de, st)
    emb_opt, tx, _ = _port_opt("sgd")
    for sizes in (SIZES[:-1] + [46], SIZES[:5]):
        cfg = DLRMConfig(**dict(KW, table_sizes=sizes))
        other = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
        with pytest.raises(runtime.CheckpointMismatch):
            ckpt.restore_train_state(path, other, emb_opt,
                                     DLRMDense(cfg, device="cpu"), tx,
                                     device="cpu")
    with pytest.raises(ValueError, match="on_mismatch"):
        ckpt.restore_train_state(path, de, emb_opt, _fresh_dense(), tx,
                                 device="cpu", on_mismatch="ignore")


def test_set_weights_src_dtype_and_lock(tmp_path):
    """``.npy`` sources saved as bf16 load as ``|V2`` and need
    ``src_dtype``; ``use_lock`` builds the same slabs."""
    de, st = _small_state()
    bf = {k: v.to(torch.bfloat16) for k, v in st.emb_params.items()}
    paths = []
    for t in range(len(SIZES)):
        p = str(tmp_path / f"t{t}.npy")
        with open(p, "wb") as f:
            ckpt.save_npy(f, de._table_tensor(bf, t))
        paths.append(p)
    assert np.load(paths[0]).dtype.str == "|V2"
    with pytest.raises(ValueError, match="src_dtype"):
        de.set_weights(paths, dtype=torch.bfloat16, device="cpu")
    a = de.set_weights(paths, dtype=torch.bfloat16, device="cpu",
                       src_dtype="bfloat16")
    b = de.set_weights(paths, dtype=torch.bfloat16, device="cpu",
                       src_dtype=torch.bfloat16, use_lock=True,
                       chunk_elems=64)
    for k in bf:
        assert torch.equal(a[k], bf[k]) and torch.equal(b[k], bf[k])
    assert [t.shape for t in de.get_weights(bf, chunk_elems=16)] == \
        [(s, DIM) for s in SIZES]
